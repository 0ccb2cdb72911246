"""Static analysis over the distributed runtime: correctness backstops
that run with no devices and no processes (a counterpart of
``autodist_tpu/analysis``, pure Python, importing neither jax nor the JAX
package). Every check reads the port's own sources and records.

Seven analyzers and the trace replay, one CLI
(``python -m autodist_tpu_torch.analysis``):

- :mod:`~autodist_tpu_torch.analysis.protocol_model` +
  :mod:`~autodist_tpu_torch.analysis.explore`: an executable small-scope
  model of the control-plane protocol (fence generations, the exclude
  path, the admit handshake, publish/MINWAIT gate semantics) explored
  exhaustively over bounded interleavings with crashes. The two
  costliest historical bugs (the deleted-step-key resurrection, the
  admit-ordering inversion) re-derive as counterexample traces when
  the model is flipped to the old orderings; HEAD's orderings explore
  clean.
- :mod:`~autodist_tpu_torch.analysis.data_plane_model`: the same
  treatment for the PS **data plane**: chunked write sequences +
  torn-read version parity, the disconnect-time sequence abort, the
  under-tensor-lock fence re-check, the depth-2 pipeline's bounded
  prefetch wait and peer-floor guard, and the telemetry
  batch-counter/cursor protocol.
- :mod:`~autodist_tpu_torch.analysis.epoch_swap_model`: the
  strategy-distribution-epoch handshake (stage -> ack-quorum ->
  boundary-arm -> swap-at-boundary), with the re-key's copy modelled:
  the port's chief re-keys only once every live member published the
  step before the boundary (``LooseSession._await_published``); the
  tempting-but-wrong orderings counterexample.
- :mod:`~autodist_tpu_torch.analysis.conformance` and
  :mod:`~autodist_tpu_torch.analysis.swap_conformance`: the dynamic
  twins, replaying the flight recorder's event traces
  (:mod:`~autodist_tpu_torch.telemetry.flight`) through the models'
  invariants.
- :mod:`~autodist_tpu_torch.analysis.fence_lint`: parses the port's
  native ``coord_service.cc`` dispatcher and proves every mutating
  command is fence-checked (with the under-tensor-lock re-check for
  ``B*`` commands), every size-declaring command bounds its declared
  allocation against ``kMaxPayload`` before allocating, the header
  stays in sync, and the read-only client and the swap key schema
  speak classified verbs only.
- :mod:`~autodist_tpu_torch.analysis.env_lint`: every ``AUTODIST_*``
  env read in the port's tree must be declared in ``const.py``'s ENV
  registry, every worker-affecting knob must ride the coordinator's
  forwarding set (or carry an explicit exemption reason), and every
  knob must be documented under ``docs/`` with choice sets in sync.
- :mod:`~autodist_tpu_torch.analysis.schedule_lint`: cross-checks
  ``plan.sync_gradients``'s emission predicates against
  ``static_collective_schedule`` at the AST level, verifies the
  schedule IR and ``reshard.plan_reshard`` layout moves by shape
  algebra, and checks the wire-pricing table against the compressor
  registry.

Every analyzer returns a list of finding strings (empty = clean) so
``python -m autodist_tpu_torch.analysis --all`` can aggregate them into
one exit code and an optional ``--json`` report. Design notes and the
extension contract: ``docs/design/static-analysis.md``.
"""
