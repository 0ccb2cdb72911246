"""Telemetry of the port: the span/counter registry (a copy of the JAX
package's ``telemetry/core.py``), which the execution plan records its
emitted buckets through, the crash flight recorder
(:mod:`autodist_tpu_torch.telemetry.flight`: the bounded ring of
control-plane events the membership, replan and swap code records to),
and the roofline observatory (:mod:`autodist_tpu_torch.telemetry.
roofline`: MFU, memory drift and the per-entry collective drift table)."""
