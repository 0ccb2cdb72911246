"""Strategy simulator: analytic cost model + candidate search + calibration.

The counterpart of ``autodist_tpu/simulator``; it prices candidate
strategies before running any of them:

- :mod:`cost_model` — α-β collective pricing per variable (ring
  AllReduce, ZeRO reduce-scatter+all-gather, partitioned AR, the
  two-level schedules) from tensor bytes, compressor wire dtype, the
  bucket layout the execution plan would emit
  (``parallel.plan.static_collective_schedule``), and the link hints in
  :class:`ResourceSpec`'s topology; plus a per-device memory footprint
  estimate (params, grads, optimizer state, bucket staging).
- :mod:`search` — candidate enumeration over the strategy builders (and
  their chunk_size / partition knobs) with memory-budget pruning,
  returning ranked ``(Strategy, predicted_step_time, peak_bytes)``; and
  the schedule-IR synthesis over 2- and 3-tier topologies.
- :mod:`calibrate` — optional measured mode refining the α-β constants
  from a ``profiling.collective_timeline`` of a short real run (a
  ``torch.profiler`` trace) or a roofline drift table.

The user-facing entry points are ``strategy.builders.AutoStrategy`` (the
tenth builder — calls the simulator inside ``build()``) and
``python -m autodist_tpu_torch.simulator`` (prints the ranked table
without running anything).
"""
from autodist_tpu_torch.simulator.cost_model import (  # noqa: F401
    CostModelParams, CostReport, collective_time, memory_footprint,
    predict, wire_bytes)
from autodist_tpu_torch.simulator.search import (  # noqa: F401
    Candidate, default_candidates, rank)
from autodist_tpu_torch.simulator.calibrate import (  # noqa: F401
    calibrate_from_timeline, calibrate_from_trace, fit_alpha_beta,
    samples_from_timeline)
