"""Telemetry of the port (the counterpart of ``autodist_tpu/telemetry``):

- :mod:`~autodist_tpu_torch.telemetry.core`: the span/counter registry
  (``AUTODIST_TELEMETRY`` gates it; disabled = zero-cost no-ops), which
  the execution plan and the loose session record through;
- :mod:`~autodist_tpu_torch.telemetry.aggregate`: workers batch-push
  span records to a ``telemetry/`` namespace over the PS tensor wire
  (the JAX package's wire bytes); the chief assembles the cohort
  timeline and exports Chrome ``trace_event`` JSON;
- :mod:`~autodist_tpu_torch.telemetry.flight`: the bounded ring of
  control-plane events the membership, replan and swap code records to,
  dumped on failure triggers;
- :mod:`~autodist_tpu_torch.telemetry.monitor`: the chief's online
  sentry over the span batches: straggler verdicts with phase
  attribution, ``slowdown``/``recovered`` flight events, the autoscale
  step-time signal and the live refit of the cost model's link
  constants;
- :mod:`~autodist_tpu_torch.telemetry.roofline`: MFU, memory drift and
  the per-entry collective drift table.
"""
from autodist_tpu_torch.telemetry.aggregate import (chrome_trace,
                                                    collect_new_records,
                                                    collect_records,
                                                    decode_records,
                                                    encode_records,
                                                    push_records,
                                                    step_timeline)
from autodist_tpu_torch.telemetry.core import Telemetry, get, reset
from autodist_tpu_torch.telemetry.flight import (FlightRecorder, load_dump,
                                                 recorder, telemetry_dir)
from autodist_tpu_torch.telemetry.flight import reset as reset_recorder
from autodist_tpu_torch.telemetry.monitor import (CohortMonitor,
                                                  format_snapshot,
                                                  phase_medians,
                                                  phase_splits)
from autodist_tpu_torch.telemetry.roofline import (RooflineTracker,
                                                   classify_regime, cost_of,
                                                   drift_table,
                                                   format_drift_table,
                                                   memory_drift, memory_of)

__all__ = ['Telemetry', 'get', 'reset', 'FlightRecorder', 'recorder',
           'reset_recorder', 'telemetry_dir', 'load_dump',
           'encode_records', 'decode_records', 'push_records',
           'collect_records', 'collect_new_records', 'chrome_trace',
           'step_timeline', 'CohortMonitor', 'phase_splits',
           'phase_medians', 'format_snapshot', 'RooflineTracker',
           'classify_regime', 'cost_of', 'memory_of', 'memory_drift',
           'drift_table', 'format_drift_table']
