"""Telemetry of the port: the span/counter registry (a copy of the JAX
package's ``telemetry/core.py``), which the execution plan records its
emitted buckets through, and the roofline observatory
(:mod:`autodist_tpu_torch.telemetry.roofline`: MFU, memory drift and the
per-entry collective drift table)."""
