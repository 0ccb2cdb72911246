"""Telemetry of the port: so far the span/counter registry (a copy of the
JAX package's ``telemetry/core.py``), which the execution plan records
its emitted buckets through."""
