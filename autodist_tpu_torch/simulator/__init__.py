"""Strategy simulator of the port: so far the analytic cost model (a copy
of the JAX package's numpy-only ``simulator/cost_model.py``), whose
per-bucket decisions the execution plan shares."""
