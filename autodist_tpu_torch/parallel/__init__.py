"""Parallelism of the port (so far data parallelism only)."""
