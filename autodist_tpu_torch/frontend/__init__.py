"""Symbolic capture frontend of the port (reference-style DSL)."""
