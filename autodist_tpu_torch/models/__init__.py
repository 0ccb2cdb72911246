"""The port's model zoo (so far the Transformer family)."""
