"""Checkpointing of the port: logical-layout checkpoints that either
package restores (``saver.py``)."""
