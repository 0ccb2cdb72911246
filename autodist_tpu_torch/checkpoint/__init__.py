"""Checkpointing of the port (ROADMAP.md Queue 1 item 11)."""
