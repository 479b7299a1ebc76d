"""Atomic checkpoints of the training state (``checkpoint.checkpointer``)."""
