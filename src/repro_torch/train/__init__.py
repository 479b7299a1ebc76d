"""The training step (``train.step``)."""
