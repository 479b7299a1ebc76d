"""The optimizer of the training path (``optim.adamw``)."""
