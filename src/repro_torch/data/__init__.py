"""The training data pipeline (``data.pipeline``)."""
