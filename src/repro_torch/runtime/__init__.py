"""The fault-tolerant training driver (``runtime.trainer``)."""
