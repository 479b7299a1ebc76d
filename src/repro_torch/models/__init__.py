"""The port's model substrate: config, layers and the serving model."""
