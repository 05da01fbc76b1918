"""The training step's optimizer and step function."""
