"""Training data: the on-device synthetic geology generator."""
