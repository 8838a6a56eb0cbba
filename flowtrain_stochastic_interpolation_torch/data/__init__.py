"""Training data: the on-device synthetic geology generator, the host-side
sources, and the toy distributions of the 2-D experiments."""
