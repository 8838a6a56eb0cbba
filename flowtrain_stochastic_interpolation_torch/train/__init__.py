"""Training: the unconditional objective, the optimiser and the train step."""
