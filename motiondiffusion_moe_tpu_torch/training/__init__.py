"""Training: loss terms, the optimizer and train step, checkpoints, the
trainer."""
