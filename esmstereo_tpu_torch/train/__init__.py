"""Training: schedule, optimizer state, steps, checkpoints and the loop."""
