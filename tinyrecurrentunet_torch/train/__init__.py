"""Training of the port: schedule, state, step, checkpoints and the loop."""
