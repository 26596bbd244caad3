"""Checkpoints of the trainer's parameters and optimizer state."""
