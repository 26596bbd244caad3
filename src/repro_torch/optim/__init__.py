"""Optimizer pieces of the training path: AdamW, schedules, compression."""
