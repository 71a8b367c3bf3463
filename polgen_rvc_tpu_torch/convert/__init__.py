"""Synthetic checkpoints and state-dict conversion to parameter dictionaries."""
