"""Host utilities: checkpoints (restart files) and the timer breakdown."""
