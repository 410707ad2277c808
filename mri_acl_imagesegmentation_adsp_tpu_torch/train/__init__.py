"""Training side of the port (only the best-checkpoint format so far)."""
