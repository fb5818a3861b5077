"""Step builders and the training launcher."""
