"""Training data: datasets and the batch loader."""
