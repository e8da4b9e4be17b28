"""Models of the PyTorch port (GPT-2 for the serving slice)."""
