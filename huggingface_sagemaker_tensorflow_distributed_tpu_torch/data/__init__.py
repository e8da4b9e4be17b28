"""Data sources, tokenization and batching for the port's trainer."""
