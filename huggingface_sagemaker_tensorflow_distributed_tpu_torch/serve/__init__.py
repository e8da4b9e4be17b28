"""Continuous-batching serving of the PyTorch port: paged KV
bookkeeping, the FIFO scheduler, the engine and its CLI."""
