"""Continuous-batching serving of the PyTorch port: paged KV
bookkeeping, the scheduler and its admission policies, the engine, the
multi-replica router with its KV transport, the open-loop load generator
and the CLI."""
