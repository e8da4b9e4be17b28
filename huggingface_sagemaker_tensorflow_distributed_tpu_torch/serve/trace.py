"""Synthetic request traces (the JAX package's
``benchmarks/serve_bench.py::make_trace``)."""

from __future__ import annotations

import numpy as np


def make_trace(rng: np.random.RandomState, n_requests: int, vocab: int,
               prompt_lo: int, prompt_hi: int, short_new: tuple[int, int],
               long_new: tuple[int, int], long_every: int = 8):
    """Mixed-length trace of ``(prompt_ids, max_new_tokens)``: every
    ``long_every``-th request wants a long continuation, the rest a short
    one — the skew that makes static batches run mostly-finished rows to
    the batch max. Prompt ids are drawn from ``[1, vocab)``."""
    trace = []
    for i in range(n_requests):
        p = int(rng.randint(prompt_lo, prompt_hi + 1))
        lo, hi = long_new if i % long_every == long_every - 1 else short_new
        prompt = rng.randint(1, vocab, (p,)).astype(np.int32)
        trace.append((prompt, int(rng.randint(lo, hi + 1))))
    return trace
