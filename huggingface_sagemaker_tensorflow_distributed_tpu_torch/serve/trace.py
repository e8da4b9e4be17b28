"""Synthetic request traces (the JAX package's
``benchmarks/serve_bench.py::make_trace`` and ``make_thrash_trace``)."""

from __future__ import annotations

import numpy as np


def make_trace(rng: np.random.RandomState, n_requests: int, vocab: int,
               prompt_lo: int, prompt_hi: int, short_new: tuple[int, int],
               long_new: tuple[int, int], long_every: int = 8,
               shared_prefix=None):
    """Mixed-length trace of ``(prompt_ids, max_new_tokens)``: every
    ``long_every``-th request wants a long continuation, the rest a short
    one — the skew that makes static batches run mostly-finished rows to
    the batch max. Prompt ids are drawn from ``[1, vocab)``.
    ``shared_prefix`` (token ids) is prepended to every prompt, the
    templated traffic of one system prompt and varied tails;
    ``prompt_lo``/``prompt_hi`` then size the tails."""
    trace = []
    for i in range(n_requests):
        p = int(rng.randint(prompt_lo, prompt_hi + 1))
        lo, hi = long_new if i % long_every == long_every - 1 else short_new
        prompt = rng.randint(1, vocab, (p,)).astype(np.int32)
        if shared_prefix is not None:
            prompt = np.concatenate([np.asarray(shared_prefix, np.int32), prompt])
        trace.append((prompt, int(rng.randint(lo, hi + 1))))
    return trace


def make_thrash_trace(rng: np.random.RandomState, n_requests: int, vocab: int,
                      n_templates: int, template_len: int, tail_lo: int,
                      tail_hi: int, short_new: tuple[int, int], long_new: int,
                      long_every: int):
    """A trace that thrashes a tight pool: ``n_templates`` system prompts
    used round-robin (a template's zero-ref cached blocks reach the cold
    end of the LRU before it recurs: the host tier's revive case), every
    ``long_every``-th request wanting ``long_new`` tokens, enough for the
    resident contexts to outgrow the pool (preemption). Returns
    ``(trace, templates)``."""
    templates = [rng.randint(1, vocab, (template_len,)).astype(np.int32)
                 for _ in range(n_templates)]
    trace = []
    for i in range(n_requests):
        tail = rng.randint(1, vocab,
                           (int(rng.randint(tail_lo, tail_hi + 1)),)).astype(np.int32)
        prompt = np.concatenate([templates[i % n_templates], tail])
        new = (long_new if i % long_every == long_every - 1
               else int(rng.randint(short_new[0], short_new[1] + 1)))
        trace.append((prompt, new))
    return trace, templates
