"""Prefetch-depth autotuning (counterpart of the JAX package's
``data/autotune.py``, decision for decision): instead of a fixed
``PrefetchIterator(depth=2)``, the depth follows where the pipeline
waits (``data/producer_wait_s`` against ``data/consumer_wait_s``).

The controller follows the tf.data autotuning stance (Murray et al.,
VLDB 2021): observe where the pipeline actually waits, adjust ONE knob
(queue depth) with hysteresis, never exceed a resource budget. Depth
only helps when the producer is *bursty* (file-read bursts, GC) or when
transfers chunk; a producer that is simply slower than the consumer on
average cannot be fixed by buffering, and the controller must not grow
the queue without bound chasing that case. Hence:

- **grow** (x2, fast) only while the consumer-wait delta over the last
  window dominates the producer-wait delta. A growth that buys nothing
  (the next window is still input-bound with the consumer wait not down
  by 20% or more) latches a *saturated* state that stops further growth,
  until the consumer stops waiting;
- **shrink** (-1, slow) only after ``shrink_patience`` consecutive
  windows in which the producer sat on a full queue and the consumer
  never waited;
- **hard cap** from host memory: depth x per-batch bytes stays under
  ``mem_budget_bytes``, re-derived as the observed batch size changes
  (length bucketing makes batches ragged across widths).

The controller is pure state and arithmetic (no clocks, no threads), so
tests drive it with scripted waits; :class:`~.pipeline.PrefetchIterator`
feeds it the real cumulative stats once per consumed batch.

Environment contract (the JAX package's):

- ``HSTD_PREFETCH_AUTOTUNE=0`` pins the fixed depth 2.
- ``HSTD_PREFETCH_MIN`` / ``HSTD_PREFETCH_MAX`` bound the depth
  (defaults 1 / 16).
- ``HSTD_PREFETCH_MEM_MB`` caps host memory held by queued batches
  (default 512 MB).
"""

from __future__ import annotations

import os
from typing import Optional

ENV_AUTOTUNE = "HSTD_PREFETCH_AUTOTUNE"
ENV_MIN = "HSTD_PREFETCH_MIN"
ENV_MAX = "HSTD_PREFETCH_MAX"
ENV_MEM_MB = "HSTD_PREFETCH_MEM_MB"

DEFAULT_MIN_DEPTH = 1
DEFAULT_MAX_DEPTH = 16
DEFAULT_MEM_MB = 512
DEFAULT_INITIAL_DEPTH = 2

# waits below this (seconds per window) are measurement noise, not a
# bottleneck signal — neither growth nor shrink may act on them
_NOISE_FLOOR_S = 1e-4


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def autotune_enabled() -> bool:
    return os.environ.get(ENV_AUTOTUNE, "1").strip().lower() not in (
        "0", "false", "off", "no")


class PrefetchAutotuner:
    """Depth controller for one prefetch queue.

    Call :meth:`observe` once per consumed batch with the CUMULATIVE
    producer/consumer wait totals (what ``_PrefetchStats`` tracks); every
    ``window`` batches it deltas them and returns ``(new_depth, reason)``
    when the depth should change, else ``None``.
    """

    def __init__(self, min_depth: int = DEFAULT_MIN_DEPTH,
                 max_depth: int = DEFAULT_MAX_DEPTH,
                 mem_budget_bytes: Optional[int] = None,
                 initial_depth: int = DEFAULT_INITIAL_DEPTH,
                 window: int = 8, shrink_patience: int = 3):
        if min_depth < 1 or max_depth < min_depth:
            raise ValueError(
                f"need 1 <= min_depth <= max_depth, got {min_depth}/{max_depth}")
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.mem_budget_bytes = mem_budget_bytes
        self.window = max(1, window)
        self.shrink_patience = max(1, shrink_patience)
        self.depth = min(max(initial_depth, min_depth), max_depth)
        self.batch_bytes: int = 0          # max observed per-batch bytes
        self._last_producer_wait = 0.0
        self._last_consumer_wait = 0.0
        self._last_consumed = 0
        self._calm_windows = 0
        self._grew_last_window = False
        self._dc_at_grow = 0.0
        self._saturated = False
        self.decisions: int = 0

    @classmethod
    def from_env(cls, **overrides) -> Optional["PrefetchAutotuner"]:
        """Controller per the env contract; ``None`` when autotuning is
        disabled (``HSTD_PREFETCH_AUTOTUNE=0``)."""
        if not autotune_enabled():
            return None
        kw = dict(
            min_depth=max(1, _env_int(ENV_MIN, DEFAULT_MIN_DEPTH)),
            max_depth=max(1, _env_int(ENV_MAX, DEFAULT_MAX_DEPTH)),
            mem_budget_bytes=_env_int(ENV_MEM_MB, DEFAULT_MEM_MB) * (1 << 20),
        )
        kw["max_depth"] = max(kw["max_depth"], kw["min_depth"])
        kw.update(overrides)
        return cls(**kw)

    def hard_cap(self) -> int:
        """Depth ceiling: the static max, tightened by the host-memory
        budget once a batch size has been observed."""
        cap = self.max_depth
        if self.mem_budget_bytes and self.batch_bytes > 0:
            cap = min(cap, self.mem_budget_bytes // self.batch_bytes)
        return max(cap, self.min_depth)

    def observe(self, producer_wait: float, consumer_wait: float,
                consumed: int, batch_bytes: int = 0
                ) -> Optional[tuple[int, str]]:
        """One consumed batch. Returns ``(new_depth, reason)`` iff the
        depth changed; reasons: ``input_bound`` (grew), ``compute_bound``
        (shrank), ``mem_cap`` (budget clamp)."""
        if batch_bytes > self.batch_bytes:
            self.batch_bytes = int(batch_bytes)
        cap = self.hard_cap()
        if self.depth > cap:
            # a bigger batch shape arrived (bucket ladder): clamp now,
            # before the queue pins more host memory
            self.depth = cap
            self.decisions += 1
            return self.depth, "mem_cap"
        if consumed - self._last_consumed < self.window:
            return None
        dc = consumer_wait - self._last_consumer_wait
        dp = producer_wait - self._last_producer_wait
        self._last_consumer_wait = consumer_wait
        self._last_producer_wait = producer_wait
        self._last_consumed = consumed
        if dc > max(2.0 * dp, _NOISE_FLOOR_S):
            # device starved this window
            self._calm_windows = 0
            if self._grew_last_window and dc > 0.8 * self._dc_at_grow:
                # the last growth bought nothing: a producer that is
                # steadily slower than the consumer, which no queue
                # depth can fix — stop chasing it (the documented
                # control law). Cleared when the consumer stops waiting.
                self._grew_last_window = False
                self._saturated = True
                return None
            self._grew_last_window = False
            if self._saturated:
                return None
            new = min(self.depth * 2, cap)
            if new != self.depth:
                self.depth = new
                self.decisions += 1
                self._grew_last_window = True
                self._dc_at_grow = dc
                return new, "input_bound"
            return None
        self._grew_last_window = False
        if dc <= _NOISE_FLOOR_S:
            # consumer stopped waiting: whatever regime saturated us is
            # over; bursts may legitimately need growth again later
            self._saturated = False
        if dp > max(2.0 * dc, _NOISE_FLOOR_S) and dc <= _NOISE_FLOOR_S:
            # producer idled on a full queue and the consumer never
            # waited: buffer oversized — but only act after patience
            # (hysteresis: one calm window must not flap the depth)
            self._calm_windows += 1
            if self._calm_windows >= self.shrink_patience \
                    and self.depth > self.min_depth:
                self._calm_windows = 0
                self.depth -= 1
                self.decisions += 1
                return self.depth, "compute_bound"
            return None
        self._calm_windows = 0
        return None
