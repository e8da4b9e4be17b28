"""Admission policies: who admits when, never what.

Counterpart of the JAX package's ``serve/policy.py``; pure host
arithmetic (the scheduler calls it on every ``admit()``). Two policies:

- ``fifo`` (default): ``make_policy`` returns None and the scheduler
  walks ``waiting[0]`` exactly as before (telemetry unchanged);
- ``slo``: aging-bounded earliest-effective-deadline order. The key
  folds in, lexicographically: (a) the aging tier (a request older than
  ``aging_s`` is promoted ahead of all younger work, promoted requests
  FIFO by origin among themselves: the strict starvation bound); (b)
  the priority class (smaller = more urgent, 0 default); (c) the
  effective deadline ``origin + deadline_s`` (none sorts last in its
  class); (d) the predicted demand in KV blocks (prompt blocks minus the
  ``peek_prefix`` cached blocks, so under KV pressure the largest cached
  prefix admits first); (e) the rid.

The per-tenant token buckets (:class:`TokenBucket`,
:func:`parse_rate_limit`, :class:`RateLimited`) are the router's; the
per-request deadline targets (:class:`SloSpec`, :func:`parse_slo`, the
JAX package's ``serve/loadgen.py`` pair) are what ``submit(slo=...)``
and the serve CLI's ``--slo`` read.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

ENV_POLICY = "HSTD_SERVE_POLICY"
ENV_AGING_S = "HSTD_SERVE_AGING_S"

POLICIES = ("fifo", "slo")

DEFAULT_AGING_S = 30.0


def parse_policy(spec) -> str:
    """The admission-policy knob: ``fifo`` (strict arrival order,
    telemetry unchanged) or ``slo`` (aging-bounded deadline /
    priority / cache-aware order). None reads ``HSTD_SERVE_POLICY``,
    default ``fifo``."""
    if spec is None:
        spec = os.environ.get(ENV_POLICY, "fifo") or "fifo"
    s = str(spec).strip().lower() or "fifo"
    if s not in POLICIES:
        raise ValueError(f"unparseable {ENV_POLICY} value {spec!r}: "
                         "expected fifo | slo")
    return s


def parse_aging_s(spec) -> float:
    """The starvation bound: under ``policy=slo`` any waiting request
    overtakes all younger work once it has waited ``aging_s`` seconds
    (policy-clock domain). None reads ``HSTD_SERVE_AGING_S``, default
    30.0; must be a positive, finite number."""
    if spec is None:
        spec = os.environ.get(ENV_AGING_S) or None
    if spec is None:
        return DEFAULT_AGING_S
    try:
        s = float(str(spec).strip() or DEFAULT_AGING_S)
    except ValueError:
        raise ValueError(f"unparseable {ENV_AGING_S} value {spec!r}: "
                         "expected a positive number of seconds")
    if not math.isfinite(s) or s <= 0:
        raise ValueError(f"{ENV_AGING_S} must be a positive finite "
                         f"number of seconds, got {spec!r}")
    return s


def request_origin(req) -> float:
    """A request's wait clock starts at its open-loop arrival stamp
    when the driver threaded one, else at the submit wall stamp — the
    same origin the SLO verdicts use, so aging and deadline slack stay
    in one time domain."""
    origin = getattr(req, "arrival_s", None)
    if origin is None:
        origin = getattr(req, "submit_t", None)
    return 0.0 if origin is None else float(origin)


class SloPolicy:
    """Aging-bounded earliest-effective-deadline admission order.

    Stateless between calls except for the parsed ``aging_s`` bound;
    callers supply the clock (``now``) and the per-request demand
    probe so virtual-clock runs stay deterministic."""

    name = "slo"

    def __init__(self, aging_s: float):
        self.aging_s = float(aging_s)

    def promoted(self, req, now: float) -> bool:
        """True once ``req`` has aged past the starvation bound."""
        return (now - request_origin(req)) >= self.aging_s

    def key(self, req, now: float,
            demand_blocks: Callable[[object], int]) -> tuple:
        origin = request_origin(req)
        if (now - origin) >= self.aging_s:
            # promoted tier: FIFO by origin — the aging bound must not
            # let two starving requests reorder each other forever
            return (0, origin, req.rid)
        deadline = getattr(req, "deadline_s", None)
        eff_deadline = (origin + deadline if deadline is not None
                        else math.inf)
        return (1, int(getattr(req, "priority", 0) or 0), eff_deadline,
                int(demand_blocks(req)), req.rid)

    def rank(self, waiting: List, now: float,
             demand_blocks: Callable[[object], int]) -> List:
        """Return ``waiting`` in admission order (a new list; the
        scheduler's queue itself is never reordered, so FIFO replay
        and requeue-at-front preemption semantics are untouched)."""
        return sorted(waiting,
                      key=lambda r: self.key(r, now, demand_blocks))


def make_policy(policy: str, aging_s: float) -> Optional[SloPolicy]:
    """None for ``fifo`` (the scheduler keeps its original admit path
    bit-for-bit); an :class:`SloPolicy` otherwise."""
    if policy == "fifo":
        return None
    return SloPolicy(aging_s)


# ---------------------------------------------------------------------------
# Router-side per-tenant rate limits
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RateLimited:
    """Structured rejection from ``Router.submit`` when a tenant's
    token bucket is empty — never a silent drop. ``retry_after_s`` is
    the bucket's own refill estimate for one request's worth of
    tokens."""

    group: str
    retry_after_s: float
    rate: float
    burst: float

    @property
    def rejected(self) -> bool:
        return True


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` cap.
    One submit costs one token. The caller supplies the clock so
    virtual-time runs replay deterministically."""

    def __init__(self, rate: float, burst: float):
        if not (rate > 0 and math.isfinite(rate)):
            raise ValueError(f"rate_limit rate must be positive and "
                             f"finite, got {rate!r}")
        if not (burst >= 1 and math.isfinite(burst)):
            raise ValueError(f"rate_limit burst must be >= 1, "
                             f"got {burst!r}")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last: Optional[float] = None

    def try_take(self, now: float) -> Tuple[bool, float]:
        """(admitted, retry_after_s). Refills lazily from the last
        observed clock; a clock that goes backwards refills nothing
        (never raises — monotonicity is the caller's business)."""
        if self._last is not None and now > self._last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._last) * self.rate)
        self._last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True, 0.0
        return False, (1.0 - self.tokens) / self.rate


def parse_rate_limit(spec) -> Dict[str, Tuple[float, float]]:
    """Per-tenant rate-limit spec → ``{group: (rate, burst)}``.

    Accepts a dict (``{"tenant": (rate, burst)}`` or ``{"tenant":
    rate}``, burst defaulting to ``max(1, rate)``) or a string of
    ``group=rate[:burst]`` comma-separated entries. ``*`` is the
    default bucket applied to groups without their own entry. None or
    empty → no rate limiting."""
    if spec is None:
        return {}
    out: Dict[str, Tuple[float, float]] = {}
    if isinstance(spec, dict):
        items = spec.items()
    else:
        items = []
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"unparseable rate_limit entry "
                                 f"{part!r}: expected group=rate[:burst]")
            g, val = part.split("=", 1)
            items.append((g.strip(), val))
    for group, val in items:
        if isinstance(val, (tuple, list)):
            rate, burst = (float(val[0]),
                           float(val[1]) if len(val) > 1 else None)
        elif isinstance(val, (int, float)):
            rate, burst = float(val), None
        else:
            txt = str(val).strip()
            if ":" in txt:
                r, b = txt.split(":", 1)
                rate, burst = float(r), float(b)
            else:
                rate, burst = float(txt), None
        if burst is None:
            burst = max(1.0, rate)
        TokenBucket(rate, burst)  # validate eagerly, with the knob named
        out[str(group)] = (rate, burst)
    return out


# ---------------------------------------------------------------------------
# Per-request deadline targets
# ---------------------------------------------------------------------------

ENV_SLO_TTFT = "HSTD_SERVE_SLO_TTFT_S"
ENV_SLO_TPOT = "HSTD_SERVE_SLO_TPOT_S"


@dataclass(frozen=True)
class SloSpec:
    """Per-request deadline targets in seconds (None = no target on that
    axis; at least one is set). ``ttft_s`` bounds the time to the first
    token from arrival, ``tpot_s`` the mean inter-token time after it."""

    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None

    def __post_init__(self):
        if self.ttft_s is None and self.tpot_s is None:
            raise ValueError("SloSpec needs at least one target "
                             "(ttft_s and/or tpot_s)")
        for name in ("ttft_s", "tpot_s"):
            v = getattr(self, name)
            if v is not None and not float(v) > 0:
                raise ValueError(f"SloSpec.{name} must be > 0, got {v!r}")


def parse_slo(spec=None) -> Optional[SloSpec]:
    """The deadline knob: ``ttft:SECS[,tpot:SECS]`` in either order, or
    ``none``. None reads ``HSTD_SERVE_SLO_TTFT_S`` /
    ``HSTD_SERVE_SLO_TPOT_S`` (both unset: no SLO)."""
    if spec is None:
        ttft = os.environ.get(ENV_SLO_TTFT, "") or None
        tpot = os.environ.get(ENV_SLO_TPOT, "") or None
        if ttft is None and tpot is None:
            return None
        try:
            return SloSpec(
                ttft_s=float(ttft) if ttft is not None else None,
                tpot_s=float(tpot) if tpot is not None else None)
        except ValueError as e:
            raise ValueError(f"unparseable {ENV_SLO_TTFT}/"
                             f"{ENV_SLO_TPOT} values: {e}")
    s = str(spec).strip().lower()
    if s in ("", "none"):
        return None
    kw = {}
    try:
        for part in s.split(","):
            axis, _, val = part.partition(":")
            axis = axis.strip()
            if axis not in ("ttft", "tpot") or f"{axis}_s" in kw:
                raise ValueError
            kw[f"{axis}_s"] = float(val)
        return SloSpec(**kw)
    except ValueError:
        raise ValueError(f"unparseable SLO spec {spec!r}: expected "
                         "ttft:SECS[,tpot:SECS] | none")
