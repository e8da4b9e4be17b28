"""The request-timeline decomposition check (the JAX package's
``obs/timeline.py::check_decomposition``, stdlib only) and the
nearest-rank :func:`percentile` the serving summaries share.

A ``request_timeline`` event's ``queue_s + prefill_s + decode_s +
preempted_s + overhead_s`` must sum to ``e2e_s`` within tolerance, no
component may be meaningfully negative (a negative overhead means a
dispatch was attributed twice), and the coalesced segments must agree
with the per-phase seconds.
"""

from __future__ import annotations

from typing import Optional

PHASES = ("queue", "prefill", "decode", "preempted", "overhead")


def percentile(sorted_vals: list, p: float) -> float:
    """Nearest-rank percentile over an already sorted list (the JAX
    package's ``obs/report.py`` convention), shared by the engine's,
    the router's and the load generator's summaries and the trace
    rollups."""
    n = len(sorted_vals)
    return float(sorted_vals[min(n - 1, int(p * (n - 1) + 0.5))])
SEGMENT_PHASES = ("queue", "prefill", "decode", "preempted")


def check_decomposition(rec: dict, tol: Optional[float] = None) -> list[str]:
    """Consistency errors for one ``request_timeline`` record (empty:
    it checks out). ``tol`` defaults to 1% of e2e plus 2 ms."""
    errors = []
    rid = rec.get("request")
    e2e = rec.get("e2e_s")
    parts = {}
    for ph in PHASES:
        v = rec.get(f"{ph}_s")
        if not isinstance(v, (int, float)):
            return [f"request {rid}: missing/mistyped {ph}_s"]
        parts[ph] = float(v)
    if not isinstance(e2e, (int, float)):
        return [f"request {rid}: missing/mistyped e2e_s"]
    if tol is None:
        tol = 0.01 * float(e2e) + 0.002
    for ph, v in parts.items():
        if v < -tol:
            errors.append(f"request {rid}: negative {ph}_s {v}")
    total = sum(parts.values())
    if abs(total - float(e2e)) > tol:
        errors.append(f"request {rid}: phase sum {round(total, 6)} != "
                      f"e2e_s {e2e} (tol {round(tol, 6)})")
    segs = rec.get("segments")
    if not isinstance(segs, list):
        return errors + [f"request {rid}: missing segments list"]
    seg_sums = {ph: 0.0 for ph in SEGMENT_PHASES}
    prev_t0 = -tol
    for i, seg in enumerate(segs):
        if not isinstance(seg, dict) or seg.get("ph") not in seg_sums:
            errors.append(f"request {rid}: segments[{i}] malformed")
            continue
        t0, dur = seg.get("t0"), seg.get("dur")
        if not isinstance(t0, (int, float)) or not isinstance(dur, (int, float)):
            errors.append(f"request {rid}: segments[{i}] missing t0/dur")
            continue
        if t0 < prev_t0:
            errors.append(f"request {rid}: segments[{i}] out of order")
        prev_t0 = t0
        if t0 < -tol or t0 + dur > float(e2e) + tol:
            errors.append(f"request {rid}: segments[{i}] outside [0, e2e]")
        seg_sums[seg["ph"]] += float(dur)
    for ph in SEGMENT_PHASES:
        if abs(seg_sums[ph] - parts[ph]) > tol:
            errors.append(f"request {rid}: {ph} segments sum "
                          f"{round(seg_sums[ph], 6)} != {ph}_s {parts[ph]}")
    return errors
