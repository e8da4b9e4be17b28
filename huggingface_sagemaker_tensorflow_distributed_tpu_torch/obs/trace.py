"""Fleet request tracing, the stitching half (the JAX package's
``obs/trace.py``: :func:`collect_traces`, :func:`check_trace`,
:func:`fleet_summary`; stdlib only).

The router mints a ``trace_id`` per submit and a ``hop`` counter that
advances on every inter-engine move (a migration, a drain's requeue).
Every lifecycle event of a traced request carries them, so grouping by
``(host, pid, trace_id)`` reassembles the request's whole history,
whichever engine emitted each line. A trace is complete when its last
timeline was emitted at finish and every hop ``1..H`` left evidence (a
``migrate`` or ``requeue`` event); anything less is flagged incomplete,
never wrong.

The cross-hop decomposition telescopes off the engine's five-way split
(``queue + prefill + decode + preempted + overhead = e2e``, cumulative
across engines): a migration hold closes as a ``via: "migrate"``
preempted segment, and a hot migrate event prices the hop
(``extract_s``, ``restore_s``)::

    router_queue     = queue_s
    prefill          = prefill_s
    transport        = sum(extract_s + restore_s) over hops
    decode_admission = sum(via-migrate segment durs) - sum(extract_s)
    decode           = decode_s
    preempted        = preempted_s - sum(via-migrate segment durs)
    overhead         = overhead_s - sum(restore_s)

which sums to ``e2e_s`` exactly when the five-way split does. Each hot
hop's ``transport_hop_s`` (source extraction stamp to destination scatter
complete, one process's monotonic clock) is checked against the hold
segment plus the restore it should cover.
"""

from __future__ import annotations

from typing import Iterable, Optional

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.timeline import (
    check_decomposition,
    percentile,
)

__all__ = ["TRACE_PHASES", "collect_traces", "check_trace", "fleet_summary"]

#: The cross-hop phase columns, in narrative order.
TRACE_PHASES = ("router_queue", "prefill", "transport",
                "decode_admission", "decode", "preempted", "overhead")

#: Same-timestamp tiebreak of the event fold: lifecycle order.
_EVENT_ORDER = {"submit": 0, "admit": 1, "swap_out": 2, "preempt": 3,
                "requeue": 4, "migrate": 5, "swap_in": 6,
                "first_token": 7, "request_timeline": 8, "finish": 9}


def _proc_key(rec: dict) -> tuple:
    """The emitting process from the envelope: request ids count per
    process, so two processes' traces never merge."""
    return (int(rec.get("host", 0)), int(rec.get("pid", 0)))


def _traced(events: Iterable[dict]) -> list[dict]:
    """Serve events with a trace context, in fold order (timestamp,
    lifecycle tiebreak, hop)."""
    rows = [e for e in events
            if e.get("type") == "serve"
            and isinstance(e.get("trace_id"), str) and e["trace_id"]]
    rows.sort(key=lambda e: (float(e.get("t", 0.0)),
                             _EVENT_ORDER.get(e.get("event"), 99),
                             int(e["hop"]) if isinstance(
                                 e.get("hop"), int) else 0))
    return rows


def collect_traces(events: Iterable[dict]) -> list[dict]:
    """Traced serve events stitched into one record per ``(host, pid,
    trace_id)``, sorted by that key: ``trace_id``, ``request``, ``hops``,
    ``replicas`` (every replica touched), ``events``, ``complete``,
    ``incomplete`` (the reasons), ``timeline`` (the last
    ``request_timeline``), ``migrates``, ``phases`` (complete traces
    only) and ``ttft_s`` / ``e2e_s`` / ``tokens`` when known."""
    by_key: dict[tuple, list[dict]] = {}
    for e in _traced(events):
        by_key.setdefault(_proc_key(e) + (e["trace_id"],), []).append(e)
    return [_stitch_one(key[2], evs) for key, evs in sorted(by_key.items())]


def _stitch_one(tid: str, evs: list[dict]) -> dict:
    timelines = [e for e in evs if e.get("event") == "request_timeline"]
    # the last timeline wins: a finish supersedes a preemption's partial
    tl = timelines[-1] if timelines else None
    migrates = [e for e in evs if e.get("event") == "migrate"]
    hop_evidence = {int(e["hop"]) for e in evs
                    if e.get("event") in ("migrate", "requeue")
                    and isinstance(e.get("hop"), int)}
    rids = {e["request"] for e in evs if isinstance(e.get("request"), int)}
    replicas = sorted({e[k] for e in evs
                       for k in ("replica", "from_replica", "to_replica")
                       if isinstance(e.get(k), int)})
    max_hop = max([int(e["hop"]) for e in evs
                   if isinstance(e.get("hop"), int)] or [0])
    trace: dict = {
        "trace_id": tid,
        "request": min(rids) if rids else None,
        "events": len(evs),
        "replicas": replicas,
        "hops": max_hop,
        "migrates": migrates,
        "timeline": tl,
    }
    incomplete = []
    if len(rids) > 1:
        incomplete.append(f"trace spans {len(rids)} request ids {sorted(rids)}")
    if tl is None:
        incomplete.append("no request_timeline event (torn tail?)")
    elif tl.get("at") != "finish":
        incomplete.append(f"final timeline is at={tl.get('at')!r}, not finish")
    else:
        trace["e2e_s"] = tl.get("e2e_s")
        trace["tokens"] = tl.get("tokens")
        if isinstance(tl.get("ttft_s"), (int, float)):
            trace["ttft_s"] = tl["ttft_s"]
        tl_hop = tl["hop"] if isinstance(tl.get("hop"), int) else 0
        if tl_hop < max_hop:
            incomplete.append(
                f"finish timeline at hop {tl_hop} but hop {max_hop} "
                "evidence exists (stale finish?)")
        for h in range(1, tl_hop + 1):
            if h not in hop_evidence:
                incomplete.append(f"missing hop {h} evidence "
                                  "(no migrate/requeue event)")
    trace["complete"] = not incomplete
    trace["incomplete"] = incomplete
    if trace["complete"]:
        trace["phases"] = _trace_phases(tl, migrates)
    return trace


def _via_segments(tl: dict) -> list[dict]:
    return [s for s in tl.get("segments", [])
            if isinstance(s, dict) and s.get("via") == "migrate"]


def _trace_phases(tl: dict, migrates: list[dict]) -> dict:
    """The telescoped cross-hop decomposition (module docstring)."""
    extract = sum(float(e.get("extract_s") or 0.0) for e in migrates)
    restore = sum(float(e.get("restore_s") or 0.0) for e in migrates)
    via = sum(float(s.get("dur", 0.0)) for s in _via_segments(tl))
    phases = {
        "router_queue": float(tl.get("queue_s", 0.0)),
        "prefill": float(tl.get("prefill_s", 0.0)),
        "transport": extract + restore,
        "decode_admission": via - extract,
        "decode": float(tl.get("decode_s", 0.0)),
        "preempted": float(tl.get("preempted_s", 0.0)) - via,
        "overhead": float(tl.get("overhead_s", 0.0)) - restore,
    }
    return {ph: round(phases[ph], 6) for ph in TRACE_PHASES}


def check_trace(trace: dict, tol: Optional[float] = None) -> list[str]:
    """Consistency errors of one stitched trace (empty: it checks out).
    An incomplete trace is flagged by the stitch, not here. A complete
    one must pass the per-engine five-way check, sum its cross-hop phases
    to e2e, hold no meaningfully negative phase, and show no gap or
    overlap between each priced hop's clock and the hold segment plus
    restore it covers. ``tol`` defaults to 1% of e2e plus 2 ms."""
    if not trace.get("complete"):
        return []
    tid = trace.get("trace_id")
    tl = trace["timeline"]
    errors = [f"trace {tid}: {e}" for e in check_decomposition(tl)]
    e2e = float(tl.get("e2e_s", 0.0))
    if tol is None:
        tol = 0.01 * e2e + 0.002
    phases = trace.get("phases") or {}
    for ph in TRACE_PHASES:
        v = phases.get(ph)
        if not isinstance(v, (int, float)):
            return errors + [f"trace {tid}: missing phase {ph}"]
        if v < -tol:
            errors.append(f"trace {tid}: negative {ph} {v}")
    total = sum(float(phases[ph]) for ph in TRACE_PHASES)
    if abs(total - e2e) > tol:
        errors.append(f"trace {tid}: cross-hop phase sum "
                      f"{round(total, 6)} != e2e_s {e2e} "
                      f"(tol {round(tol, 6)})")
    via_by_hop = {s["hop"]: float(s.get("dur", 0.0))
                  for s in _via_segments(tl) if isinstance(s.get("hop"), int)}
    for e in trace.get("migrates", []):
        hop_s = e.get("transport_hop_s")
        h = e.get("hop")
        if not isinstance(hop_s, (int, float)) or not isinstance(h, int):
            continue            # a cold or requeue-restored hop: unpriced
        if h not in via_by_hop:
            errors.append(f"trace {tid}: hop {h} priced ({hop_s}s) but no "
                          "migration-hold segment closed for it")
            continue
        gap = float(hop_s) - via_by_hop[h] - float(e.get("restore_s") or 0.0)
        if gap > tol:
            errors.append(f"trace {tid}: hop {h} inter-hop gap "
                          f"{round(gap, 6)}s exceeds tolerance {round(tol, 6)}")
        elif gap < -tol:
            errors.append(f"trace {tid}: hop {h} overlap {round(-gap, 6)}s "
                          "(double-attributed transport)")
    return errors


# -- fleet rollups ---------------------------------------------------------------

def _pcts(vals: list, label: str, out: dict) -> None:
    vals = sorted(vals)
    if vals:
        out[f"{label}_p50_s"] = round(percentile(vals, 0.50), 6)
        out[f"{label}_p95_s"] = round(percentile(vals, 0.95), 6)
        out[f"{label}_p99_s"] = round(percentile(vals, 0.99), 6)


def _tpot(tl: dict) -> Optional[float]:
    """Seconds per output token after the first, from a finish
    timeline."""
    if not isinstance(tl.get("ttft_s"), (int, float)):
        return None
    tokens = tl.get("tokens")
    if not isinstance(tokens, int):
        return None
    return (float(tl["e2e_s"]) - float(tl["ttft_s"])) / max(tokens - 1, 1)


def _replica_roles(traces: list[dict]) -> dict[int, str]:
    """Each replica's role from where segments ran: only prefill
    segments is ``prefill``, only decode ``decode``, both ``mixed``."""
    prefills: set = set()
    decodes: set = set()
    for tr in traces:
        tl = tr.get("timeline")
        if tl is None:
            continue
        for seg in tl.get("segments", []):
            if not isinstance(seg, dict):
                continue
            rep = seg.get("replica")
            if not isinstance(rep, int):
                continue
            if seg.get("ph") == "prefill":
                prefills.add(rep)
            elif seg.get("ph") == "decode":
                decodes.add(rep)
    return {rep: ("mixed" if rep in prefills and rep in decodes
                  else "prefill" if rep in prefills else "decode")
            for rep in prefills | decodes}


def fleet_summary(traces: list[dict]) -> dict:
    """The rollup of a stitched trace set: stitch health (``traces``,
    ``complete_traces``, ``trace_stitch_failures``), cross-hop phase
    totals and fractions, TTFT/e2e/TPOT percentiles (the router's
    nearest-rank convention), transport totals, and the per-role,
    per-replica and per-tenant breakdowns."""
    complete = [t for t in traces if t.get("complete")]
    out: dict = {
        "traces": len(traces),
        "complete_traces": len(complete),
        "trace_stitch_failures": len(traces) - len(complete),
    }
    bad = [{"trace_id": t["trace_id"], "incomplete": t["incomplete"]}
           for t in traces if not t.get("complete")]
    if bad:
        out["incomplete"] = bad
    if not complete:
        return out
    e2e_total = sum(float(t["e2e_s"]) for t in complete)
    totals = {ph: round(sum(float(t["phases"][ph]) for t in complete), 6)
              for ph in TRACE_PHASES}
    out["phase_total_s"] = totals
    if e2e_total > 0:
        out["phase_frac"] = {ph: round(totals[ph] / e2e_total, 4)
                             for ph in TRACE_PHASES}
    ttfts = [float(t["ttft_s"]) for t in complete
             if isinstance(t.get("ttft_s"), (int, float))]
    _pcts(ttfts, "ttft", out)
    _pcts([float(t["e2e_s"]) for t in complete], "e2e", out)
    tpots = [v for v in (_tpot(t["timeline"]) for t in complete)
             if v is not None]
    _pcts(tpots, "tpot", out)
    hops = [e for t in complete for e in t["migrates"]]
    if hops:
        out["transport_hops"] = len(hops)
        out["migration_bytes"] = sum(int(e.get("migration_bytes") or 0)
                                     for e in hops)
        priced = sorted(float(e["transport_hop_s"]) for e in hops
                        if isinstance(e.get("transport_hop_s"), (int, float)))
        if priced:
            out["transport_hop_s_p50"] = round(percentile(priced, 0.50), 6)
            out["transport_hop_s_p99"] = round(percentile(priced, 0.99), 6)
    roles = _replica_roles(complete)
    per_role: dict = {}
    for role in sorted(set(roles.values())):
        row: dict = {"replicas": sorted(r for r, ro in roles.items()
                                        if ro == role)}
        if role in ("prefill", "mixed"):
            _pcts(ttfts, "ttft", row)
        if role in ("decode", "mixed"):
            _pcts(tpots, "tpot", row)
        per_role[role] = row
    if per_role:
        out["per_role"] = per_role
    per_replica: dict = {}
    for tr in complete:
        for seg in tr["timeline"].get("segments", []):
            if not (isinstance(seg, dict)
                    and isinstance(seg.get("replica"), int)):
                continue
            row = per_replica.setdefault(seg["replica"], {
                "prefill_s": 0.0, "decode_s": 0.0, "hold_s": 0.0,
                "requests": set()})
            row["requests"].add(tr["trace_id"])
            ph = seg.get("ph")
            dur = float(seg.get("dur", 0.0))
            if ph == "prefill":
                row["prefill_s"] += dur
            elif ph == "decode":
                row["decode_s"] += dur
            elif ph in ("queue", "preempted"):
                row["hold_s"] += dur
    if per_replica:
        out["per_replica"] = {
            str(rep): {"prefill_s": round(row["prefill_s"], 6),
                       "decode_s": round(row["decode_s"], 6),
                       "hold_s": round(row["hold_s"], 6),
                       "requests": len(row["requests"]),
                       **({"role": roles[rep]} if rep in roles else {})}
            for rep, row in sorted(per_replica.items())}
    groups = sorted({t["timeline"].get("group") for t in complete
                     if t["timeline"].get("group")})
    if groups:
        per_group = {}
        for g in groups:
            sel = [t for t in complete if t["timeline"].get("group") == g]
            row = {"traces": len(sel)}
            _pcts([float(t["ttft_s"]) for t in sel
                   if isinstance(t.get("ttft_s"), (int, float))], "ttft", row)
            _pcts([float(t["e2e_s"]) for t in sel], "e2e", row)
            per_group[g] = row
        out["per_group"] = per_group
    return out
