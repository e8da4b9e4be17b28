"""Offline goodput / SLO-attainment replay (the JAX package's
``obs/goodput.py``): turn a recorded telemetry stream from one or more
open-loop serving runs into the DistServe capacity answer — what
fraction of requests met their deadlines at each offered arrival rate,
WHERE the misses spent their budget, and where the capacity knee sits
across a rate sweep.

Stdlib only, like ``obs/schema.py``, ``obs/report.py`` and
``obs/timeline.py``: it runs on a box with neither torch nor jax, which
the import test holds.

Input model: each :class:`~..serve.loadgen.OpenLoopDriver` run stamps
ONE ``serve`` ``open_loop`` event (process / rate / clock / request
count / targets) before its submissions, so a merged stream — several
runs appended into one ``events.jsonl``, or a sweep across artifact
dirs — splits back into runs per emitting process: events partition at
``open_loop`` stamps within each ``(host, pid)``. Within a run,
``finish`` events carry the engine's per-request verdicts
(``slo_met``/``slack_s``, wall-clock mode) and ``request_timeline``
events the phase decomposition — the join that answers *why* a
request missed (queue vs prefill vs decode vs preempt), per request
and per tenant group.

Determinism: the report is a pure function of the event multiset —
events sort by (host, pid, t, kind, request) before folding and every
dict/list in the output is sorted — so any input-path ordering
produces byte-identical JSON (the property the CLI test pins).
"""

from __future__ import annotations

from typing import Iterable, Optional

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.timeline import (
    PHASES,
    _dominant_phase,
    _proc_key,
)

#: a run's attainment below this fraction marks the sweep's capacity
#: knee (the first such rate, scanning rates ascending) — overridable
#: per call / via ``obs goodput --knee-target``
DEFAULT_KNEE_TARGET = 0.99


def _sort_key(event: dict) -> tuple:
    """Total order over serve events that any input ordering collapses
    to: process first, then time, with ``open_loop`` stamps winning
    same-instant ties (a run's stamp precedes its submissions) and the
    request id breaking the rest."""
    return (_proc_key(event), float(event.get("t", 0.0)),
            0 if event.get("event") == "open_loop" else 1,
            event.get("request") if isinstance(event.get("request"), int)
            else -1)


def _split_runs(events: Iterable[dict]) -> list[tuple[tuple, dict, list]]:
    """``[(proc_key, open_loop_stamp, run_events), ...]`` — one row per
    ``open_loop`` stamp, carrying every later serve event from the same
    process up to its next stamp. Pre-stamp (closed-loop) traffic is
    not goodput's business and is dropped."""
    rows = sorted((e for e in events if e.get("type") == "serve"),
                  key=_sort_key)
    runs: list[tuple[tuple, dict, list]] = []
    current: Optional[list] = None
    current_proc: Optional[tuple] = None
    for e in rows:
        proc = _proc_key(e)
        if proc != current_proc:
            current, current_proc = None, proc
        if e.get("event") == "open_loop":
            current = []
            runs.append((proc, e, current))
        elif current is not None:
            current.append(e)
    return runs


def _run_report(stamp: dict, events: list) -> dict:
    """One run's attainment/goodput/miss-attribution record."""
    out: dict = {}
    for field in ("process", "clock", "rate", "requests",
                  "slo_ttft_s", "slo_tpot_s"):
        if stamp.get(field) is not None:
            out[field] = stamp[field]
    finishes = {}
    timelines = {}
    last_t = float(stamp.get("t", 0.0))
    for e in events:
        rid = e.get("request")
        if e.get("event") == "finish" and isinstance(rid, int):
            finishes[rid] = e
            last_t = max(last_t, float(e.get("t", 0.0)))
        elif (e.get("event") == "request_timeline"
              and e.get("at") == "finish" and isinstance(rid, int)):
            timelines[rid] = e
    out["finished"] = len(finishes)
    judged = {rid: e for rid, e in finishes.items()
              if isinstance(e.get("slo_met"), bool)}
    if not judged:
        return out
    met = sum(1 for e in judged.values() if e["slo_met"])
    out["slo_met"] = met
    out["slo_missed"] = len(judged) - met
    out["slo_attainment"] = round(met / len(judged), 4)
    out["goodput_tokens"] = sum(
        e.get("tokens", 0) for e in judged.values() if e["slo_met"])
    span = last_t - float(stamp.get("t", 0.0))
    if span > 0:
        out["span_s"] = round(span, 6)
        out["goodput_tokens_per_sec"] = round(
            out["goodput_tokens"] / span, 1)
    groups: dict = {}
    miss_phases: dict = {}
    misses = []
    for rid in sorted(judged):
        fin = judged[rid]
        tl = timelines.get(rid)
        group = (tl or {}).get("group") or ""
        acc = groups.setdefault(group, [0, 0])
        acc[0] += int(fin["slo_met"])
        acc[1] += 1
        if fin["slo_met"]:
            continue
        row: dict = {"request": rid}
        if group:
            row["group"] = group
        if isinstance(fin.get("slack_s"), (int, float)):
            row["slack_s"] = fin["slack_s"]
        if tl is not None:
            # the request-timeline decomposition names WHERE the miss's budget
            # went — the Sarathi-style answer that turns "p99 broke"
            # into "queueing, add a replica" vs "prefill, chunk it"
            dom = _dominant_phase(tl)
            row["dominant_phase"] = dom
            for ph in PHASES:
                if isinstance(tl.get(f"{ph}_s"), (int, float)):
                    row[f"{ph}_s"] = tl[f"{ph}_s"]
            miss_phases[dom] = miss_phases.get(dom, 0) + 1
        misses.append(row)
    if len(groups) > 1 or "" not in groups:
        out["group_slo_attainment"] = {
            g: round(m / t, 4) for g, (m, t) in sorted(groups.items())
            if t}
    if misses:
        out["misses"] = misses
        if miss_phases:
            out["miss_phases"] = {ph: miss_phases[ph]
                                  for ph in sorted(miss_phases)}
            out["dominant_miss_phase"] = max(
                sorted(miss_phases),
                key=lambda ph: (miss_phases[ph], -PHASES.index(ph)))
    return out


def goodput(events: Iterable[dict],
            knee_target: float = DEFAULT_KNEE_TARGET) -> dict:
    """The full goodput report over a merged event stream: one record
    per open-loop run (grouped by emitting process, in process order),
    a ``rates`` sweep view aggregating runs that offered the same
    arrival rate, the capacity ``knee`` (the lowest swept rate whose
    aggregate attainment fell below ``knee_target``; None while every
    rate holds), and the judged-request-weighted ``overall_attainment``
    (what ``obs goodput --min-attainment`` gates on; absent when no
    run carried SLO verdicts)."""
    runs = _split_runs(events)
    procs: dict = {}
    for proc, stamp, run_events in runs:
        procs.setdefault(proc, []).append(_run_report(stamp, run_events))
    out: dict = {
        "processes": [
            {"host": h, "pid": p, "runs": procs[(h, p)]}
            for h, p in sorted(procs)],
        "runs": sum(len(v) for v in procs.values()),
    }
    judged = [r for v in procs.values() for r in v
              if "slo_attainment" in r]
    if not judged:
        return out
    total = sum(r["slo_met"] + r["slo_missed"] for r in judged)
    met = sum(r["slo_met"] for r in judged)
    out["overall_attainment"] = round(met / total, 4) if total else 0.0
    rated = [r for r in judged
             if isinstance(r.get("rate"), (int, float))]
    if rated:
        by_rate: dict = {}
        for r in rated:
            by_rate.setdefault(float(r["rate"]), []).append(r)
        sweep = []
        knee = None
        for rate in sorted(by_rate):
            rows = by_rate[rate]
            rmet = sum(r["slo_met"] for r in rows)
            rtot = sum(r["slo_met"] + r["slo_missed"] for r in rows)
            att = round(rmet / rtot, 4) if rtot else 0.0
            entry = {"rate": rate, "runs": len(rows),
                     "slo_attainment": att,
                     "goodput_tokens": sum(r.get("goodput_tokens", 0)
                                           for r in rows)}
            phases: dict = {}
            for r in rows:
                for ph, n in (r.get("miss_phases") or {}).items():
                    phases[ph] = phases.get(ph, 0) + n
            if phases:
                entry["miss_phases"] = {ph: phases[ph]
                                       for ph in sorted(phases)}
            sweep.append(entry)
            if knee is None and att < knee_target:
                knee = rate
        out["rates"] = sweep
        out["knee"] = (
            {"rate": knee, "target": knee_target}
            if knee is not None else None)
    return out


def render_goodput_text(doc: dict) -> str:
    """Readable rendering of a :func:`goodput` document."""
    lines = [f"goodput over {doc.get('runs', 0)} open-loop run(s)"]
    if doc.get("overall_attainment") is not None:
        lines.append(
            f"  overall attainment {doc['overall_attainment']:.2%}")
    for rate in doc.get("rates") or []:
        extra = ""
        if rate.get("miss_phases"):
            extra = "  misses: " + " ".join(
                f"{ph}={n}" for ph, n in rate["miss_phases"].items())
        lines.append(f"  rate {rate['rate']}/s: attainment "
                     f"{rate['slo_attainment']:.2%}, goodput "
                     f"{rate['goodput_tokens']} tok{extra}")
    knee = doc.get("knee")
    if knee:
        lines.append(f"  capacity knee at {knee['rate']}/s "
                     f"(attainment < {knee['target']:.0%})")
    elif "rates" in doc:
        lines.append("  no capacity knee in the swept rates")
    return "\n".join(lines) + "\n"


__all__ = [
    "DEFAULT_KNEE_TARGET",
    "goodput",
    "render_goodput_text",
]
