"""Request-lifecycle timelines (the JAX package's ``obs/timeline.py``):
per-request Gantt rows, Chrome-trace exports and SLO *attribution*
reports from the serve engine's ``request_timeline`` /
``iteration_ledger`` events, plus the incremental follower and the
sliding-window percentile estimator behind ``obs tail``.

Stdlib only, like ``obs/schema.py`` and ``obs/report.py``: it runs on a
box with neither torch nor jax (an operator's laptop tailing a live
run), which the import test holds.

Determinism: :func:`collect_timelines` folds events in a sorted order
(timestamp, then finish-over-preempt, then request id) and every
rendering sorts its keys/rows, so the same inputs in ANY argument order
produce byte-identical ``obs timeline`` / ``obs slo`` output — the
property the CLI tests pin. No wall-clock is stamped into any output.

The decomposition contract (:func:`check_decomposition`): a
``request_timeline`` event's ``queue_s + prefill_s + decode_s +
preempted_s + overhead_s`` must sum to ``e2e_s`` within tolerance, no
component may be meaningfully negative (negative overhead = a dispatch
was double-attributed), and the coalesced segment list must agree with
the aggregate per-phase seconds. The tests run this over a real engine
run; ``obs timeline`` runs it over every input it renders.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
from typing import Iterable, Optional

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.report import (
    find_event_files,
    percentile,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.schema import (
    iter_events,
    validate_event,
)

PHASES = ("queue", "prefill", "decode", "preempted", "overhead")

#: Gantt cell characters per phase (``.`` = overhead / uncovered)
_PHASE_CHAR = {"queue": "Q", "prefill": "P", "decode": "D",
               "preempted": "X"}


def load_events(paths: Iterable[str]) -> tuple[list[dict], list[str]]:
    """Strictly load every event under ``paths`` (dirs, per-host
    subdirs, or files — the :func:`~.report.find_event_files`
    expansion). Unlike the report merge, errors here are FATAL to the
    caller: a timeline reconstructed from a half-trusted stream is
    worse than none, so ``obs timeline|slo`` exit nonzero on any
    malformed or schema-invalid line."""
    paths = list(paths)
    files = find_event_files(paths)
    events: list[dict] = []
    errors: list[str] = []
    if not files:
        return events, [f"no events.jsonl under {', '.join(paths)}"]
    for path in files:
        try:
            rows = list(iter_events(path))
        except OSError as e:
            errors.append(f"{path}: unreadable ({e})")
            continue
        for lineno, event, err in rows:
            if err is not None:
                errors.append(f"{path}:{lineno}: {err}")
                continue
            errs = validate_event(event)
            if errs:
                errors.extend(f"{path}:{lineno}: {m}" for m in errs)
                continue
            events.append(event)
    return events, errors


def _proc_key(rec: dict) -> tuple:
    """The emitting process's identity from the envelope: request ids
    are per-PROCESS counters, so every consumer here disambiguates by
    (host, pid) — two hosts' rid 0, or two same-host runs appended
    into one events.jsonl, must never collapse into one record."""
    return (int(rec.get("host", 0)), int(rec.get("pid", 0)))


def collect_timelines(events: Iterable[dict]) -> list[dict]:
    """Per-request timeline records, one per ``(host, pid, request)``
    (see :func:`_proc_key`). Within a key the LAST event wins (a
    preempt-requeued request's partial timeline is superseded by its
    finish, which carries the full cumulative history). Fold order is
    ``(t, at=='finish', host, pid, request)`` so any input ordering
    produces the same records. Returned sorted by
    (host, pid, request id)."""
    best: dict[tuple, dict] = {}
    rows = [e for e in events if e.get("type") == "serve"
            and e.get("event") == "request_timeline"
            and isinstance(e.get("request"), int)]
    rows.sort(key=lambda e: (float(e.get("t", 0.0)),
                             1 if e.get("at") == "finish" else 0,
                             _proc_key(e), e["request"]))
    for e in rows:
        best[_proc_key(e) + (e["request"],)] = e
    return [best[key] for key in sorted(best)]


def _proc_quals(records: list[dict]) -> tuple[bool, bool]:
    """(multi_host, multi_pid_within_a_host): which qualifiers row
    labels need so identically-numbered requests from different
    processes stay tellable apart (single-process output stays
    stable)."""
    procs = {_proc_key(r) for r in records}
    hosts = {h for h, _ in procs}
    multi_pid = any(sum(1 for h, _ in procs if h == host) > 1
                    for host in hosts)
    return len(hosts) > 1, multi_pid


def _row_label(rec: dict, multi_host: bool, multi_pid: bool) -> str:
    host, pid = _proc_key(rec)
    label = f"r{rec['request']}"
    if multi_pid:
        label = f"p{pid}:{label}"
    if multi_host:
        label = f"h{host}:{label}"
    return label


def check_decomposition(rec: dict, tol: Optional[float] = None
                        ) -> list[str]:
    """Consistency errors for one ``request_timeline`` record (empty
    list = checks out). ``tol`` defaults to ``1% of e2e + 2ms`` —
    generous against 6-decimal rounding across hundreds of coalesced
    segments, tight against real accounting bugs (a double-attributed
    dispatch shows up as overhead going negative by a full dispatch
    duration)."""
    errors = []
    rid = rec.get("request")
    e2e = rec.get("e2e_s")
    parts = {}
    for ph in PHASES:
        v = rec.get(f"{ph}_s")
        if not isinstance(v, (int, float)):
            errors.append(f"request {rid}: missing/mistyped {ph}_s")
            return errors
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
    seg_sums = {ph: 0.0 for ph in PHASES}
    prev_t0 = -tol
    for i, seg in enumerate(segs):
        if not isinstance(seg, dict) or seg.get("ph") not in _PHASE_CHAR:
            errors.append(f"request {rid}: segments[{i}] malformed")
            continue
        t0, dur = seg.get("t0"), seg.get("dur")
        if not isinstance(t0, (int, float)) \
                or not isinstance(dur, (int, float)):
            errors.append(f"request {rid}: segments[{i}] missing t0/dur")
            continue
        if t0 < prev_t0:
            errors.append(f"request {rid}: segments[{i}] out of order")
        prev_t0 = t0
        if t0 < -tol or t0 + dur > float(e2e) + tol:
            errors.append(f"request {rid}: segments[{i}] outside "
                          f"[0, e2e]")
        seg_sums[seg["ph"]] += float(dur)
    for ph in ("queue", "prefill", "decode", "preempted"):
        if abs(seg_sums[ph] - parts[ph]) > tol:
            errors.append(
                f"request {rid}: {ph} segments sum "
                f"{round(seg_sums[ph], 6)} != {ph}_s {parts[ph]}")
    return errors


def gantt_text(records: list[dict], width: int = 48) -> str:
    """Readable per-request Gantt rows: one row per request, cells
    mapped over the request's [0, span] window (span = the longest e2e,
    so rows are comparable), ``Q``ueue / ``P``refill / ``D``ecode /
    preempted ``X`` / ``.`` = overhead or past finish."""
    if not records:
        return "timeline: no request_timeline events\n"
    span = max(float(r.get("e2e_s", 0.0)) for r in records)
    span = max(span, 1e-9)
    lines = [f"timeline: {len(records)} request(s), span "
             f"{round(span, 4)}s ({width} cells of "
             f"{round(span / width, 6)}s)"]
    multi_host, multi_pid = _proc_quals(records)
    for rec in records:
        cells = []
        segs = [s for s in rec.get("segments", [])
                if isinstance(s, dict)]
        e2e = float(rec.get("e2e_s", 0.0))
        for i in range(width):
            mid = (i + 0.5) * span / width
            if mid > e2e:
                cells.append(" ")
                continue
            ch = "."
            for seg in segs:
                t0 = float(seg.get("t0", 0.0))
                if t0 <= mid <= t0 + float(seg.get("dur", 0.0)):
                    ch = _PHASE_CHAR[seg["ph"]]
                    break
            cells.append(ch)
        tag = f" [{rec['group']}]" if rec.get("group") else ""
        mark = "" if rec.get("at") == "finish" else " (preempted)"
        lines.append(
            f"  {_row_label(rec, multi_host, multi_pid)}{tag} "
            f"|{''.join(cells)}| "
            f"e2e {rec.get('e2e_s')}s  q {rec.get('queue_s')} "
            f"p {rec.get('prefill_s')} d {rec.get('decode_s')} "
            f"x {rec.get('preempted_s')} o {rec.get('overhead_s')}"
            f"{mark}")
    return "\n".join(lines) + "\n"


def _track_key(rec: dict) -> tuple:
    """The viewer-track identity of one record: the emitting process
    PLUS the replica tag. A multi-replica router runs its
    whole fleet in ONE OS process, so (host, pid) alone folded two
    replicas' identically-named spans onto one track — the
    single-engine assumption this fixes. Untagged records sort first
    (replica -1), so single-engine exports keep their pid 0."""
    host, pid = _proc_key(rec)
    rep = rec.get("replica")
    return (host, pid, rep if isinstance(rep, int) else -1)


def chrome_trace(records: list[dict]) -> dict:
    """Chrome-trace-viewer projection: ``pid`` = a stable index over
    the distinct emitting tracks (sorted (host, pid, replica) keys —
    one viewer process-row per serve process AND per router replica,
    so rid collisions across hosts, same-host runs, or same-process
    replicas never merge), ``tid`` = request, one complete ("X")
    event per segment, timestamps in microseconds on the shared wall
    clock (each record's emission time anchors its request's submit
    instant at ``t - e2e_s``). Deterministic: derived from event
    fields only, rows in (host, pid, replica, request-id) order; the
    real host/pid (and replica, when tagged) ride each event's
    ``args``."""
    proc_index = {key: i for i, key in enumerate(
        sorted({_track_key(r) for r in records}))}
    trace = []
    for rec in records:
        submit_wall = float(rec.get("t", 0.0)) - float(
            rec.get("e2e_s", 0.0))
        host, pid = _proc_key(rec)
        for seg in rec.get("segments", []):
            if not isinstance(seg, dict):
                continue
            args = {k: v for k, v in seg.items()
                    if k not in ("ph", "t0", "dur")}
            args["request"] = rec["request"]
            args["host"] = host
            args["os_pid"] = pid
            if isinstance(rec.get("replica"), int):
                args.setdefault("replica", rec["replica"])
            if rec.get("group"):
                args["group"] = rec["group"]
            trace.append({
                "name": seg.get("ph", "?"),
                "ph": "X",
                "ts": round((submit_wall
                             + float(seg.get("t0", 0.0))) * 1e6, 3),
                "dur": round(float(seg.get("dur", 0.0)) * 1e6, 3),
                "pid": proc_index[_track_key(rec)],
                "tid": int(rec["request"]),
                "args": args,
            })
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def _phase_fracs(records: list[dict]) -> dict:
    """Aggregate phase-time fractions over a record set (fractions of
    summed e2e; {} when the set is empty or zero-length)."""
    tot = sum(float(r.get("e2e_s", 0.0)) for r in records)
    if tot <= 0:
        return {}
    return {ph: round(sum(float(r.get(f"{ph}_s", 0.0))
                          for r in records) / tot, 4)
            for ph in PHASES}


def _dominant_phase(rec: dict) -> str:
    """The phase that burned the largest share of one request's e2e —
    ties break in PHASES order (queue first), so attribution is
    deterministic."""
    return max(PHASES, key=lambda ph: (float(rec.get(f"{ph}_s", 0.0)),
                                       -PHASES.index(ph)))


def slo_attribution(records: list[dict], pct: float = 0.99) -> dict:
    """The SLO *attribution* report: not just "p99 e2e regressed" but
    WHICH phase the tail requests burned their budget in. ``pct``
    selects the tail (nearest-rank, the one percentile convention
    shared with ``obs.report``); requests at/above the threshold are
    attributed to their dominant phase. Aggregated overall and per
    ``group`` key (the per-tenant hook), and — when the records carry a
    ``replica`` tag (a multi-replica router run) — per
    replica, so per-replica tail attribution falls out of the same
    machinery (a placement policy sending the tail to one sick replica
    is visible here before any aggregate moves). Records tagged with a
    ``priority`` class (admission control) additionally get a
    per-class rollup — attainment and deadline misses per priority
    next to the per-tenant split, so a starved class is visible next
    to the tenant it belongs to."""
    out: dict = {"requests": len(records), "percentile": pct}
    if not records:
        return out
    e2es = sorted(float(r.get("e2e_s", 0.0)) for r in records)
    thr = percentile(e2es, pct)
    out["e2e_p50_s"] = round(percentile(e2es, 0.50), 6)
    out["e2e_p95_s"] = round(percentile(e2es, 0.95), 6)
    out["e2e_p99_s"] = round(percentile(e2es, 0.99), 6)
    out["threshold_s"] = round(thr, 6)
    out["phase_time_frac"] = _phase_fracs(records)
    ttfts = sorted(float(r["ttft_s"]) for r in records
                   if isinstance(r.get("ttft_s"), (int, float)))
    if ttfts:
        out["ttft_p50_s"] = round(percentile(ttfts, 0.50), 6)
        out["ttft_p99_s"] = round(percentile(ttfts, 0.99), 6)
    tail = [r for r in records if float(r.get("e2e_s", 0.0)) >= thr]
    multi_host, multi_pid = _proc_quals(records)
    counts: dict[str, int] = {}
    rows = []
    for rec in sorted(tail, key=lambda r: (-float(r.get("e2e_s", 0.0)),
                                           _proc_key(r),
                                           r["request"])):
        dom = _dominant_phase(rec)
        counts[dom] = counts.get(dom, 0) + 1
        row = {"request": rec["request"],
               "e2e_s": rec.get("e2e_s"),
               "dominant_phase": dom}
        if multi_host:
            row["host"] = _proc_key(rec)[0]
        if multi_pid:
            row["pid"] = _proc_key(rec)[1]
        for ph in PHASES:
            row[f"{ph}_s"] = rec.get(f"{ph}_s")
        if rec.get("group"):
            row["group"] = rec["group"]
        if isinstance(rec.get("replica"), int):
            row["replica"] = rec["replica"]
        if rec.get("blocked_reason"):
            row["blocked_reason"] = rec["blocked_reason"]
        rows.append(row)
    out["tail"] = {
        "count": len(tail),
        "dominant_phase_counts": {k: counts[k] for k in sorted(counts)},
        "phase_time_frac": _phase_fracs(tail),
        "requests": rows,
    }
    groups: dict[str, list[dict]] = {}
    for rec in records:
        groups.setdefault(rec.get("group") or "", []).append(rec)
    if len(groups) > 1 or "" not in groups:
        out["groups"] = {}
        for g in sorted(groups):
            recs = groups[g]
            ge2es = sorted(float(r.get("e2e_s", 0.0)) for r in recs)
            out["groups"][g] = {
                "requests": len(recs),
                "e2e_p50_s": round(percentile(ge2es, 0.50), 6),
                "e2e_p99_s": round(percentile(ge2es, 0.99), 6),
                "phase_time_frac": _phase_fracs(recs),
            }
    replicas: dict[int, list[dict]] = {}
    for rec in records:
        if isinstance(rec.get("replica"), int):
            replicas.setdefault(rec["replica"], []).append(rec)
    if replicas:
        out["replicas"] = {}
        for i in sorted(replicas):
            recs = replicas[i]
            re2es = sorted(float(r.get("e2e_s", 0.0)) for r in recs)
            out["replicas"][str(i)] = {
                "requests": len(recs),
                "e2e_p50_s": round(percentile(re2es, 0.50), 6),
                "e2e_p99_s": round(percentile(re2es, 0.99), 6),
                "phase_time_frac": _phase_fracs(recs),
                "tail_count": sum(
                    1 for r in recs
                    if float(r.get("e2e_s", 0.0)) >= thr),
            }
    # per-priority-class rollup: emitters stamp `priority`
    # only when non-zero (absent-when-default), so any tagged record
    # implies classes are in play and untagged records are class 0
    prios: dict[int, list[dict]] = {}
    for rec in records:
        p = rec.get("priority")
        if isinstance(p, int) and not isinstance(p, bool):
            prios.setdefault(p, []).append(rec)
    if prios:
        for rec in records:
            if not isinstance(rec.get("priority"), int):
                prios.setdefault(0, []).append(rec)
        out["priorities"] = {}
        for p in sorted(prios):
            recs = prios[p]
            pe2es = sorted(float(r.get("e2e_s", 0.0)) for r in recs)
            sec = {
                "requests": len(recs),
                "e2e_p50_s": round(percentile(pe2es, 0.50), 6),
                "e2e_p99_s": round(percentile(pe2es, 0.99), 6),
                "tail_count": sum(
                    1 for r in recs
                    if float(r.get("e2e_s", 0.0)) >= thr),
            }
            met = [r["slo_met"] for r in recs
                   if isinstance(r.get("slo_met"), bool)]
            if met:
                sec["slo_attainment"] = round(
                    sum(met) / len(met), 4)
            misses = [r["deadline_miss"] for r in recs
                      if isinstance(r.get("deadline_miss"), bool)]
            if misses:
                sec["deadline_misses"] = int(sum(misses))
            out["priorities"][str(p)] = sec
    return out


def render_slo_text(doc: dict) -> str:
    """Readable rendering of a :func:`slo_attribution` document."""
    lines = [f"slo attribution over {doc.get('requests', 0)} "
             f"request(s), tail = p{round(100 * doc.get('percentile', 0.99))}"]
    if doc.get("e2e_p50_s") is not None:
        lines.append(f"  e2e: p50 {doc['e2e_p50_s']}s  "
                     f"p95 {doc['e2e_p95_s']}s  p99 {doc['e2e_p99_s']}s")
    fr = doc.get("phase_time_frac") or {}
    if fr:
        lines.append("  phase time: " + "  ".join(
            f"{ph} {fr[ph]:.1%}" for ph in PHASES if ph in fr))
    tail = doc.get("tail") or {}
    if tail:
        lines.append(f"  tail ({tail.get('count', 0)} at/over "
                     f"{doc.get('threshold_s')}s):")
        for ph, n in (tail.get("dominant_phase_counts") or {}).items():
            lines.append(f"    {n} dominated by {ph}")
        for row in tail.get("requests", [])[:10]:
            g = f" [{row['group']}]" if row.get("group") else ""
            lines.append(f"    r{row['request']}{g}: e2e {row['e2e_s']}s"
                         f" <- {row['dominant_phase']}")
    for g, sec in (doc.get("groups") or {}).items():
        lines.append(f"  group {g or '(none)'!r}: "
                     f"{sec['requests']} request(s), "
                     f"e2e p50 {sec['e2e_p50_s']}s "
                     f"p99 {sec['e2e_p99_s']}s")
    for i, sec in (doc.get("replicas") or {}).items():
        lines.append(f"  replica {i}: {sec['requests']} request(s), "
                     f"e2e p50 {sec['e2e_p50_s']}s "
                     f"p99 {sec['e2e_p99_s']}s, "
                     f"{sec['tail_count']} in the tail")
    for p, sec in (doc.get("priorities") or {}).items():
        extras = ""
        if "slo_attainment" in sec:
            extras += f", attainment {sec['slo_attainment']:.2%}"
        if "deadline_misses" in sec:
            extras += f", {sec['deadline_misses']} deadline miss(es)"
        lines.append(f"  priority {p}: {sec['requests']} request(s), "
                     f"e2e p50 {sec['e2e_p50_s']}s "
                     f"p99 {sec['e2e_p99_s']}s, "
                     f"{sec['tail_count']} in the tail{extras}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Live following (`obs tail`)
# ---------------------------------------------------------------------------

class SlidingWindow:
    """Deterministic sliding-window percentile estimator over the last
    ``size`` samples: a deque for arrival order + a sorted mirror
    maintained by bisect, so ``percentile`` is an exact nearest-rank
    read of the window (the same convention as
    :func:`~.report.percentile`) — no probabilistic sketching, and
    byte-identical across runs for identical inputs. O(window) per
    push worst case, which at tailing window sizes (tens to a few
    thousand) is free."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"window size must be >= 1, got {size}")
        self.size = int(size)
        self._q: collections.deque = collections.deque()
        self._sorted: list[float] = []

    def push(self, value) -> None:
        v = float(value)
        self._q.append(v)
        bisect.insort(self._sorted, v)
        if len(self._q) > self.size:
            old = self._q.popleft()
            self._sorted.pop(bisect.bisect_left(self._sorted, old))

    def __len__(self) -> int:
        return len(self._q)

    def sum(self) -> float:
        return sum(self._q)

    def mean(self) -> Optional[float]:
        return sum(self._q) / len(self._q) if self._q else None

    def percentile(self, p: float) -> Optional[float]:
        if not self._sorted:
            return None
        return percentile(self._sorted, p)


class TailFollower:
    """Incremental reader for a live, append-only ``events.jsonl``: the
    byte offset of consumed input is carried across :meth:`poll` calls,
    so the prefix is read EXACTLY once no matter how long the file
    grows (the property the follower test pins). A partial trailing
    line (a writer caught mid-append) is left unconsumed until its
    newline lands — no torn-tail heuristics needed on a live file."""

    def __init__(self, path: str):
        self.path = path
        self._pos = 0
        self._lineno = 0

    def poll(self) -> tuple[list[dict], list[str]]:
        """(new valid events, errors) appended since the last poll.
        Schema-invalid or unparseable COMPLETE lines are errors — a
        live stream feeding dashboards must fail loudly, not render
        garbage gauges."""
        events: list[dict] = []
        errors: list[str] = []
        try:
            with open(self.path, "rb") as f:
                size = os.fstat(f.fileno()).st_size
                if size < self._pos:
                    # truncated/recreated below the consumed offset (a
                    # restarted run reopened the file): silence here
                    # would read as an idle engine forever — fail loud
                    return events, [
                        f"{self.path}: truncated below the consumed "
                        f"offset ({size} < {self._pos}) — file "
                        "recreated? restart the tail"]
                f.seek(self._pos)
                raw = f.read()
        except OSError as e:
            return events, [f"{self.path}: unreadable ({e})"]
        cut = raw.rfind(b"\n")
        if cut < 0:
            return events, errors        # nothing complete yet
        chunk = raw[:cut + 1]
        self._pos += len(chunk)
        for line in chunk.split(b"\n")[:-1]:
            self._lineno += 1
            if not line.strip():
                continue
            try:
                obj = json.loads(line.decode("utf-8", "replace"))
            except ValueError:
                errors.append(f"{self.path}:{self._lineno}: "
                              "unparseable JSON")
                continue
            errs = validate_event(obj)
            if errs:
                errors.extend(f"{self.path}:{self._lineno}: {m}"
                              for m in errs)
                continue
            events.append(obj)
        return events, errors


class TailStats:
    """Rolling serve gauges over a sliding window of events: waiting
    depth + KV pressure (latest ``iteration_ledger``, falling back to
    the ``serve/waiting_depth`` metric series when the timeline is
    off), decode tokens/sec (windowed ledger tokens over ledger
    seconds), and TTFT percentiles (windowed ``first_token`` events)."""

    def __init__(self, window: int = 64):
        self.window = int(window)
        self.events = 0
        self.waiting: Optional[int] = None
        self.kv_used_frac: Optional[float] = None
        self.iteration: Optional[int] = None
        self._ttft = SlidingWindow(window)
        self._tokens = SlidingWindow(window)
        self._dur = SlidingWindow(window)
        # rolling SLO attainment: 1/0 per verdict-carrying
        # finish event over the same window — the live "are we meeting
        # deadlines RIGHT NOW" gauge an operator watches during an
        # open-loop run; never populated (and never rendered) on
        # closed-loop streams
        self._slo = SlidingWindow(window)

    def update(self, event: dict) -> None:
        self.events += 1
        etype = event.get("type")
        if etype == "serve":
            kind = event.get("event")
            if kind == "iteration_ledger":
                self.iteration = event.get("iteration")
                self.waiting = event.get("waiting")
                self.kv_used_frac = event.get("kv_used_frac")
                if isinstance(event.get("tokens"), int) and isinstance(
                        event.get("dur_s"), (int, float)):
                    self._tokens.push(event["tokens"])
                    self._dur.push(event["dur_s"])
            elif kind == "first_token" and isinstance(
                    event.get("ttft_s"), (int, float)):
                self._ttft.push(event["ttft_s"])
            elif kind == "finish" and isinstance(
                    event.get("slo_met"), bool):
                self._slo.push(1.0 if event["slo_met"] else 0.0)
        elif etype == "metric":
            name = event.get("name")
            if name == "serve/waiting_depth" \
                    and event.get("value") is not None:
                self.waiting = int(event["value"])

    def render(self) -> str:
        def fmt(v, spec="{:.6g}"):
            return "-" if v is None else spec.format(v)

        tps = None
        if self._dur.sum() > 0:
            tps = self._tokens.sum() / self._dur.sum()
        # the attainment column appears only once a verdict-carrying
        # finish has been seen: closed-loop tails keep their exact
        # pre-open-loop rendering
        slo = (f"slo_attainment={self._slo.mean():.3f} "
               if len(self._slo) else "")
        return (f"iter={fmt(self.iteration, '{}')} "
                f"waiting={fmt(self.waiting, '{}')} "
                f"kv_used={fmt(self.kv_used_frac)} "
                f"tok/s={fmt(tps, '{:.1f}')} "
                f"ttft_p50_s={fmt(self._ttft.percentile(0.50))} "
                f"ttft_p99_s={fmt(self._ttft.percentile(0.99))} "
                f"{slo}"
                f"(window n={len(self._ttft)}, events={self.events})")


def write_chrome_trace(records: list[dict], path: str) -> str:
    """Write :func:`chrome_trace` output (sorted keys — deterministic
    bytes) and return the path."""
    doc = chrome_trace(records)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, sort_keys=True)
        f.write("\n")
    return path


__all__ = [
    "PHASES",
    "SlidingWindow",
    "TailFollower",
    "TailStats",
    "check_decomposition",
    "chrome_trace",
    "collect_timelines",
    "gantt_text",
    "load_events",
    "render_slo_text",
    "slo_attribution",
    "write_chrome_trace",
]
