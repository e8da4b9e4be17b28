"""Cross-host run reports: merge per-host ``HSTD_TELEMETRY_DIR``
artifacts into ONE deterministic view of an N-host run.

The port's counterpart of the JAX package's ``obs/report.py``, read by
``python -m huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs``.
Stdlib only, like ``obs/schema.py``: the merge runs on a box with
neither torch nor jax.

Input: any mix of telemetry dirs (each holding an ``events.jsonl``),
dirs of per-host subdirs, or event files directly. Host identity comes
from the ``host`` envelope field, NOT the directory layout, so a shared
-filesystem run (one dir, host 0 writing) and a dir-per-host run merge
identically.

Determinism: every section is keyed and sorted (hosts numerically,
events by timestamp with name tiebreaks), so the same inputs in ANY
argument order produce byte-identical reports — the property the
fixture test pins. No wall-clock is stamped into the report for the
same reason.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.schema import (
    SCHEMA_VERSION,
    iter_events,
    validate_event,
)

REPORT_VERSION = 1


def _is_event_stream(name: str) -> bool:
    """``events.jsonl`` + the per-host ``events.host<K>.jsonl`` files
    (``HSTD_TELEMETRY_ALL_HOSTS``). ``flight_*.jsonl`` is deliberately
    EXCLUDED — flight dumps duplicate ring events."""
    return name == "events.jsonl" or (
        name.startswith("events.host") and name.endswith(".jsonl"))


def find_event_files(paths: Iterable[str]) -> list[str]:
    """Expand dirs / per-host subdirs / files into a sorted list of
    event-stream files."""
    out = set()
    for p in paths:
        if os.path.isfile(p):
            out.add(os.path.abspath(p))
            continue
        if not os.path.isdir(p):
            continue
        for name in sorted(os.listdir(p)):
            direct = os.path.join(p, name)
            if os.path.isfile(direct) and _is_event_stream(name):
                out.add(os.path.abspath(direct))
                continue
            if os.path.isdir(direct):
                for sub in sorted(os.listdir(direct)):
                    if _is_event_stream(sub):
                        out.add(os.path.abspath(
                            os.path.join(direct, sub)))
    return sorted(out)


def percentile(sorted_vals: list, p: float) -> float:
    """Nearest-rank percentile over an ALREADY-SORTED list — the ONE
    rank convention shared by the report's distributions and the serve
    engine's SLO summary (so the report never disagrees with the engine)."""
    n = len(sorted_vals)
    return float(sorted_vals[min(n - 1, int(p * (n - 1) + 0.5))])


def _dist(values: list) -> Optional[dict]:
    """{count, mean, p50, p95, max} of a numeric series (None if empty):
    the compact distribution shape every per-host section uses."""
    vals = sorted(float(v) for v in values
                  if isinstance(v, (int, float)) and v == v)
    if not vals:
        return None
    n = len(vals)
    return {"count": n, "mean": round(sum(vals) / n, 6),
            "p50": round(percentile(vals, 0.50), 6),
            "p95": round(percentile(vals, 0.95), 6),
            "max": round(vals[-1], 6)}


def _metric_series(events: list[dict], name: str) -> list:
    return [e.get("value") for e in events
            if e["type"] == "metric" and e.get("name") == name
            and e.get("value") is not None]


def _host_section(events: list[dict]) -> dict:
    """One host's rollup (events already filtered to this host and in
    file order, which is emission order)."""
    compiles = [e for e in events if e["type"] == "compile"]
    memory_peaks = [int(e["stats"].get("peak_bytes_in_use", 0))
                    for e in events if e["type"] == "memory"
                    and isinstance(e.get("stats"), dict)]
    memory_limits = [int(e["stats"].get("bytes_limit", 0))
                     for e in events if e["type"] == "memory"
                     and isinstance(e.get("stats"), dict)]
    heartbeats = [e for e in events if e["type"] == "heartbeat"]
    mfu_series = _metric_series(events, "train/mfu")
    section = {
        "events": len(events),
        "step_time_s": _dist(_metric_series(events, "train/step_time_s")),
        "samples_per_sec": _dist(
            _metric_series(events, "train/samples_per_sec")),
        "mfu": _dist(mfu_series),
        "compile": {
            "count": compiles[-1].get("count", len(compiles)) if compiles
            else 0,
            "cum_s": round(float(compiles[-1].get("cum", 0.0)), 3)
            if compiles else 0.0,
        },
        "memory": {
            "peak_bytes_in_use": max(memory_peaks, default=0),
            "bytes_limit": max(memory_limits, default=0),
        },
        "heartbeats": len(heartbeats),
        "max_progress_age_s": round(max(
            (float(e.get("progress_age", 0.0)) for e in heartbeats),
            default=0.0), 3),
        "stalls": sum(1 for e in events if e["type"] == "stall"),
        "alerts": sum(1 for e in events if e["type"] == "alert"),
        "anomalies": sum(1 for e in events if e["type"] == "anomaly"),
    }
    # a static-analysis finding count (the ``lint/findings`` series):
    # the LAST sample is the run's figure — a lint rerun supersedes
    lint_series = _metric_series(events, "lint/findings")
    if lint_series:
        section["lint_findings"] = int(lint_series[-1])
    return section


def _straggler_timeline(events: list[dict]) -> list[dict]:
    """Per-epoch straggler rows. The underlying metric comes from an
    allgather, so under HSTD_TELEMETRY_ALL_HOSTS every host emits an
    identical copy per epoch — keep ONE row per (epoch, occurrence),
    taken from the lowest-host stream (events arrive host-sorted)."""
    rows = []
    seen: set = set()
    for e in events:
        if e["type"] != "metric" \
                or e.get("name") != "train/step_time_hosts_mean":
            continue
        args = e.get("args") or {}
        row = {
            "epoch": int(e.get("step", len(rows))),
            "mean_s": round(float(args.get("mean", e.get("value") or 0.0)),
                            6),
            "max_s": round(float(args.get("max", 0.0)), 6),
            "straggler_ratio": round(float(args.get("straggler_ratio",
                                                    1.0)), 4),
            "argmax_host": args.get("argmax"),
        }
        dedup = (row["epoch"], row["mean_s"], row["max_s"],
                 row["straggler_ratio"], row["argmax_host"])
        if dedup in seen:
            continue     # another host's copy of the same allgather
        seen.add(dedup)
        rows.append(row)
    rows.sort(key=lambda r: r["epoch"])
    return rows


def _anomaly_index(events: list[dict]) -> list[dict]:
    """All anomaly events, one entry per DISTINCT incident: collective
    -derived anomalies (straggler) fire with identical name/step/message
    on every host — collapse those to the lowest host's entry (events
    arrive host-sorted); host-specific incidents (a rank-3 NaN) differ
    in message or step and are all kept."""
    rows = []
    seen: set = set()
    for e in events:
        if e["type"] != "anomaly":
            continue
        dedup = (e.get("name"), e.get("step"), e.get("message"))
        if dedup in seen:
            continue
        seen.add(dedup)
        rows.append({
            "t": float(e.get("t", 0.0)),
            "host": int(e.get("host", 0)),
            "name": e.get("name"),
            "step": e.get("step"),
            "message": e.get("message"),
            "evidence": e.get("evidence"),
        })
    rows.sort(key=lambda r: (r["t"], r["host"], str(r["name"])))
    return rows


def _serve_summary(events: list[dict]) -> Optional[dict]:
    """The engine's final ``serve`` report event wins (it carries the
    SLO percentiles); without one, reconstruct what the lifecycle
    events allow (TTFT distribution from first_token events)."""
    serves = [e for e in events if e["type"] == "serve"]
    if not serves:
        return None
    reports = [e for e in serves if e.get("event") == "report"]
    if reports:
        last = reports[-1]
        out = {k: v for k, v in last.items()
               if k not in ("v", "t", "host", "pid", "type", "event")}
        # Fleet tracing: the stitch summary is emitted as a
        # separate ``trace_stitch`` event (the stitcher runs AFTER the
        # router's final report) — overlay its fields so the trace
        # counters reach the scalar/diff surface alongside the SLO
        # percentiles. Last one wins, like the report event itself.
        stitches = [e for e in serves if e.get("event") == "trace_stitch"]
        if stitches:
            out.update({k: v for k, v in stitches[-1].items()
                        if k not in ("v", "t", "host", "pid", "type",
                                     "event")})
        return out
    ttfts = [e.get("ttft_s") for e in serves
             if e.get("event") == "first_token"
             and e.get("ttft_s") is not None]
    return {
        "requests": sum(1 for e in serves if e.get("event") == "finish"),
        "preemptions": sum(1 for e in serves
                           if e.get("event") == "preempt"),
        "ttft": _dist(ttfts),
    }


def build_report(paths: Iterable[str]) -> dict:
    """The merged run report. ``errors`` carries per-file schema
    problems (a drifted host does not abort the merge — a sick host is
    exactly when you want the report)."""
    files = find_event_files(paths)
    by_host: dict[int, list[dict]] = {}
    errors: list[str] = []
    total = 0
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
            total += 1
            by_host.setdefault(int(event.get("host", 0)), []).append(event)
    all_events = [e for h in sorted(by_host) for e in by_host[h]]
    run_headers = [e for e in all_events if e["type"] == "run"]
    report = {
        "report_version": REPORT_VERSION,
        "schema_version": SCHEMA_VERSION,
        "files": [os.path.join(os.path.basename(os.path.dirname(f)),
                               os.path.basename(f)) for f in files],
        "run": {
            "argv": run_headers[0].get("argv") if run_headers else None,
            "n_hosts": len(by_host),
            "events": total,
        },
        "hosts": {str(h): _host_section(evts)
                  for h, evts in sorted(by_host.items())},
        "straggler_timeline": _straggler_timeline(all_events),
        "anomaly_index": _anomaly_index(all_events),
        "serve": _serve_summary(all_events),
        "errors": sorted(errors),
    }
    return report


def validate_report(doc) -> list[str]:
    """Schema check for a report document (empty list = valid) — the
    gate ``obs report`` applies to its own output before printing."""
    if not isinstance(doc, dict):
        return [f"report is {type(doc).__name__}, not an object"]
    problems = []
    for field, types in (("report_version", (int,)),
                         ("schema_version", (int,)),
                         ("run", (dict,)), ("hosts", (dict,)),
                         ("straggler_timeline", (list,)),
                         ("anomaly_index", (list,)),
                         ("errors", (list,))):
        if not isinstance(doc.get(field), types):
            problems.append(f"missing/mistyped field {field!r}")
    if doc.get("report_version") not in (None, REPORT_VERSION):
        problems.append(
            f"report_version {doc.get('report_version')!r} "
            f"!= {REPORT_VERSION}")
    hosts = doc.get("hosts")
    if isinstance(hosts, dict):
        if not hosts:
            problems.append("no hosts (empty run)")
        for key, section in hosts.items():
            if not isinstance(section, dict):
                problems.append(f"host {key!r} section is not an object")
                continue
            for field in ("events", "compile", "heartbeats", "anomalies"):
                if field not in section:
                    problems.append(f"host {key!r}: missing {field!r}")
    return problems


# ---------------------------------------------------------------------------
# Report diffing (`obs diff`): one-command regression triage between
# two runs' reports — same stdlib-only contract as the merge above.
# ---------------------------------------------------------------------------

# metric name -> (direction, kind). direction +1 = higher is worse
# (latency, anomaly counts), -1 = lower is worse (MFU). kind "ratio"
# metrics regress past the relative threshold; "count" metrics regress
# on ANY increase (an anomaly delta of one is a finding, not noise).
DIFF_METRICS: dict[str, tuple[int, str]] = {
    "step_time_p50_s": (+1, "ratio"),
    "step_time_p95_s": (+1, "ratio"),
    "mfu_mean": (-1, "ratio"),
    "compile_cum_s": (+1, "ratio"),
    "compile_count": (+1, "count"),
    "anomalies": (+1, "count"),
    # unsuppressed static-analysis findings (``lint/findings``): the
    # healthy tree holds this at ZERO, so the shared count rule (any
    # increase regresses, worse UP) makes a new unannotated invariant
    # violation a CI regression even when nobody reran the linter's
    # own test tier
    "lint_findings": (+1, "count"),
    "serve_ttft_p50_s": (+1, "ratio"),
    "serve_ttft_p99_s": (+1, "ratio"),
    "serve_e2e_p50_s": (+1, "ratio"),
    "serve_e2e_p99_s": (+1, "ratio"),
    "serve_decode_tokens_per_sec": (-1, "ratio"),
    "serve_preemptions": (+1, "count"),
    # speculative serving: LOWER acceptance is worse (a draft/target
    # drift or a broken verify path shows up here first); ratio kind so
    # the zero-baseline worsening rule applies like any other ratio
    "serve_acceptance_rate": (-1, "ratio"),
    # prefix caching: LOWER hit rate is worse (a broken chain hash, an
    # over-eager eviction, or a trace drifting off its template all
    # show up as the cache silently going cold — TTFT follows)
    "serve_cache_hit_rate": (-1, "ratio"),
    # paged KV read traffic: MORE bytes per decode step is worse (a
    # bucket-ladder regression, an fp pool where int8 was configured,
    # or a widened verify window all show up here before tokens/sec
    # moves on hardware with bandwidth to spare)
    "serve_kv_bytes_read_per_step": (+1, "ratio"),
    # lifecycle attribution: tail queue wait and the
    # preempted-time share of total request latency, both worse UP —
    # an admission-policy or pool-sizing regression shows up in THESE
    # before the aggregate e2e percentiles move (and the zero-baseline
    # rule matters here: a healthy run preempts nothing, so
    # preempted_time_frac regressing from 0.0 must flag even though
    # the percentage is undefined)
    "serve_queue_wait_p99_s": (+1, "ratio"),
    "serve_preempted_time_frac": (+1, "ratio"),
    # host-overhead share of total request latency: the
    # dispatch-ahead loop exists to shrink this, so it regressing UP
    # is the first sign the overlap broke (a new sync point on the
    # hot path, a flush storm) — and the shared zero-baseline rule
    # applies: a fully-hidden-overhead run worsening from 0.0 must
    # flag even though the percentage is undefined
    "serve_overhead_time_frac": (+1, "ratio"),
    # tensor-parallel serving: the KV pool's PER-DEVICE
    # byte footprint, worse UP — a lost heads-sharding (pools silently
    # replicated), a dropped tp knob, or an fp pool where int8 was
    # configured all show up as per-chip pool bytes growing for the
    # same capacity, before any OOM does. Bytes metric like
    # serve_kv_bytes_read_per_step; the shared zero-baseline rule
    # applies (a 0-byte baseline only happens on unsized pools, and
    # bytes appearing against it must still flag).
    "serve_kv_pool_bytes_per_device": (+1, "ratio"),
    # multi-replica serving: max/mean requests served per
    # replica, worse UP — a broken placement policy (every request
    # pinned to one replica), an affinity index starving load balance,
    # or a drained replica nobody restarted all show up as imbalance
    # long before aggregate throughput or the tail percentiles move.
    # Ratio metric under the shared zero-baseline rule (a 0 baseline
    # only happens on degenerate reports, and imbalance appearing
    # against it must still flag).
    "serve_replica_load_imbalance": (+1, "ratio"),
    # open-loop goodput: SLO attainment, worse DOWN — the
    # DistServe headline figure, and the one every capacity decision
    # reads; ratio kind under the shared zero-baseline rule (a 0.0
    # baseline is a fully-missing run, and attainment moving off it is
    # an improvement in the better direction — only drops flag).
    "serve_slo_attainment": (-1, "ratio"),
    # peak count of arrived-but-unadmitted requests across the run,
    # worse UP — the queueing-collapse early-warning: backlog grows
    # before attainment falls. Count kind: ANY increase regresses (a
    # deterministic virtual-clock replay holds this integer exactly).
    "serve_arrival_backlog_peak": (+1, "count"),
    # host-RAM KV spill tier: total bytes the swap path
    # moved, worse UP — a broken auto estimate (swapping short contexts
    # recompute would beat), a policy pin to `always` nobody meant, or
    # a working set outgrowing the pool all show up as swap traffic
    # growing before the latency percentiles move. Ratio kind under the
    # shared zero-baseline rule: the healthy baseline swaps NOTHING, so
    # bytes appearing against 0 must flag even though the percentage is
    # undefined.
    "serve_swap_bytes": (+1, "ratio"),
    # demote-tier hit rate, worse DOWN — the host tier exists to make
    # evicted templates revivable, so the rate going cold (a broken
    # chain re-verify, payloads evicted by a shrunk budget, a thrashing
    # working set) is the first sign the RAM-sized prefix cache stopped
    # paying; ratio kind like serve_cache_hit_rate (only drops flag).
    "serve_host_tier_hit_rate": (-1, "ratio"),
    # cross-engine transport: total bytes migrations moved
    # between engines, worse UP — a harvest loop thrashing (migrating
    # work that could have stayed put), a drain migrating residents a
    # requeue would have served, or a placement policy ping-ponging a
    # request all show up as transport traffic growing before the
    # latency percentiles move. Ratio kind under the shared
    # zero-baseline rule: the healthy mixed-fleet baseline migrates
    # NOTHING, so bytes appearing against 0 must flag even though the
    # percentage is undefined.
    "serve_migration_bytes": (+1, "ratio"),
    # disaggregated-fleet SLO attainment, worse DOWN — the headline
    # figure for a prefill/decode split fleet: if role separation stops
    # paying (handoff stalls, a starved decode side, migration overhead
    # eating the TTFT win) this drops before any per-role percentile
    # is obviously wrong; ratio kind like serve_slo_attainment (only
    # drops flag; a 0.0 baseline is a fully-missing run).
    "serve_disagg_slo_attainment": (-1, "ratio"),
    # fleet tracing: stitch failures, worse UP — a healthy
    # fleet stitches EVERY traced request into one complete causal
    # chain, so any count here means an engine dropped a hop's
    # evidence (torn event tail, a finish racing a migrate, a stamp
    # regression in the propagation path). Count kind: the baseline is
    # exactly zero and ANY appearance is a correctness regression, not
    # a percentage move.
    "serve_trace_stitch_failures": (+1, "count"),
    # per-hop transport latency p99, worse UP — the stitched view of
    # what ONE migration hop costs end to end (extract + wire + restore
    # + destination admission). Growth here flags transport regressions
    # (a serialization slowdown, a saturated restore path) before the
    # fleet TTFT percentiles absorb them. Ratio kind under the shared
    # zero-baseline rule.
    "serve_transport_hop_s_p99": (+1, "ratio"),
    # goodput-aware admission: fraction of deadline-carrying
    # requests finishing past their end-to-end deadline, worse UP — the
    # admission policy's headline figure: an ordering regression (a
    # starved class, a broken aging bound, a demand predictor gone
    # stale) grows this before aggregate attainment visibly moves.
    # Ratio kind under the shared zero-baseline rule: the healthy
    # baseline misses NOTHING, so misses appearing against 0.0 must
    # flag even though the percentage is undefined.
    "serve_deadline_miss_frac": (+1, "ratio"),
}


def _report_scalars(report: dict) -> dict:
    """Flatten one report to the comparable scalar surface ``diff``
    operates on (cross-host means for distributions, sums for counters;
    None where a report has no data for a metric)."""
    hosts = [h for h in report.get("hosts", {}).values()
             if isinstance(h, dict)]

    def host_mean(field: str, sub: str):
        vals = [h[field][sub] for h in hosts
                if isinstance(h.get(field), dict)
                and isinstance(h[field].get(sub), (int, float))]
        return round(sum(vals) / len(vals), 6) if vals else None

    serve = report.get("serve") or {}
    out = {
        "step_time_p50_s": host_mean("step_time_s", "p50"),
        "step_time_p95_s": host_mean("step_time_s", "p95"),
        "mfu_mean": host_mean("mfu", "mean"),
        "compile_count": sum(int(h.get("compile", {}).get("count", 0))
                             for h in hosts) if hosts else None,
        "compile_cum_s": round(sum(
            float(h.get("compile", {}).get("cum_s", 0.0))
            for h in hosts), 6) if hosts else None,
        "anomalies": len(report.get("anomaly_index", [])),
    }
    lint_vals = [h["lint_findings"] for h in hosts
                 if isinstance(h.get("lint_findings"), int)]
    out["lint_findings"] = sum(lint_vals) if lint_vals else None
    for key in ("ttft_p50_s", "ttft_p99_s", "e2e_p50_s", "e2e_p99_s",
                "decode_tokens_per_sec", "preemptions",
                "acceptance_rate", "cache_hit_rate",
                "kv_bytes_read_per_step", "queue_wait_p99_s",
                "preempted_time_frac", "overhead_time_frac",
                "kv_pool_bytes_per_device", "replica_load_imbalance",
                "slo_attainment", "arrival_backlog_peak",
                "swap_bytes", "host_tier_hit_rate",
                "migration_bytes", "disagg_slo_attainment",
                "trace_stitch_failures", "transport_hop_s_p99",
                "deadline_miss_frac"):
        val = serve.get(key)
        out[f"serve_{key}"] = val if isinstance(val, (int, float)) else None
    return out


def diff_reports(a: dict, b: dict, threshold_pct: float = 5.0) -> dict:
    """Deterministic delta document between two run reports (``a`` the
    baseline, ``b`` the candidate). Per metric: both values, the
    absolute delta, the percent change, and whether the metric REGRESSED
    — moved in its worse direction past ``threshold_pct`` (relative),
    or at all for count metrics (anomalies, compiles, preemptions).
    Metrics either side lacks are listed in ``skipped`` instead of
    silently vanishing. Same inputs → byte-identical output (keys
    sorted, no wall-clock stamped)."""
    sa, sb = _report_scalars(a), _report_scalars(b)
    metrics: dict = {}
    regressions: list[str] = []
    skipped: list[str] = []
    for name in sorted(DIFF_METRICS):
        direction, kind = DIFF_METRICS[name]
        va, vb = sa.get(name), sb.get(name)
        if va is None or vb is None:
            skipped.append(name)
            continue
        delta = round(vb - va, 6)
        pct = round(100.0 * delta / va, 3) if va else None
        if kind == "count":
            regressed = direction * delta > 0
        else:
            worse = direction * delta
            # a zero baseline has no percentage but ANY worsening from
            # it is a regression (e.g. compile_cum_s 0.0 under a warm
            # persistent cache -> 120s of recompiles must not pass
            # silently because the ratio is undefined)
            regressed = worse > 0 and (pct is None
                                       or abs(pct) > threshold_pct)
        metrics[name] = {
            "a": va, "b": vb, "delta": delta, "pct": pct,
            "worse_direction": "up" if direction > 0 else "down",
            "regressed": regressed,
        }
        if regressed:
            regressions.append(name)
    return {
        "report_version": REPORT_VERSION,
        "threshold_pct": threshold_pct,
        "metrics": metrics,
        "regressions": regressions,
        "skipped": skipped,
    }


def render_diff_text(diff: dict) -> str:
    """Human-readable rendering of a :func:`diff_reports` document."""
    lines = [f"diff (threshold {diff.get('threshold_pct')}%):"]
    for name, row in sorted(diff.get("metrics", {}).items()):
        pct = f" ({row['pct']:+}%)" if row.get("pct") is not None else ""
        mark = "  <-- REGRESSED" if row.get("regressed") else ""
        lines.append(f"  {name}: {row['a']} -> {row['b']}{pct}{mark}")
    skipped = diff.get("skipped", [])
    if skipped:
        lines.append(f"  skipped (missing in a report): "
                     f"{', '.join(skipped)}")
    regs = diff.get("regressions", [])
    lines.append(f"regressions: {len(regs)}"
                 + (f" ({', '.join(regs)})" if regs else ""))
    return "\n".join(lines) + "\n"


def render_text(report: dict) -> str:
    """Human-readable rendering of a report dict."""
    lines = []
    run = report.get("run", {})
    lines.append(f"run: {run.get('n_hosts', 0)} host(s), "
                 f"{run.get('events', 0)} events")
    if run.get("argv"):
        lines.append(f"  argv: {' '.join(map(str, run['argv']))}")
    for host, sec in sorted(report.get("hosts", {}).items(),
                            key=lambda kv: int(kv[0])):
        lines.append(f"host {host}: {sec['events']} events, "
                     f"{sec['compile']['count']} compiles "
                     f"({sec['compile']['cum_s']}s), "
                     f"{sec['heartbeats']} heartbeats, "
                     f"{sec['stalls']} stalls, "
                     f"{sec['anomalies']} anomalies")
        st = sec.get("step_time_s")
        if st:
            lines.append(f"  step time: p50 {st['p50']}s  p95 {st['p95']}s"
                         f"  max {st['max']}s  ({st['count']} windows)")
        mfu = sec.get("mfu")
        if mfu:
            lines.append(f"  mfu: mean {mfu['mean']}  p50 {mfu['p50']}"
                         f"  max {mfu['max']}")
        mem = sec.get("memory", {})
        if mem.get("peak_bytes_in_use"):
            frac = (f" ({mem['peak_bytes_in_use'] / mem['bytes_limit']:.1%}"
                    " of limit)" if mem.get("bytes_limit") else "")
            lines.append(
                f"  memory peak: {mem['peak_bytes_in_use']} bytes{frac}")
    timeline = report.get("straggler_timeline", [])
    if timeline:
        # mark epochs from the run's OWN straggler anomalies (which
        # applied the configured HSTD_STRAGGLER_ALERT threshold), so
        # the text rendering never disagrees with the anomaly index
        alerted = {a.get("step") for a in report.get("anomaly_index", [])
                   if a.get("name") == "straggler"}
        lines.append("straggler timeline:")
        for row in timeline:
            mark = (" <-- host %s slow" % row["argmax_host"]
                    if row["epoch"] in alerted
                    and row["argmax_host"] is not None else "")
            lines.append(f"  epoch {row['epoch']}: mean {row['mean_s']}s  "
                         f"ratio {row['straggler_ratio']}{mark}")
    anomalies = report.get("anomaly_index", [])
    if anomalies:
        lines.append(f"anomalies ({len(anomalies)}):")
        for a in anomalies:
            step = f" step {a['step']}" if a.get("step") is not None else ""
            lines.append(f"  [host {a['host']}]{step} {a['name']}: "
                         f"{a['message']}")
    else:
        lines.append("anomalies: none")
    serve = report.get("serve")
    if serve:
        parts = [f"{serve.get('requests', 0)} requests"]
        if serve.get("replicas") is not None:
            imb = (f", imbalance {serve['replica_load_imbalance']}"
                   if serve.get("replica_load_imbalance") is not None
                   else "")
            parts.append(f"{serve['replicas']} replicas "
                         f"({serve.get('placement')}{imb})")
        if serve.get("ttft_p50_s") is not None:
            parts.append(f"ttft p50 {serve['ttft_p50_s']}s "
                         f"p99 {serve.get('ttft_p99_s')}s")
        if serve.get("e2e_p50_s") is not None:
            parts.append(f"e2e p50 {serve['e2e_p50_s']}s "
                         f"p99 {serve.get('e2e_p99_s')}s")
        if serve.get("preemptions") is not None:
            parts.append(f"{serve['preemptions']} preemptions")
        if serve.get("gather_read_waste_peak") is not None:
            parts.append("gather waste peak "
                         f"{serve['gather_read_waste_peak']}")
        if serve.get("acceptance_rate") is not None:
            parts.append(f"spec acceptance {serve['acceptance_rate']} "
                         f"(k={serve.get('speculate_k')})")
        if serve.get("cache_hit_rate") is not None:
            parts.append(
                f"prefix-cache hit rate {serve['cache_hit_rate']}"
                + (f" ({serve['blocks_shared_peak']} blocks shared peak)"
                   if serve.get("blocks_shared_peak") is not None else ""))
        lines.append("serve: " + ", ".join(parts))
    errors = report.get("errors", [])
    if errors:
        lines.append(f"schema errors ({len(errors)}):")
        lines.extend(f"  {e}" for e in errors[:20])
        if len(errors) > 20:
            lines.append(f"  ... and {len(errors) - 20} more")
    return "\n".join(lines) + "\n"
