"""Telemetry event schema (the port's copy of the JAX package's
``obs/schema.py``, field for field): the contract every emitter writes
and every consumer (``scripts/check_telemetry_schema.py``,
``scripts/obsctl.py``, Perfetto via ``trace.json``) parses. The port's
event files must stay readable by those scripts, so the schema does not
fork: ``tests/test_torch_obs.py`` holds the two tables equal.

Stdlib only. One event = one JSON object on one line of
``events.jsonl``. Envelope fields present on EVERY event:

    v     int    schema version (SCHEMA_VERSION)
    t     float  unix wall-clock seconds at emission
    host  int    process index (rank); 0 on single-process runs
    pid   int    OS process id
    type  str    one of EVENT_TYPES

Per-type required fields are in ``REQUIRED_FIELDS``; extra fields are
always allowed (forward compatibility), missing required fields are a
schema error. ``trace.json`` is the Chrome-trace-viewer projection of
the span events: ``{"traceEvents": [{"name", "ph": "X", "ts", "dur",
"pid", "tid"}, ...]}`` with timestamps in microseconds.
"""

from __future__ import annotations

import json
from typing import Iterator, Optional

SCHEMA_VERSION = 1

_NUM = (int, float)

# type name -> {field: allowed python types}
REQUIRED_FIELDS: dict[str, dict[str, tuple]] = {
    # a completed wall-time span; "mono" is the monotonic start time so
    # spans order/nest without wall-clock steps
    "span": {"name": (str,), "dur": _NUM, "mono": _NUM, "tid": (int,)},
    # one scalar sample of a named series (loss, lr, samples/sec, ...)
    "metric": {"name": (str,), "value": _NUM + (type(None),)},
    # liveness: emitted every HSTD_HEARTBEAT_SECS by the heartbeat thread
    "heartbeat": {"uptime": _NUM, "progress": (int,), "progress_age": _NUM},
    # the heartbeat's stall dump: all thread stacks at the moment the
    # watched thread stopped pulsing
    "stall": {"progress_age": _NUM, "stalled": (str,), "threads": (list,)},
    # one compilation, from the JAX package's compile tracker (the port
    # has no compile tracker yet and emits none)
    "compile": {"event": (str,), "dur": _NUM, "count": (int,), "cum": _NUM},
    # one device memory sample (the port's: torch.cuda's counters; never
    # emitted on CPU)
    "memory": {"device": (str,), "stats": (dict,)},
    # one controller decision from the input-pipeline autotuners
    # (data/autotune.py prefetch depth; data/streaming.py read-coalesce
    # gap): "name" is the tuned knob, "depth" its new integer value,
    # "reason" the trigger (input_bound / compute_bound / mem_cap /
    # waste_high / waste_low)
    "autotune": {"name": (str,), "depth": (int,), "reason": (str,)},
    # a budget/threshold warning (e.g. compile_budget when cumulative XLA
    # compile seconds exceed HSTD_COMPILE_BUDGET_S); mirrored to stderr
    "alert": {"name": (str,), "message": (str,)},
    # one anomaly-detector trigger (obs/anomaly.py): "name" is the kind
    # (nan_loss / nan_grad / grad_explosion / step_time_spike /
    # straggler / heartbeat_stall), "message" the human-readable
    # diagnosis; extras ride along ("step", "evidence" = the flight
    # dump path, "profile_dir" = the profiler capture, kind-specific
    # numbers). Rate-limited at the source — one per incident, not per
    # observation
    "anomaly": {"name": (str,), "message": (str,)},
    # one serving-engine lifecycle event (serve/engine.py): "event" is
    # submit / admit / first_token / finish / preempt / bucket_switch /
    # report; per-request events also carry an integer "request" id,
    # first_token / finish carry the latency/accounting extras
    # (ttft_s, tokens), submit carries "sampled" and bucket_switch
    # carries "gather_bucket" (typed below when present)
    "serve": {"event": (str,)},
    # run metadata, first event after configure()
    "run": {"argv": (list,)},
}

# optional per-type fields that are TYPE-CHECKED when present (absence
# is fine — they ride specific event subtypes): the serving engine's and
# router's per-request, per-iteration and report riders
OPTIONAL_FIELDS: dict[str, dict[str, tuple]] = {
    "serve": {"gather_bucket": (int,), "sampled": (bool,),
              "request": (int,), "speculate_k": (int,),
              "max_new_tokens": (int,),
              "slot": (int,),
              "queue_depth": (int,),
              "reason": (str,),
              "prev_bucket": (int,),
              "max_context": (int,),
              "draft_proposed": (int,), "draft_accepted": (int,),
              "acceptance_rate": _NUM,
              "verify_read_waste_peak": _NUM,
              "verify_read_waste_mean": _NUM,
              "prefix_cache": (bool,),
              "prefix_cached_tokens": (int,),
              "cache_hit_rate": _NUM,
              "blocks_shared_peak": (int,),
              "blocks_saved_peak": (int,),
              "cow_copies": (int,),
              "prefix_evictions": (int,),
              "shared_read_frac": _NUM,
              "kernel": (str,),
              "kv_dtype": (str,),
              "kv_bytes_read": (int,),
              "kv_bytes_read_per_step": _NUM,
              "overlap": (bool,),
              "overlap_flushes": (int,),
              "tp": (int,),
              "kv_pool_bytes_per_device": (int,),
              "replica": (int,),
              "replicas": (int,),
              "placement": (str,),
              "requeued": (int,),
              "to_replica": (int,),
              "drains": (int,),
              "requeues": (int,),
              "replica_load_imbalance": _NUM,
              "affinity_fallbacks": (int,),
              "per_replica": (list,),
              "at": (str,),
              "group": (str,),
              "e2e_s": _NUM,
              "ttft_s": _NUM,
              "queue_s": _NUM,
              "prefill_s": _NUM,
              "decode_s": _NUM,
              "preempted_s": _NUM,
              "overhead_s": _NUM,
              "segments": (list,),
              "tokens": (int,),
              "prompt_len": (int,),
              "preemptions": (int,),
              "blocked_iters": (int,),
              "blocked_reason": (str,),
              "iteration": (int,),
              "dur_s": _NUM,
              "prefill_chunks": (int,),
              "prefill_dispatches": (int,),
              "decode_slots": (int,),
              "waiting": (int,),
              "kv_used_frac": _NUM,
              "queue_wait_p50_s": _NUM,
              "queue_wait_p99_s": _NUM,
              "queue_time_frac": _NUM,
              "prefill_time_frac": _NUM,
              "decode_time_frac": _NUM,
              "preempted_time_frac": _NUM,
              "overhead_time_frac": _NUM,
              "arrival_s": _NUM,
              "slo_ttft_s": _NUM,
              "slo_tpot_s": _NUM,
              "slo_met": (bool,),
              "ttft_slo_met": (bool,),
              "tpot_slo_met": (bool,),
              "slack_s": _NUM,
              "slo_attainment": _NUM,
              "group_slo_attainment": (dict,),
              "arrival_backlog": (int,),
              "arrival_backlog_peak": (int,),
              "process": (str,),
              "rate": _NUM,
              "clock": (str,),
              "requests": (int,),
              "swap_policy": (str,),
              "swap_outs": (int,),
              "swap_ins": (int,),
              "swap_bytes": (int,),
              "restore_s": _NUM,
              "recompute_tokens_avoided": (int,),
              "host_tier_hits": (int,),
              "host_tier_hit_rate": _NUM,
              "from_replica": (int,),
              "migration_bytes": (int,),
              "migrated": (int,),
              "residents_in_place": (int,),
              "migrations": (int,),
              "migrations_in": (int,),
              "migrations_out": (int,),
              "migration_restore_s": _NUM,
              "roles": (str,),
              "role": (str,),
              "per_role": (dict,),
              "disagg_slo_attainment": _NUM,
              "trace_id": (str,),
              "hop": (int,),
              "extract_s": _NUM,
              "transport_hop_s": _NUM,
              "transport_hop_s_p99": _NUM,
              "traces": (int,),
              "complete_traces": (int,),
              "trace_stitch_failures": (int,),
              "policy": (str,),
              "deadline_s": _NUM,
              "priority": (int,),
              "deadline_miss": (bool,),
              "rate_limited": (int,),
              "retry_after_s": _NUM,
              "aging_promotions": (int,),
              "deadline_miss_frac": _NUM,
              "priority_slo_attainment": (dict,)},
}

# The serve-event vocabulary: every "event" value a serve event may
# carry (kept a pure literal, as the JAX package's static checks read it).
SERVE_EVENTS = (
    "submit", "admit", "first_token", "finish", "preempt",
    "bucket_switch", "report", "request_timeline", "iteration_ledger",
    "open_loop", "swap_out", "swap_in", "migrate", "drain", "requeue",
    "restart", "trace_stitch", "rate_limited",
)

EVENT_TYPES = tuple(REQUIRED_FIELDS)

ENVELOPE_FIELDS: dict[str, tuple] = {
    "v": (int,),
    "t": _NUM,
    "host": (int,),
    "pid": (int,),
    "type": (str,),
}


def validate_event(obj: object) -> list[str]:
    """Schema errors for one decoded event (empty list = valid)."""
    if not isinstance(obj, dict):
        return [f"event is {type(obj).__name__}, not an object"]
    errors = []
    for field, types in ENVELOPE_FIELDS.items():
        if field not in obj:
            errors.append(f"missing envelope field {field!r}")
        elif not isinstance(obj[field], types) or isinstance(obj[field], bool):
            errors.append(f"envelope field {field!r} has type "
                          f"{type(obj[field]).__name__}")
    etype = obj.get("type")
    if isinstance(etype, str):
        required = REQUIRED_FIELDS.get(etype)
        if required is None:
            errors.append(f"unknown event type {etype!r} "
                          f"(known: {', '.join(EVENT_TYPES)})")
        else:
            for field, types in required.items():
                if field not in obj:
                    errors.append(f"{etype}: missing field {field!r}")
                elif (not isinstance(obj[field], types)
                      or (isinstance(obj[field], bool)
                          and bool not in types)):
                    errors.append(f"{etype}: field {field!r} has type "
                                  f"{type(obj[field]).__name__}")
            for field, types in OPTIONAL_FIELDS.get(etype, {}).items():
                val = obj.get(field)
                if val is None:
                    continue
                if (not isinstance(val, types)
                        or (isinstance(val, bool) and bool not in types)):
                    errors.append(f"{etype}: optional field {field!r} "
                                  f"has type {type(val).__name__}")
    if obj.get("v") not in (None, SCHEMA_VERSION):
        errors.append(f"schema version {obj.get('v')!r} != {SCHEMA_VERSION}")
    return errors


def iter_events(path: str, strict_tail: bool = False) -> Iterator[tuple[int, Optional[dict], Optional[str]]]:
    """Yield ``(lineno, event_or_None, error_or_None)`` per line.

    Crash tolerance: a process killed mid-write leaves at most one torn
    FINAL line, which is skipped silently (unless ``strict_tail``); a
    torn line anywhere else means corruption and is reported.
    """
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            yield i + 1, json.loads(line), None
        except ValueError:
            if i == len(lines) - 1 and not strict_tail:
                continue  # torn tail from a mid-write kill: expected
            yield i + 1, None, "unparseable JSON"


def validate_events_file(path: str, strict_tail: bool = False) -> tuple[int, list[str]]:
    """(valid_event_count, error messages) for an events.jsonl file."""
    count = 0
    errors: list[str] = []
    for lineno, obj, err in iter_events(path, strict_tail=strict_tail):
        if err is not None:
            errors.append(f"{path}:{lineno}: {err}")
            continue
        errs = validate_event(obj)
        if errs:
            errors.extend(f"{path}:{lineno}: {e}" for e in errs)
        else:
            count += 1
    return count, errors


def validate_trace_file(path: str) -> tuple[int, list[str]]:
    """(event_count, error messages) for a Chrome-trace trace.json."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except ValueError as e:
        return 0, [f"{path}: unparseable JSON ({e})"]
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        return 0, [f"{path}: expected a traceEvents list"]
    errors = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"{path}: traceEvents[{i}] is not an object")
            continue
        for field, types in (("name", (str,)), ("ph", (str,)),
                             ("ts", _NUM), ("pid", (int,)), ("tid", (int,))):
            if not isinstance(ev.get(field), types):
                errors.append(f"{path}: traceEvents[{i}] bad {field!r}")
        if ev.get("ph") == "X" and not isinstance(ev.get("dur"), _NUM):
            errors.append(f"{path}: traceEvents[{i}] complete event "
                          "without numeric 'dur'")
    return len(events), errors
