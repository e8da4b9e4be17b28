"""``python -m huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs``:
operate on the port's telemetry from outside the run (the counterpart of
the JAX package's ``scripts/obsctl.py``, with its subcommands, flags,
outputs and exit codes).

Usage::

    # one merged, deterministic run report (JSON on stdout)
    python -m huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs report telemetry/
    # several per-host dirs -> one report; readable rendering; save JSON
    ... obs report host0/ host1/ --text -o report.json
    # schema-lint events/trace/flight artifacts
    ... obs validate telemetry/
    # regression triage between two saved reports; exit 2 when a metric
    # moves past the threshold in its worse direction
    ... obs diff baseline.json candidate.json --threshold-pct 5
    # per-request Gantt rows, plus a Chrome-trace export
    ... obs timeline telemetry/ --trace serve_trace.json
    # SLO attribution: which phase the tail requests burned their budget in
    ... obs slo telemetry/ --percentile 99 --text
    # one stitched cross-engine trace, and the fleet rollup
    ... obs trace t000002 telemetry/
    ... obs fleet telemetry/ --trace fleet_trace.json
    # follow a live events.jsonl over a sliding window
    ... obs tail telemetry/events.jsonl --window 64
    # open-loop goodput replay; exit 2 below the attainment floor
    ... obs goodput telemetry/ --min-attainment 0.99

Every module behind these commands imports nothing outside the standard
library, so they run on a box with neither torch nor jax. ``lint`` (the JAX
package's static analysis) is not ported: it exits 1 naming its ROADMAP
item.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.report import (
    build_report,
    diff_reports,
    find_event_files,
    render_diff_text,
    render_text,
    validate_report,
)

PROG = "python -m huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs"


def _errors_out(errors: list) -> None:
    for e in errors[:20]:
        print(f"obsctl: {e}", file=sys.stderr)
    if len(errors) > 20:
        print(f"obsctl: ... and {len(errors) - 20} more", file=sys.stderr)


def cmd_report(args: argparse.Namespace) -> int:
    """The merged report, validated before it is printed (rc 1 when it
    does not pass or no event file is found)."""
    if not find_event_files(args.paths):
        print(f"obsctl: no events.jsonl under {', '.join(args.paths)}",
              file=sys.stderr)
        return 1
    report = build_report(args.paths)
    problems = validate_report(report)
    if problems:
        for p in problems:
            print(f"obsctl: invalid report: {p}", file=sys.stderr)
        return 1
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"obsctl: wrote {args.out}", file=sys.stderr)
    if args.text:
        sys.stdout.write(render_text(report))
    else:
        json.dump(report, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    return 0


def cmd_diff(args: argparse.Namespace) -> int:
    """Delta two saved reports: rc 0 no regression, 1 unreadable or
    invalid input, 2 a metric regressed past the threshold."""
    reports = []
    for path in (args.a, args.b):
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"obsctl: cannot read report {path}: {e}", file=sys.stderr)
            return 1
        problems = validate_report(doc)
        if problems:
            for p in problems:
                print(f"obsctl: invalid report {path}: {p}", file=sys.stderr)
            return 1
        reports.append(doc)
    diff = diff_reports(reports[0], reports[1], threshold_pct=args.threshold_pct)
    if args.text:
        sys.stdout.write(render_diff_text(diff))
    else:
        json.dump(diff, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    if diff["regressions"]:
        print(f"obsctl: {len(diff['regressions'])} regression(s): "
              f"{', '.join(diff['regressions'])}", file=sys.stderr)
        return 2
    return 0


def _expand(paths: list) -> list:
    """Files to lint: a directory gives its ``events.jsonl``,
    ``trace.json``, ``events.host*.jsonl`` and ``flight_*.jsonl`` (or a
    missing ``events.jsonl`` to report)."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            found = [os.path.join(p, n) for n in sorted(os.listdir(p))
                     if n in ("events.jsonl", "trace.json")
                     or (n.endswith(".jsonl")
                         and n.startswith(("events.host", "flight_")))]
            if not found:
                out.append(os.path.join(p, "events.jsonl"))
            out.extend(found)
        else:
            out.append(p)
    return out


def cmd_validate(args: argparse.Namespace) -> int:
    """Schema-lint every artifact: rc 0 when every file parses, every
    event is valid and no file is empty (a torn final line is
    tolerated)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.schema import (
        validate_events_file,
        validate_trace_file,
    )

    failed = False
    for path in _expand(args.paths):
        if not os.path.exists(path):
            print(f"FAIL {path}: missing")
            failed = True
            continue
        if path.endswith(".jsonl"):
            count, errors = validate_events_file(path)
            kind = "events"
        else:
            count, errors = validate_trace_file(path)
            kind = "trace events"
        if count == 0 and not errors:
            errors = ["no valid events (empty artifact)"]
        if errors:
            failed = True
            print(f"FAIL {path}: {count} valid {kind}, {len(errors)} error(s)")
            for e in errors[:20]:
                print(f"  {e}")
            if len(errors) > 20:
                print(f"  ... and {len(errors) - 20} more")
        else:
            print(f"OK   {path}: {count} valid {kind}")
    return 1 if failed else 0


def _load_timelines(paths) -> "tuple[list[dict], int]":
    """(records, rc): the strictly loaded, folded ``request_timeline``
    records; rc 1 on malformed or inconsistent input."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.timeline import (
        check_decomposition,
        collect_timelines,
        load_events,
    )

    events, errors = load_events(paths)
    if errors:
        _errors_out(errors)
        return [], 1
    records = collect_timelines(events)
    problems = [m for rec in records for m in check_decomposition(rec)]
    if problems:
        for p in problems[:20]:
            print(f"obsctl: inconsistent timeline: {p}", file=sys.stderr)
        return [], 1
    return records, 0


def cmd_timeline(args: argparse.Namespace) -> int:
    """Per-request Gantt rows and the Chrome-trace export; rc 1 on
    malformed input or no ``request_timeline`` event."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.timeline import (
        gantt_text,
        write_chrome_trace,
    )

    if args.width < 4:
        print(f"obsctl: --width must be >= 4, got {args.width}", file=sys.stderr)
        return 1
    records, rc = _load_timelines(args.paths)
    if rc:
        return rc
    if not records:
        print("obsctl: no request_timeline events (serve run with "
              "HSTD_SERVE_TIMELINE=off, or not a serve run?)", file=sys.stderr)
        return 1
    if args.trace:
        write_chrome_trace(records, args.trace)
        print(f"obsctl: wrote {args.trace}", file=sys.stderr)
    if args.json:
        json.dump(records, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(gantt_text(records, width=args.width))
    return 0


def cmd_slo(args: argparse.Namespace) -> int:
    """SLO attribution of the latency tail, per group."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.timeline import (
        render_slo_text,
        slo_attribution,
    )

    if not 0 < args.percentile <= 100:
        print(f"obsctl: --percentile must be in (0, 100], got {args.percentile}",
              file=sys.stderr)
        return 1
    records, rc = _load_timelines(args.paths)
    if rc:
        return rc
    if not records:
        print("obsctl: no request_timeline events to attribute", file=sys.stderr)
        return 1
    doc = slo_attribution(records, pct=args.percentile / 100.0)
    if args.text:
        sys.stdout.write(render_slo_text(doc))
    else:
        json.dump(doc, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    return 0


def cmd_lint(args: argparse.Namespace) -> int:
    raise NotImplementedError(
        "lint (the JAX package's analysis/) is not ported to the PyTorch "
        "package yet: ROADMAP queue 1, item 12")


def cmd_goodput(args: argparse.Namespace) -> int:
    """Open-loop goodput replay per run and per swept rate, with the
    capacity knee; rc 1 on malformed or closed-loop input, rc 2 when the
    overall attainment is below ``--min-attainment``."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.goodput import (
        goodput,
        render_goodput_text,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.timeline import (
        load_events,
    )

    if not 0 < args.knee_target <= 1:
        print(f"obsctl: --knee-target must be in (0, 1], got {args.knee_target}",
              file=sys.stderr)
        return 1
    if args.min_attainment is not None and not 0 <= args.min_attainment <= 1:
        print(f"obsctl: --min-attainment must be in [0, 1], got {args.min_attainment}",
              file=sys.stderr)
        return 1
    events, errors = load_events(args.paths)
    if errors:
        _errors_out(errors)
        return 1
    doc = goodput(events, knee_target=args.knee_target)
    if not doc.get("runs"):
        print("obsctl: no open_loop events (closed-loop trace, or not "
              "a serve run?)", file=sys.stderr)
        return 1
    if args.text:
        sys.stdout.write(render_goodput_text(doc))
    else:
        json.dump(doc, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    attainment = doc.get("overall_attainment")
    if args.min_attainment is not None:
        if attainment is None:
            print("obsctl: --min-attainment set but no run carried SLO verdicts",
                  file=sys.stderr)
            return 1
        if attainment < args.min_attainment:
            print(f"obsctl: attainment {attainment} below the "
                  f"--min-attainment floor {args.min_attainment}", file=sys.stderr)
            return 2
    return 0


def _load_traces(paths) -> "tuple[list[dict], int]":
    """(stitched traces, rc): strictly loaded and stitched."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.timeline import (
        load_events,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.trace import (
        collect_traces,
    )

    events, errors = load_events(paths)
    if errors:
        _errors_out(errors)
        return [], 1
    return collect_traces(events), 0


def cmd_trace(args: argparse.Namespace) -> int:
    """One stitched trace (by trace id or request id) as a narrative; rc 1
    on malformed input, an unknown id, an incomplete trace (still
    rendered) or a decomposition error."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.trace import (
        check_trace,
        trace_text,
    )

    traces, rc = _load_traces(args.paths)
    if rc:
        return rc
    if not traces:
        print("obsctl: no traced serve events (single-replica run, or "
              "HSTD_SERVE_TRACE=off?)", file=sys.stderr)
        return 1
    want = str(args.id)
    sel = [t for t in traces if t["trace_id"] == want or str(t.get("request")) == want]
    if not sel:
        known = ", ".join(t["trace_id"] for t in traces[:8])
        print(f"obsctl: no trace {want!r} (known: {known}"
              f"{', ...' if len(traces) > 8 else ''})", file=sys.stderr)
        return 1
    bad = 0
    for tr in sel:
        sys.stdout.write(trace_text(tr))
        if not tr["complete"] or check_trace(tr):
            bad += 1
    return 1 if bad else 0


def cmd_fleet(args: argparse.Namespace) -> int:
    """The fleet rollup over every stitched trace, with the multi-track
    Chrome export behind ``--trace``; incomplete traces are flagged (rc
    0), a decomposition error on a complete one gives rc 1."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.trace import (
        check_trace,
        fleet_chrome_trace,
        fleet_summary,
        fleet_text,
    )

    traces, rc = _load_traces(args.paths)
    if rc:
        return rc
    if not traces:
        print("obsctl: no traced serve events (single-replica run, or "
              "HSTD_SERVE_TRACE=off?)", file=sys.stderr)
        return 1
    problems = [m for tr in traces for m in check_trace(tr)]
    if problems:
        for p in problems[:20]:
            print(f"obsctl: inconsistent trace: {p}", file=sys.stderr)
        return 1
    if args.trace:
        with open(args.trace, "w", encoding="utf-8") as f:
            json.dump(fleet_chrome_trace(traces), f, sort_keys=True)
            f.write("\n")
        print(f"obsctl: wrote {args.trace}", file=sys.stderr)
    if args.json:
        json.dump(fleet_summary(traces), sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(fleet_text(traces))
    return 0


def cmd_tail(args: argparse.Namespace) -> int:
    """Follow a live events.jsonl, one line a poll that saw new events;
    exits after ``--updates`` lines (0: never), rc 1 on a malformed
    complete line."""
    import time

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.timeline import (
        TailFollower,
        TailStats,
    )

    if args.window < 1:
        print(f"obsctl: --window must be >= 1, got {args.window}", file=sys.stderr)
        return 1
    if args.interval < 0:
        print(f"obsctl: --interval must be >= 0, got {args.interval}", file=sys.stderr)
        return 1
    if not os.path.isfile(args.path):
        print(f"obsctl: no such file {args.path}", file=sys.stderr)
        return 1
    follower = TailFollower(args.path)
    stats = TailStats(window=args.window)
    updates = 0
    try:
        while True:
            events, errors = follower.poll()
            if errors:
                for e in errors[:20]:
                    print(f"obsctl: {e}", file=sys.stderr)
                return 1
            if events:
                for e in events:
                    stats.update(e)
                print(stats.render(), flush=True)
                updates += 1
                if args.updates and updates >= args.updates:
                    return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog=PROG, description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    rep = sub.add_parser("report", help="merge per-host telemetry into one run report")
    rep.add_argument("paths", nargs="+",
                     help="telemetry dir(s), per-host dirs, or event files")
    rep.add_argument("--text", action="store_true", help="readable rendering instead of JSON")
    rep.add_argument("-o", "--out", default=None, help="also write the JSON report to this path")
    rep.set_defaults(func=cmd_report)

    dif = sub.add_parser("diff", help="step-time/MFU/anomaly/serve-SLO deltas between two "
                                      "saved reports (exit 2 over the threshold)")
    dif.add_argument("a", help="baseline report JSON (report -o)")
    dif.add_argument("b", help="candidate report JSON")
    dif.add_argument("--threshold-pct", type=float, default=5.0,
                     help="relative worsening that counts as a regression for ratio "
                          "metrics (default 5)")
    dif.add_argument("--text", action="store_true", help="readable rendering instead of JSON")
    dif.set_defaults(func=cmd_diff)

    val = sub.add_parser("validate", help="schema-lint telemetry artifacts")
    val.add_argument("paths", nargs="+")
    val.set_defaults(func=cmd_validate)

    tim = sub.add_parser("timeline", help="per-request lifecycle Gantt rows + Chrome-trace "
                                          "export from request_timeline events")
    tim.add_argument("paths", nargs="+", help="telemetry dir(s) or event files")
    tim.add_argument("--trace", default=None,
                     help="also write a Chrome-trace JSON here (Perfetto / chrome://tracing)")
    tim.add_argument("--json", action="store_true",
                     help="raw timeline records as JSON instead of the Gantt rendering")
    tim.add_argument("--width", type=int, default=48,
                     help="Gantt row width in cells (default 48)")
    tim.set_defaults(func=cmd_timeline)

    slo = sub.add_parser("slo", help="SLO attribution: which phase the latency tail burned "
                                     "its budget in, per request group")
    slo.add_argument("paths", nargs="+", help="telemetry dir(s) or event files")
    slo.add_argument("--percentile", type=float, default=99.0,
                     help="tail threshold percentile (default 99)")
    slo.add_argument("--text", action="store_true", help="readable rendering instead of JSON")
    slo.set_defaults(func=cmd_slo)

    trc = sub.add_parser("trace", help="one stitched cross-engine request trace as a causal "
                                       "narrative (by trace_id or request id)")
    trc.add_argument("id", help="trace_id (t000002) or request id")
    trc.add_argument("paths", nargs="+", help="telemetry dir(s) or event files")
    trc.set_defaults(func=cmd_trace)

    flt = sub.add_parser("fleet", help="fleet SLO-attribution rollup over stitched traces "
                                       "+ merged multi-track Chrome export (--trace)")
    flt.add_argument("paths", nargs="+", help="telemetry dir(s) or event files")
    flt.add_argument("--trace", default=None,
                     help="write the merged multi-track Chrome-trace JSON here (one pid "
                          "per replica, transport flow arrows)")
    flt.add_argument("--json", action="store_true",
                     help="raw fleet summary as JSON instead of the table rendering")
    flt.set_defaults(func=cmd_fleet)

    good = sub.add_parser("goodput", help="open-loop goodput replay: SLO attainment per "
                                          "arrival rate/tenant, miss attribution, capacity "
                                          "knee (exit 2 below --min-attainment)")
    good.add_argument("paths", nargs="+", help="telemetry dir(s) or event files")
    good.add_argument("--min-attainment", type=float, default=None,
                      help="exit 2 when overall attainment falls below this fraction")
    good.add_argument("--knee-target", type=float, default=0.99,
                      help="attainment below this marks the capacity knee in a rate "
                           "sweep (default 0.99)")
    good.add_argument("--text", action="store_true", help="readable rendering instead of JSON")
    good.set_defaults(func=cmd_goodput)

    tail = sub.add_parser("tail", help="follow a live events.jsonl: rolling waiting-depth/"
                                       "KV-pressure/tokens-per-sec/TTFT over a sliding "
                                       "window")
    tail.add_argument("path", help="an events.jsonl being appended to")
    tail.add_argument("--window", type=int, default=64,
                      help="sliding-window sample count (default 64)")
    tail.add_argument("--interval", type=float, default=0.5,
                      help="poll interval seconds (default 0.5)")
    tail.add_argument("--updates", type=int, default=0,
                      help="exit after N update lines (0 = follow forever)")
    tail.set_defaults(func=cmd_tail)

    lint = sub.add_parser("lint", help="static analysis (not ported: ROADMAP queue 1, "
                                       "item 12)")
    lint.add_argument("paths", nargs="*")
    lint.add_argument("--format", choices=("text", "json"), default="text")
    lint.add_argument("--rules", default=None)
    lint.set_defaults(func=cmd_lint)
    return parser


def main(argv: list | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.func(args)
    except NotImplementedError as e:
        print(f"obsctl: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
