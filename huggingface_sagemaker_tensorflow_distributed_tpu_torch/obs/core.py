"""Telemetry core (counterpart of the JAX package's ``obs/core.py``): the
process-wide state, the crash-safe JSONL event log, the span tracer and
the scalar metrics sink, under the same environment contract and the
same file names.

- ``HSTD_TELEMETRY=0`` turns everything off: every public entry point
  returns early on a cached bool, and a disabled ``span()`` is one
  shared no-op context manager.
- ``HSTD_TELEMETRY_DIR=<dir>`` writes ``<dir>/events.jsonl`` (appended
  and flushed line by line, so a killed process tears at most its last
  line; fsync every ``_FSYNC_EVERY`` lines) and ``<dir>/trace.json`` (the
  Chrome-trace projection of the spans, replaced atomically). Without a
  directory spans and metrics are no-ops and nothing accumulates.
- The rank comes from ``TPU_PROCESS_ID`` or ``RANK`` until
  ``parallel.distributed.initialize_distributed`` reports it through
  ``set_host``. Rank 0 owns the files; ``HSTD_TELEMETRY_ALL_HOSTS=1``
  gives every rank its own ``events.host<K>.jsonl``.

Stdlib only: the sink opens no device and imports no torch.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Optional

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.flight import (
    FlightRecorder,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.schema import (
    SCHEMA_VERSION,
)

ENV_ENABLE = "HSTD_TELEMETRY"
ENV_DIR = "HSTD_TELEMETRY_DIR"
ENV_HEARTBEAT = "HSTD_HEARTBEAT_SECS"
ENV_ALL_HOSTS = "HSTD_TELEMETRY_ALL_HOSTS"

_FSYNC_EVERY = 64
_MAX_BUFFERED_SPANS = 200_000


def _env_enabled() -> bool:
    return os.environ.get(ENV_ENABLE, "1").strip().lower() not in (
        "0", "false", "off", "no")


def _all_hosts_env() -> bool:
    return os.environ.get(ENV_ALL_HOSTS, "").strip().lower() in (
        "1", "true", "on", "yes")


def _env_rank() -> tuple[int, int]:
    rank = os.environ.get("TPU_PROCESS_ID") or os.environ.get("RANK") or "0"
    count = os.environ.get("TPU_NUM_PROCESSES") or os.environ.get("WORLD_SIZE") or "1"
    return int(rank), int(count)


def event_filename(host: int) -> str:
    """Rank 0 writes ``events.jsonl``; other ranks (under
    ``HSTD_TELEMETRY_ALL_HOSTS``) get their own file, so appends on a
    shared filesystem never interleave."""
    return "events.jsonl" if host == 0 else f"events.host{host}.jsonl"


class EventLog:
    """Append-only JSONL writer with the envelope fields stamped on. The
    file opens at the first emit (``header`` written ahead of it), so a
    rank whose index is still a guess touches no file."""

    def __init__(self, path: str, host: int,
                 header: Optional[tuple[str, dict]] = None,
                 ring: Optional[FlightRecorder] = None):
        self.path = path
        self.host = host
        self.ring = ring
        self._header = header
        self._lock = threading.Lock()
        self._file = None
        self._since_fsync = 0

    def stamp_record(self, etype: str, fields: dict) -> dict:
        record = {"v": SCHEMA_VERSION, "t": time.time(), "host": self.host,
                  "pid": os.getpid(), "type": etype}
        record.update(fields)
        return record

    def emit(self, etype: str, fields: dict) -> None:
        record = self.stamp_record(etype, fields)
        if self.ring is not None:
            self.ring.record(record)
        line = json.dumps(record, default=str) + "\n"
        with self._lock:
            if self._file is None:
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                self._file = open(self.path, "a", encoding="utf-8")
                if self._header is not None:
                    hdr_type, hdr_fields = self._header
                    self._header = None
                    self._file.write(json.dumps(self.stamp_record(hdr_type, hdr_fields),
                                                default=str) + "\n")
            self._file.write(line)
            self._file.flush()
            self._since_fsync += 1
            if self._since_fsync >= _FSYNC_EVERY:
                os.fsync(self._file.fileno())
                self._since_fsync = 0

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()
                os.fsync(self._file.fileno())
                self._file.close()
                self._file = None


class ObsState:
    """One per process: configuration, span buffer, file sinks."""

    def __init__(self):
        self.enabled = _env_enabled()
        self.host, self.host_count = _env_rank()
        self.dir: Optional[str] = None
        self.events: Optional[EventLog] = None
        self.mono0 = time.perf_counter()
        self.spans: list = []          # (name, mono_start, dur, tid, depth)
        self.spans_dropped = 0
        # the flight recorder: a bounded ring of recent event records that
        # the anomaly detector dumps at an incident (HSTD_FLIGHT_RING=0
        # disables it)
        self.ring: Optional[FlightRecorder] = FlightRecorder.from_env()
        self._tl = threading.local()
        self._lock = threading.Lock()
        env_dir = os.environ.get(ENV_DIR, "").strip()
        if self.enabled and env_dir:
            self._open_dir(env_dir)

    def _open_dir(self, path: str) -> None:
        self.dir = path
        if self.host == 0 or _all_hosts_env():
            self._open_event_log()

    def _open_event_log(self) -> None:
        header = (("run", {"argv": sys.argv, "python": sys.version.split()[0]})
                  if self.host == 0 else None)
        self.events = EventLog(os.path.join(self.dir, event_filename(self.host)),
                               self.host, header=header, ring=self.ring)

    def configure(self, out_dir: Optional[str] = None,
                  enabled: Optional[bool] = None) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = enabled
            if out_dir and self.enabled and self.dir != out_dir:
                if self.events is not None:
                    self.events.close()
                    self.events = None
                self._open_dir(out_dir)

    def set_host(self, index: int, count: int) -> None:
        changed = index != self.host
        self.host = index
        self.host_count = count
        if not changed:
            return
        if self.events is not None:
            # the rank guess was wrong: the log opens lazily, so no file
            # was touched; reopen under the real rank
            self.events.close()
            self.events = None
        if self.dir is not None and self.enabled and (index == 0 or _all_hosts_env()):
            self._open_event_log()

    def add_span(self, name: str, mono_start: float, dur: float,
                 args: Optional[dict]) -> None:
        tid = threading.get_ident() & 0x7FFFFFFF
        depth = getattr(self._tl, "depth", 0)
        if len(self.spans) < _MAX_BUFFERED_SPANS:
            self.spans.append((name, mono_start, dur, tid, depth))
        else:
            self.spans_dropped += 1
        if self.events is not None:
            fields = {"name": name, "dur": round(dur, 9), "mono": round(mono_start, 9),
                      "tid": tid, "depth": depth}
            if args:
                fields["args"] = args
            self.events.emit("span", fields)

    def flush_trace(self, path: Optional[str] = None) -> Optional[str]:
        """Write the Chrome-trace projection of the buffered spans
        atomically (tmp + rename). Returns the path written, or None."""
        if path is None:
            if self.dir is None or self.host != 0:
                return None
            path = os.path.join(self.dir, "trace.json")
        events = [{"name": name, "ph": "X", "ts": round(mono * 1e6, 3),
                   "dur": round(dur * 1e6, 3), "pid": self.host, "tid": tid}
                  for name, mono, dur, tid, _depth in list(self.spans)]
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"schema_version": SCHEMA_VERSION,
                             "spans_dropped": self.spans_dropped}}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path

    def shutdown(self) -> None:
        self.flush_trace()
        if self.events is not None:
            self.events.close()
            self.events = None


class _NullSpan:
    """The disabled span: one shared instance, allocation-free."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_state", "_name", "_args", "_t0")

    def __init__(self, state: ObsState, name: str, args: Optional[dict]):
        self._state = state
        self._name = name
        self._args = args

    def __enter__(self):
        tl = self._state._tl
        tl.depth = getattr(tl, "depth", 0) + 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        tl = self._state._tl
        tl.depth = max(getattr(tl, "depth", 1) - 1, 0)
        self._state.add_span(self._name, self._t0 - self._state.mono0, dur, self._args)
        return False


class Tracer:
    """Nestable wall-time spans. Recording needs an output dir: an
    uninstrumented process gets the shared no-op span."""

    def __init__(self, state: ObsState):
        self._state = state

    def span(self, name: str, args: Optional[dict] = None):
        state = self._state
        if not state.enabled or state.dir is None:
            return NULL_SPAN
        return _Span(state, name, args)


class MetricsSink:
    """Rank-0 scalar series, written as ``metric`` events; a two-comparison
    early return without a file sink."""

    def __init__(self, state: ObsState):
        self._state = state

    def scalar(self, name: str, value, step: Optional[int] = None,
               args: Optional[dict] = None) -> None:
        state = self._state
        if not state.enabled or state.events is None:
            return
        fields: dict = {"name": name, "value": None if value is None else float(value)}
        if step is not None:
            fields["step"] = int(step)
        if args:
            fields["args"] = args
        state.events.emit("metric", fields)
