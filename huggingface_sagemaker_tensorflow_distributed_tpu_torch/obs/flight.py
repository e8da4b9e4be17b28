"""Flight recorder and profiler windows (counterpart of the JAX package's
``obs/flight.py``).

- :class:`FlightRecorder`: a bounded in-memory ring of the most recent
  event records, dumped to ``flight_<tag>.jsonl`` the moment an anomaly
  fires. Every record the event log writes lands in the ring, so a dump
  is a schema-valid replay of the run's last ``HSTD_FLIGHT_RING`` events
  that ``scripts/check_telemetry_schema.py`` lints like any events file.
- :class:`ProfilerCapture`: the bounded ``torch.profiler`` window the
  anomaly detector may open (``HSTD_PROFILE_ON_ANOMALY``), written as a
  Chrome trace under ``<dir>/profile_anomaly_<step>/``.
- :func:`start_profiler`/:func:`stop_profiler`: the ``torch.profiler``
  window both of them and the trainer's ``--profile`` use: CUDA activity
  on the card, CPU activity on the CPU.

torch is imported inside the functions that profile: the recorder and
the schema side of ``obs`` stay stdlib only.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Optional

ENV_RING = "HSTD_FLIGHT_RING"            # ring capacity (events); 0 disables
ENV_PROFILE = "HSTD_PROFILE_ON_ANOMALY"  # 0 off | 1 on the card | force: CPU too
ENV_PROFILE_SECS = "HSTD_PROFILE_SECS"   # capture window length (default 10)

DEFAULT_RING = 512
DEFAULT_PROFILE_SECS = 10.0
MAX_PROFILE_WINDOWS = 2   # per process: a capture is expensive evidence


def ring_capacity_env(default: int = DEFAULT_RING) -> int:
    raw = os.environ.get(ENV_RING, "").strip()
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


class FlightRecorder:
    """Bounded deque of envelope-stamped event records. ``record`` is the
    event log's hot path (one append under a lock); ``dump`` writes the
    ring atomically (tmp + rename)."""

    def __init__(self, capacity: int = DEFAULT_RING):
        self.capacity = int(capacity)
        self._ring: collections.deque = collections.deque(maxlen=max(self.capacity, 1))
        self._lock = threading.Lock()
        self.dumps: list[str] = []

    @classmethod
    def from_env(cls) -> Optional["FlightRecorder"]:
        cap = ring_capacity_env()
        return cls(cap) if cap > 0 else None

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, record: dict) -> None:
        with self._lock:
            self._ring.append(record)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def dump(self, out_dir: Optional[str], step: Optional[int],
             extra: Optional[dict] = None, tag: Optional[str] = None) -> Optional[str]:
        """Write ``flight_<tag>.jsonl`` (oldest first; ``extra``, the
        triggering anomaly record, last). ``tag`` defaults to the step.
        Returns the path, or None without an output dir or records. A
        failed write raises: telemetry that cannot write does not go on
        as if it had."""
        if not out_dir:
            return None
        records = self.snapshot()
        if extra is not None:
            records.append(extra)
        if not records:
            return None
        if tag is None:
            tag = "unknown" if step is None else str(int(step))
        path = os.path.join(out_dir, f"flight_{tag}.jsonl")
        if os.path.exists(path):   # one dump per tag: keep the first
            return path
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            for rec in records:
                f.write(json.dumps(rec, default=str) + "\n")
        os.replace(tmp, path)
        self.dumps.append(path)
        return path


def start_profiler(device_type: str):
    """A started ``torch.profiler.profile``: CUDA activity on ``cuda``,
    CPU activity otherwise."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA if device_type == "cuda"
                               else ProfilerActivity.CPU])
    prof.start()
    return prof


def stop_profiler(prof, path: str) -> str:
    """Stop ``prof`` and write its Chrome trace to ``path``."""
    prof.stop()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    return path


def profile_mode_env() -> str:
    """``HSTD_PROFILE_ON_ANOMALY``: "off" (default), "on" (only when a
    card has been initialized: a CPU profile of a CPU run is noise), or
    "force" (capture on the CPU too; tests use it)."""
    raw = os.environ.get(ENV_PROFILE, "").strip().lower()
    if raw in ("", "0", "false", "off", "no"):
        return "off"
    if raw == "force":
        return "force"
    return "on"


def profile_secs_env(default: float = DEFAULT_PROFILE_SECS) -> float:
    raw = os.environ.get(ENV_PROFILE_SECS, "").strip()
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def _cuda_in_use() -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


class ProfilerCapture:
    """Bounded, rate-limited ``torch.profiler`` window opened at an
    anomaly. ``maybe_start`` opens it into
    ``<out_dir>/profile_anomaly_<step>/``; ``poll`` (called from every
    detector observation) closes it once the window elapses, ``stop``
    closes it unconditionally. At most ``MAX_PROFILE_WINDOWS`` per
    process."""

    def __init__(self, mode: Optional[str] = None, window_s: Optional[float] = None):
        self.mode = profile_mode_env() if mode is None else mode
        self.window_s = profile_secs_env() if window_s is None else window_s
        self.windows = 0
        self.dirs: list[str] = []
        self._active_since: Optional[float] = None
        self._prof = None

    @property
    def active(self) -> bool:
        return self._active_since is not None

    def maybe_start(self, out_dir: Optional[str], step: Optional[int]) -> Optional[str]:
        if (self.active or not out_dir or self.windows >= MAX_PROFILE_WINDOWS
                or self.mode == "off" or (self.mode == "on" and not _cuda_in_use())):
            return None
        tag = "unknown" if step is None else str(int(step))
        trace_dir = os.path.join(out_dir, f"profile_anomaly_{tag}")
        self._prof = start_profiler("cuda" if _cuda_in_use() else "cpu")
        self._active_since = time.monotonic()
        self.windows += 1
        self.dirs.append(trace_dir)
        return trace_dir

    def poll(self) -> bool:
        """Close the window if its time is up; True if one was closed."""
        if (self._active_since is not None
                and time.monotonic() - self._active_since >= self.window_s):
            return self.stop()
        return False

    def stop(self) -> bool:
        if self._active_since is None:
            return False
        self._active_since = None
        prof, self._prof = self._prof, None
        stop_profiler(prof, os.path.join(self.dirs[-1], "trace.json"))
        return True
