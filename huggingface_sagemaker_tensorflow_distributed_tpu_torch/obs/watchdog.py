"""Watchdogs (counterpart of the JAX package's ``obs/watchdog.py``): the
liveness heartbeat with its stall stack dump, the compile tracker with its
budget, and the device-memory sampler over ``torch.cuda``'s counters.

A run that hangs leaves heartbeat lines (the last time it was known
alive) and, if the watched thread stops pulsing while the process lives,
one ``stall`` event with every thread's stack naming the blocked thread.

The port compiles no graph per shape: what it compiles is native code,
built at first use (``ops/_build.py``: one ``nvcc`` per ``csrc/*.cu``,
``g++`` for the host library) and loaded once per process. Each build and
each first load reaches every installed :class:`CompileTracker` as one
observation; a load of a library an earlier run built is the port's
persistent-cache hit and surfaces at a near-zero duration.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.core import ObsState

logger = logging.getLogger(__name__)


def thread_stacks() -> list[dict]:
    """Every live thread's stack, as schema ``stall.threads`` entries."""
    frames = sys._current_frames()
    out = []
    for th in threading.enumerate():
        frame = frames.get(th.ident)
        stack = traceback.format_stack(frame) if frame is not None else []
        out.append({"name": th.name, "ident": th.ident & 0x7FFFFFFF,
                    "daemon": th.daemon, "stack": [ln.rstrip("\n") for ln in stack]})
    return out


class Heartbeat:
    """Daemon thread emitting one ``heartbeat`` event every ``interval``
    seconds. The watched thread (the train loop) calls :meth:`pulse`; if
    no pulse lands for ``stall_after`` seconds, the heartbeat emits ONE
    ``stall`` event with every thread's stack, calls ``on_stall(age,
    thread name)`` (the anomaly detector's hook), and re-arms when pulses
    resume. ``pulse()`` is two attribute stores."""

    def __init__(self, state: ObsState, interval: float = 60.0,
                 stall_after: Optional[float] = None,
                 on_stall: Optional[Callable[[float, str], object]] = None):
        self._state = state
        self.interval = max(float(interval), 0.05)
        self.stall_after = stall_after if stall_after is not None else 3.0 * self.interval
        self.on_stall = on_stall
        self._t0 = time.monotonic()
        self._progress = 0
        self._last_pulse = self._t0
        self._watched = "main"
        self._watched_ident = threading.main_thread().ident
        self._watching = False
        self._dumped = False
        self._last_trace_n = -1
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stall_count = 0

    def pulse(self) -> None:
        self._progress += 1
        self._last_pulse = time.monotonic()

    def watch_current_thread(self) -> None:
        th = threading.current_thread()
        self._watched = th.name
        self._watched_ident = th.ident
        self._watching = True
        self._last_pulse = time.monotonic()

    def unwatch(self) -> None:
        """Disable stall detection (liveness beats go on): the watched
        loop finished and legitimate idleness begins."""
        self._watching = False

    def start(self) -> "Heartbeat":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._last_pulse = time.monotonic()
            self._thread = threading.Thread(target=self._run, name="hstd-heartbeat",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval)
            self._thread = None

    def _beat_once(self) -> None:
        now = time.monotonic()
        age = now - self._last_pulse
        if self._state.events is not None:
            self._state.events.emit("heartbeat", {"uptime": round(now - self._t0, 3),
                                                  "progress": self._progress,
                                                  "progress_age": round(age, 3)})
        sample_device_memory(self._state)
        # keep trace.json current, so a later SIGKILL still leaves a recent
        # trace; the rewrite is O(spans), so only when enough new ones landed
        n_spans = len(self._state.spans)
        if n_spans != self._last_trace_n and (n_spans - self._last_trace_n >= 256
                                              or n_spans < 4096):
            self._state.flush_trace()
            self._last_trace_n = n_spans
        if self._watching and age > self.stall_after:
            if not self._dumped:
                self._dumped = True
                self.stall_count += 1
                self._dump_stall(age)
        else:
            self._dumped = False

    def _dump_stall(self, age: float) -> None:
        threads = thread_stacks()
        watched = self._watched
        for th in threads:
            if th["ident"] == (self._watched_ident or 0) & 0x7FFFFFFF:
                th["watched"] = True
                watched = th["name"]
        if self._state.events is not None:
            self._state.events.emit("stall", {"progress_age": round(age, 3),
                                              "stalled": watched,
                                              "progress": self._progress,
                                              "threads": threads})
        lines = [f"[hstd-heartbeat] STALL: thread {watched!r} made no progress for "
                 f"{age:.1f}s (progress={self._progress}); all thread stacks follow"]
        for th in threads:
            mark = " <-- watched (blocked)" if th.get("watched") else ""
            lines.append(f"--- thread {th['name']!r} (daemon={th['daemon']}){mark}")
            lines.extend(th["stack"])
        print("\n".join(lines), file=sys.stderr, flush=True)
        logger.error("heartbeat stall: %r blocked for %.1fs", watched, age)
        if self.on_stall is not None:
            self.on_stall(age, watched)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._beat_once()
            except Exception:  # noqa: BLE001 - the liveness thread outlives a bad beat
                logger.exception("heartbeat emission failed")


ENV_COMPILE_BUDGET = "HSTD_COMPILE_BUDGET_S"


def compile_budget_env() -> Optional[float]:
    """``HSTD_COMPILE_BUDGET_S`` as a float (None: no budget). A malformed
    value disables the budget rather than the run."""
    raw = os.environ.get(ENV_COMPILE_BUDGET, "").strip()
    try:
        return float(raw) if raw else None
    except ValueError:
        return None


class CompileTracker:
    """Counts the process's compilations: the native builds and first
    loads ``ops/_build.py`` reports (:func:`report_compile`), and any
    other observation whose name carries a compile marker.

    Emits one ``compile`` event per observation with the running count
    and cumulative seconds. With a budget (``HSTD_COMPILE_BUDGET_S``), the
    first time the cumulative seconds exceed it emits ONE ``alert`` event
    named ``compile_budget`` and a stderr line, and latches
    ``budget_exceeded``: bucket-ladder batchers consult it (through
    ``obs.compile_budget_capped``) to stop minting new widths.
    """

    _MARKERS = ("compile", "tracing", "lowering")

    def __init__(self, state: ObsState, budget_s: Optional[float] = None):
        self.state = state
        self.count = 0
        self.cum_secs = 0.0
        self.budget_s = compile_budget_env() if budget_s is None else budget_s
        self.budget_exceeded = False
        self._lock = threading.Lock()

    def observe(self, event: str, secs: float, **_: object) -> None:
        """One compilation of ``secs`` seconds named ``event``; a name
        without a compile marker is ignored. Extra keyword arguments (a
        caller's function name, say) are accepted and ignored."""
        low = event.lower()
        if not any(m in low for m in self._MARKERS):
            return
        crossed = False
        with self._lock:
            self.count += 1
            self.cum_secs += secs
            count, cum = self.count, self.cum_secs
            if (self.budget_s is not None and cum > self.budget_s
                    and not self.budget_exceeded):
                self.budget_exceeded = True
                crossed = True
        if self.state.events is not None:
            self.state.events.emit("compile", {
                "event": event, "dur": round(secs, 6), "count": count,
                "cum": round(cum, 3)})
        if crossed:
            msg = (f"cumulative compile time {cum:.1f}s exceeds "
                   f"{ENV_COMPILE_BUDGET}={self.budget_s:g}s after "
                   f"{count} compilations — bucket ladders will stop "
                   "minting new widths; keep the build/ directory between "
                   "runs (its libraries then load, not build) or use fewer "
                   "bucket rungs")
            if self.state.events is not None:
                self.state.events.emit("alert", {
                    "name": "compile_budget", "message": msg,
                    "cum": round(cum, 3), "budget_s": self.budget_s,
                    "count": count})
            print(f"[hstd-obs] COMPILE BUDGET: {msg}", file=sys.stderr,
                  flush=True)
            logger.warning("compile budget exceeded: %s", msg)


_INSTALLED: list[CompileTracker] = []


def install_compile_tracker(state: ObsState) -> Optional[CompileTracker]:
    """The tracker of ``state``, installed on first call (None when
    telemetry is disabled)."""
    if not state.enabled:
        return None
    for tracker in _INSTALLED:
        if tracker.state is state:
            return tracker
    tracker = CompileTracker(state)
    _INSTALLED.append(tracker)
    return tracker


def uninstall_compile_trackers(state: ObsState) -> None:
    """Drop ``state``'s tracker (its state is being shut down)."""
    _INSTALLED[:] = [t for t in _INSTALLED if t.state is not state]


def report_compile(event: str, secs: float) -> None:
    """One compilation, to every installed tracker."""
    for tracker in list(_INSTALLED):
        tracker.observe(event, secs)


def sample_device_memory(state: ObsState) -> int:
    """Emit one ``memory`` event for this process's card with the
    allocator's counters (the JAX package's ``memory_stats`` keys:
    ``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``, plus
    ``bytes_reserved``). Returns the number of events: 0 without a file
    sink, on the CPU, or before the card is initialized."""
    if not state.enabled or state.events is None:
        return 0
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return 0
    i = torch.cuda.current_device()
    state.events.emit("memory", {
        "device": f"cuda:{i}",
        "stats": {"bytes_in_use": int(torch.cuda.memory_allocated(i)),
                  "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
                  "bytes_reserved": int(torch.cuda.memory_reserved(i)),
                  "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory)}})
    return 1
