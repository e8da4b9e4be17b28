"""Watchdogs (counterpart of the JAX package's ``obs/watchdog.py``): the
liveness heartbeat with its stall stack dump, and the device-memory
sampler over ``torch.cuda``'s counters.

A run that hangs leaves heartbeat lines (the last time it was known
alive) and, if the watched thread stops pulsing while the process lives,
one ``stall`` event with every thread's stack naming the blocked thread.
The JAX package's compile tracker has no counterpart yet (ROADMAP queue
1): the port builds its kernels with ``nvcc`` at first use, not per
shape.
"""

from __future__ import annotations

import logging
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
