"""Anomaly detection over the live telemetry stream (counterpart of the
JAX package's ``obs/anomaly.py``, rule for rule): a non-finite loss or
gradient norm, grad-norm explosion, step-time spikes (rolling MAD),
heartbeat stalls and persistent stragglers.

On a trigger the detector emits ONE ``anomaly`` event (rate-limited: a
cooldown per kind, terminal kinds latch), dumps the flight-recorder ring
to ``flight_<tag>.jsonl`` and, when ``HSTD_PROFILE_ON_ANOMALY`` allows,
opens a bounded ``torch.profiler`` window. The thresholds are
conservative: a normal run produces no anomaly event.
"""

from __future__ import annotations

import collections
import math
import os
import sys
import threading
import time
from typing import Optional

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.flight import (
    FlightRecorder,
    ProfilerCapture,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.schema import (
    SCHEMA_VERSION,
)

ENV_ANOMALY = "HSTD_ANOMALY"                  # 0 disables all detectors
ENV_COOLDOWN = "HSTD_ANOMALY_COOLDOWN_S"      # per-kind re-fire cooldown
ENV_STRAGGLER = "HSTD_STRAGGLER_ALERT"        # straggler_ratio threshold

DEFAULT_COOLDOWN_S = 60.0
DEFAULT_STRAGGLER_RATIO = 1.1
STRAGGLER_EPOCHS = 2          # consecutive epochs over threshold → anomaly

# step-time spike detection (rolling median absolute deviation):
# dt is a spike when it exceeds median + max(MAD_SIGMA·1.4826·MAD,
# SPIKE_MIN_FRACTION·median) — the MAD term adapts to noisy step times,
# the fractional floor keeps ultra-stable runs (MAD ≈ 0) from flagging
# scheduler jitter
STEP_HISTORY = 64
STEP_MIN_HISTORY = 8
MAD_SIGMA = 8.0
SPIKE_MIN_FRACTION = 0.5

GRAD_HISTORY = 64
GRAD_MIN_HISTORY = 8
GRAD_EXPLOSION_FACTOR = 10.0   # vs rolling median

# kinds that describe an unrecoverable state: once seen, every later
# observation would re-report the same incident — latch instead
_TERMINAL_KINDS = frozenset({"nan_loss", "nan_grad"})


def anomaly_enabled_env() -> bool:
    return os.environ.get(ENV_ANOMALY, "1").strip().lower() not in (
        "0", "false", "off", "no")


def straggler_threshold_env(default: float = DEFAULT_STRAGGLER_RATIO) -> float:
    raw = os.environ.get(ENV_STRAGGLER, "").strip()
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def cooldown_env(default: float = DEFAULT_COOLDOWN_S) -> float:
    raw = os.environ.get(ENV_COOLDOWN, "").strip()
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def _median(values: list) -> float:
    s = sorted(values)
    n = len(s)
    mid = n // 2
    return float(s[mid]) if n % 2 else float((s[mid - 1] + s[mid]) / 2.0)


class AnomalyDetector:
    """One per process (``obs.anomalies()``), fed by the train loop and
    the heartbeat. All ``observe_*`` entry points are cheap host-side
    arithmetic and early-return when detection is disabled."""

    def __init__(self, state, recorder: Optional[FlightRecorder] = None,
                 profiler: Optional[ProfilerCapture] = None,
                 cooldown_s: Optional[float] = None,
                 straggler_ratio: Optional[float] = None):
        self._state = state
        self.recorder = recorder
        self.profiler = profiler if profiler is not None else ProfilerCapture()
        self.enabled = anomaly_enabled_env()
        self.cooldown_s = cooldown_env() if cooldown_s is None else cooldown_s
        self.straggler_ratio = (straggler_threshold_env()
                                if straggler_ratio is None
                                else straggler_ratio)
        self.counts: dict[str, int] = {}
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self._last_fire: dict[str, float] = {}
        self._latched: set[str] = set()
        self._step_times: collections.deque = collections.deque(
            maxlen=STEP_HISTORY)
        self._grad_norms: collections.deque = collections.deque(
            maxlen=GRAD_HISTORY)
        self._straggler_run = 0

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def begin_fit(self) -> None:
        """Reset the ROLLING baselines (step time, grad norm, straggler
        run) at the start of a training run: two fits in one process
        (a resumed fit, warmup then measured) have legitimately
        different step-time regimes, and a baseline carried across them
        would flag the regime change as a spike. Counts, latches and
        cooldowns deliberately survive — they describe the process."""
        self._step_times.clear()
        self._grad_norms.clear()
        self._straggler_run = 0

    # -- detectors ----------------------------------------------------------

    def observe_loss(self, step: int, loss: float) -> bool:
        if not self.enabled:
            return False
        self.profiler.poll()
        if not math.isfinite(loss):
            return self.trigger(
                "nan_loss",
                f"non-finite training loss ({loss!r}) at step {step}",
                step=step, loss=str(loss))
        return False

    def observe_grad_norm(self, step: int, grad_norm: float) -> bool:
        if not self.enabled:
            return False
        self.profiler.poll()
        if not math.isfinite(grad_norm):
            return self.trigger(
                "nan_grad",
                f"non-finite gradient norm ({grad_norm!r}) at step {step}",
                step=step, grad_norm=str(grad_norm))
        history = list(self._grad_norms)
        self._grad_norms.append(float(grad_norm))
        if len(history) < GRAD_MIN_HISTORY:
            return False
        med = _median(history)
        if med > 0 and grad_norm > GRAD_EXPLOSION_FACTOR * med:
            return self.trigger(
                "grad_explosion",
                f"gradient norm {grad_norm:.4g} is "
                f"{grad_norm / med:.1f}x the rolling median {med:.4g} "
                f"at step {step}",
                step=step, grad_norm=float(grad_norm), median=med)
        return False

    def observe_step_time(self, step: int, step_time_s: float) -> bool:
        if not self.enabled or not math.isfinite(step_time_s) \
                or step_time_s <= 0:
            return False
        self.profiler.poll()
        history = list(self._step_times)
        self._step_times.append(float(step_time_s))
        if len(history) < STEP_MIN_HISTORY:
            return False
        med = _median(history)
        mad = _median([abs(v - med) for v in history])
        threshold = med + max(MAD_SIGMA * 1.4826 * mad,
                              SPIKE_MIN_FRACTION * med)
        if step_time_s > threshold:
            return self.trigger(
                "step_time_spike",
                f"step time {step_time_s:.4f}s exceeds rolling "
                f"median {med:.4f}s + MAD threshold {threshold:.4f}s "
                f"at step {step}",
                step=step, step_time_s=float(step_time_s),
                median_s=med, threshold_s=threshold)
        return False

    def observe_straggler(self, epoch: int, stats: Optional[dict]) -> bool:
        """Feed one epoch's ``host_step_stats``; fires after
        ``STRAGGLER_EPOCHS`` CONSECUTIVE epochs over
        ``HSTD_STRAGGLER_ALERT``, naming the slow rank."""
        if not self.enabled or not stats:
            return False
        ratio = float(stats.get("straggler_ratio", 1.0))
        if ratio <= self.straggler_ratio:
            self._straggler_run = 0
            return False
        self._straggler_run += 1
        if self._straggler_run < STRAGGLER_EPOCHS:
            return False
        slow = stats.get("argmax")
        return self.trigger(
            "straggler",
            f"host {slow} is a persistent straggler: step-time ratio "
            f"{ratio:.3f} > {self.straggler_ratio:g} for "
            f"{self._straggler_run} consecutive epochs (epoch {epoch})",
            step=epoch, straggler_ratio=ratio, slow_host=slow,
            epochs=self._straggler_run)

    def observe_stall(self, progress_age_s: float, thread: str) -> bool:
        """Wired from the heartbeat's stall dump: the stall event
        carries the stacks; this adds the anomaly-plane record (flight
        dump + index entry) next to it."""
        if not self.enabled:
            return False
        return self.trigger(
            "heartbeat_stall",
            f"thread {thread!r} made no progress for "
            f"{progress_age_s:.1f}s", progress_age_s=float(progress_age_s),
            thread=thread)

    # -- trigger ------------------------------------------------------------

    def trigger(self, kind: str, message: str, step: Optional[int] = None,
                **fields) -> bool:
        """Emit one rate-limited ``anomaly`` event + flight dump
        (+ profiler window). Returns True iff the event fired."""
        now = time.monotonic()
        with self._lock:
            if kind in self._latched:
                return False
            last = self._last_fire.get(kind)
            if last is not None and now - last < self.cooldown_s:
                return False
            self._last_fire[kind] = now
            if kind in _TERMINAL_KINDS:
                self._latched.add(kind)
            self.counts[kind] = self.counts.get(kind, 0) + 1
        record = {"name": kind, "message": message}
        if step is not None:
            record["step"] = int(step)
        record.update(fields)
        self.events.append(dict(record))
        state = self._state
        evidence = None
        if self.recorder is not None:
            # the dump is the ring BEFORE the incident, with the anomaly
            # record itself appended last so the file is self-describing.
            # Hosts without an event log (rank != 0) stamp the envelope
            # locally, so every flight dump is schema-valid wherever it
            # was written.
            if state.events is not None:
                stamped = state.events.stamp_record("anomaly", record)
            else:
                stamped = {"v": SCHEMA_VERSION, "t": time.time(),
                           "host": state.host, "pid": os.getpid(),
                           "type": "anomaly", **record}
            # tag = host + step + kind: two kinds at one step (or two
            # hosts on a shared filesystem) must not share an evidence
            # file — each anomaly's dump contains ITS trigger record
            tag = (f"h{state.host}_"
                   f"{'x' if step is None else int(step)}_{kind}")
            evidence = self.recorder.dump(state.dir, step, extra=stamped,
                                          tag=tag)
            if evidence is not None:
                record["evidence"] = evidence
        trace_dir = self.profiler.maybe_start(state.dir, step)
        if trace_dir is not None:
            record["profile_dir"] = trace_dir
        if state.events is not None:
            state.events.emit("anomaly", record)
        print(f"[hstd-obs] ANOMALY {kind}: {message}"
              + (f" (flight: {evidence})" if evidence else "")
              + (f" (profile: {trace_dir})" if trace_dir else ""),
              file=sys.stderr, flush=True)
        return True

    def shutdown(self) -> None:
        self.profiler.stop()
