"""Wall-clock timing and throughput meters (counterpart of the JAX
package's ``utils/timing.py``).

PyTorch returns before the card has finished, so on a CUDA device every
clock read here first waits for the device (``torch.cuda.synchronize``):
a window then measures the work, not its enqueueing. Given a metrics
sink (``obs.MetricsSink``), every closed window emits the JAX meter's
series (``train/samples_per_sec``, ``train/step_time_s`` and, with the
FLOPs accounting of ``obs/flops.py``, ``train/model_flops``,
``train/achieved_tflops_per_chip`` and ``train/mfu``).

Excluded steps: the trainer closes the window before a step that meets
new shapes (the run's first step, and with length bucketing the first
step of each new batch width) and, after it, counts it with
:meth:`StepMeter.exclude_step` and opens a fresh window, so throughput and
MFU read the steady-state steps only (the JAX meter's compile-step
exclusion).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def clock(device=None) -> float:
    """``time.perf_counter()`` after the device's queued work is done."""
    _sync(device)
    return time.perf_counter()


@dataclass
class StepMeter:
    """Accumulates the wall time of windows of steps between sync points
    and computes throughput and MFU; a step the caller excludes (the
    first, which pays the kernels' build and the allocator's warm-up)
    counts no time.

    ``flops_per_token`` (and ``dec_flops_per_token`` for a second token
    stream) are per-REAL-token training FLOPs, ``peak_tflops`` the card's
    peak; zero/None disables that accounting."""

    n_chips: int = 1
    device: Optional[object] = None
    sink: Optional[object] = None     # obs.MetricsSink-shaped (scalar())
    flops_per_token: float = 0.0
    dec_flops_per_token: float = 0.0
    peak_tflops: Optional[float] = None
    _steps: int = 0
    _samples: int = 0
    _measured_time: float = 0.0
    _measured_samples: int = 0
    _measured_steps: int = 0
    _measured_flops: float = 0.0
    _excluded_steps: int = 0
    _w0: Optional[float] = None
    _w_samples: int = 0
    _w_steps: int = 0
    _w_tokens: int = 0
    _w_dec_tokens: int = 0

    def begin_window(self) -> None:
        self._w0 = clock(self.device)
        self._w_samples = 0
        self._w_steps = 0
        self._w_tokens = 0
        self._w_dec_tokens = 0

    def window_step(self, batch_samples: int) -> None:
        self._w_samples += batch_samples
        self._w_steps += 1

    def window_tokens(self, tokens: int, dec_tokens: int = 0) -> None:
        """Attribute REAL (attention-mask) token counts to the open
        window: what the FLOPs figure multiplies."""
        self._w_tokens += int(tokens)
        self._w_dec_tokens += int(dec_tokens)

    def exclude_step(self, batch_samples: int) -> None:
        """Count a step as run-but-excluded; callers pair this with
        ``begin_window()`` so its wall time is not attributed."""
        self._steps += 1
        self._samples += batch_samples
        self._excluded_steps += 1
        self._w_samples = max(self._w_samples - batch_samples, 0)
        self._w_steps = max(self._w_steps - 1, 0)

    def end_window(self) -> Optional[dict]:
        """Attributes the open window's wall time to the samples (and
        real tokens) dispatched inside it. Returns {dt, steps, samples,
        tokens, step_time_s, model_flops, achieved_tflops_per_chip, mfu}
        (the FLOPs fields None without the accounting), or None when no
        window was open; a window that saw no steps is discarded (it holds
        only dead time: eval, checkpoint saves, epoch bookkeeping)."""
        if self._w0 is None:
            return None
        if self._w_steps == 0:
            self._w0 = None
            self._w_tokens = 0
            self._w_dec_tokens = 0
            return None
        dt = clock(self.device) - self._w0
        self._measured_time += dt
        self._measured_samples += self._w_samples
        self._measured_steps += self._w_steps
        self._steps += self._w_steps
        self._samples += self._w_samples
        flops = (self._w_tokens * self.flops_per_token
                 + self._w_dec_tokens * self.dec_flops_per_token)
        self._measured_flops += flops
        summary = {"dt": dt, "steps": self._w_steps, "samples": self._w_samples,
                   "tokens": self._w_tokens + self._w_dec_tokens,
                   "step_time_s": dt / self._w_steps,
                   "model_flops": flops if flops > 0 else None,
                   "achieved_tflops_per_chip": None, "mfu": None}
        if flops > 0 and dt > 0:
            achieved = flops / dt / max(1, self.n_chips) / 1e12
            summary["achieved_tflops_per_chip"] = achieved
            if self.peak_tflops:
                summary["mfu"] = achieved / self.peak_tflops
        if self.sink is not None and dt > 0:
            self.sink.scalar("train/samples_per_sec", self._w_samples / dt, self._steps)
            self.sink.scalar("train/step_time_s", summary["step_time_s"], self._steps)
            if summary["model_flops"] is not None:
                self.sink.scalar("train/model_flops", summary["model_flops"], self._steps)
                self.sink.scalar("train/achieved_tflops_per_chip",
                                 summary["achieved_tflops_per_chip"], self._steps)
                if summary["mfu"] is not None:
                    self.sink.scalar("train/mfu", summary["mfu"], self._steps)
        self._w0 = None
        self._w_tokens = 0
        self._w_dec_tokens = 0
        return summary

    @property
    def samples_per_sec(self) -> float:
        if self._measured_time == 0:
            return 0.0
        return self._measured_samples / self._measured_time

    @property
    def samples_per_sec_per_chip(self) -> float:
        return self.samples_per_sec / max(1, self.n_chips)

    @property
    def avg_step_time(self) -> float:
        if self._measured_steps == 0:
            return 0.0
        return self._measured_time / self._measured_steps

    @property
    def excluded_steps(self) -> int:
        return self._excluded_steps

    @property
    def achieved_tflops_per_chip(self) -> Optional[float]:
        if self._measured_flops <= 0 or self._measured_time <= 0:
            return None
        return self._measured_flops / self._measured_time / max(1, self.n_chips) / 1e12

    @property
    def mfu(self) -> Optional[float]:
        """Model-FLOPs utilization over every measured window (real
        tokens x analytic FLOPs / wall / card peak); None without the
        accounting or an unknown peak. Above 1 means the FLOPs model or
        the peak is wrong, and is left to show it."""
        achieved = self.achieved_tflops_per_chip
        if achieved is None or not self.peak_tflops:
            return None
        return achieved / self.peak_tflops


class Stopwatch:
    """``train_runtime`` bracket; on a CUDA ``device`` both ends wait for
    the device."""

    def __init__(self, device=None):
        self.device = device

    def __enter__(self):
        _sync(self.device)
        self.start = time.time()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        self.elapsed = round(time.time() - self.start, 4)
        return False
