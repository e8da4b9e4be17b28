"""Wall-clock timing and throughput meters (counterpart of the JAX
package's ``utils/timing.py``).

PyTorch returns before the card has finished, so on a CUDA device every
clock read here first waits for the device (``torch.cuda.synchronize``):
a window then measures the work, not its enqueueing. The telemetry sink
and the FLOPs/MFU accounting of the JAX meter wait for the port's
``obs`` layer (ROADMAP slice 2 follow-ups).
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
    and computes throughput; a step the caller excludes (the first, which
    pays the kernels' build and the allocator's warm-up) counts no time."""

    n_chips: int = 1
    device: Optional[object] = None
    _steps: int = 0
    _samples: int = 0
    _measured_time: float = 0.0
    _measured_samples: int = 0
    _measured_steps: int = 0
    _excluded_steps: int = 0
    _w0: Optional[float] = None
    _w_samples: int = 0
    _w_steps: int = 0

    def begin_window(self) -> None:
        self._w0 = clock(self.device)
        self._w_samples = 0
        self._w_steps = 0

    def window_step(self, batch_samples: int) -> None:
        self._w_samples += batch_samples
        self._w_steps += 1

    def exclude_step(self, batch_samples: int) -> None:
        """Count a step as run-but-excluded; callers pair this with
        ``begin_window()`` so its wall time is not attributed."""
        self._steps += 1
        self._samples += batch_samples
        self._excluded_steps += 1
        self._w_samples = max(self._w_samples - batch_samples, 0)
        self._w_steps = max(self._w_steps - 1, 0)

    def end_window(self) -> Optional[dict]:
        """Attributes the open window's wall time to the samples
        dispatched inside it. Returns {dt, steps, samples, step_time_s},
        or None when no window was open; a window that saw no steps is
        discarded (it holds only dead time: eval, epoch bookkeeping)."""
        if self._w0 is None:
            return None
        if self._w_steps == 0:
            self._w0 = None
            return None
        dt = clock(self.device) - self._w0
        self._measured_time += dt
        self._measured_samples += self._w_samples
        self._measured_steps += self._w_steps
        self._steps += self._w_steps
        self._samples += self._w_samples
        summary = {"dt": dt, "steps": self._w_steps, "samples": self._w_samples,
                   "step_time_s": dt / self._w_steps}
        self._w0 = None
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
