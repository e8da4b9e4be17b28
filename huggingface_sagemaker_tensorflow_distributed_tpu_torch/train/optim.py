"""Optimizer construction (counterpart of the JAX package's
``train/optim.py::build_optimizer`` for ``adam``, ``adamw`` and
``adafactor``).

- The learning rate is scaled by the world size
  (``scale_lr_by_world_size``), as the JAX package scales by the
  data-parallel size.
- With ``warmup_ratio > 0`` the learning rate of update ``n`` (counted
  from 0, one per optimizer update, not per micro-step) is optax's:
  a linear warmup from 0 over ``max(1, int(updates * warmup_ratio))``
  updates, then a linear or cosine decay to 0 at ``updates =
  total_steps // accum`` (``join_schedules`` of ``linear_schedule`` and
  ``linear_schedule``/``cosine_decay_schedule``). Otherwise it is
  constant.
- ``adamw`` with ``weight_decay > 0`` is ``torch.optim.AdamW``: optax's
  ``adamw`` adds ``wd * param`` to the Adam direction before the
  ``-lr`` scale, i.e. ``p - lr * (adam + wd * p)``, which is torch's
  decoupled ``p * (1 - lr * wd) - lr * adam`` (``tests/
  test_torch_train.py`` holds the two against each other). Otherwise it
  is ``torch.optim.Adam``. Both with optax's defaults b1 0.9, b2 0.999,
  eps 1e-8.
- ``adafactor`` is :class:`Adafactor`, optax's ``adafactor(lr)`` chain
  step for step (not ``torch.optim.Adafactor``, whose decay, clipping and
  parameter scale differ).
- ``max_grad_norm > 0`` clips by the global norm as optax does (kept
  below the norm, ``g / norm * max_norm`` above it);
  ``gradient_accumulation_steps`` averages micro-batch gradients into one
  update (optax ``MultiSteps``); both are applied by the trainer at
  update time.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.config import TrainConfig


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax ``linear_schedule``."""
    if steps <= 0:
        return lambda n: init

    def f(n):
        frac = 1.0 - min(max(n, 0), steps) / steps
        return (init - end) * frac + end
    return f


def _cosine(init: float, steps: int) -> Callable[[int], float]:
    """optax ``cosine_decay_schedule`` to 0 (alpha 0, exponent 1)."""
    if steps <= 0:
        return lambda n: init

    def f(n):
        return init * 0.5 * (1.0 + math.cos(math.pi * min(n, steps) / steps))
    return f


def lr_schedule(config: TrainConfig, world_size: int = 1,
                total_steps: Optional[int] = None) -> tuple[Callable[[int], float], float]:
    """``(lr of update n, scaled base lr)``."""
    lr = config.learning_rate * (world_size if config.scale_lr_by_world_size else 1.0)
    if not (config.warmup_ratio > 0 and total_steps):
        return (lambda n: lr), lr
    updates = max(1, total_steps // config.gradient_accumulation_steps)
    warmup = max(1, int(updates * config.warmup_ratio))
    up = _linear(0.0, lr, warmup)
    down = (_cosine(lr, updates - warmup) if config.lr_schedule == "cosine"
            else _linear(lr, 0.0, updates - warmup))
    return (lambda n: up(n) if n < warmup else down(n - warmup)), lr


# optax.adafactor's defaults: the second moment's decay exponent, the
# squared-gradient epsilon, the block-RMS clip, the parameter-scale floor
# and the smallest second-largest axis that is factored
ADAFACTOR_DECAY = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIP = 1.0
ADAFACTOR_MIN_SCALE = 1e-3
ADAFACTOR_MIN_DIM_TO_FACTOR = 128


def factored_dims(shape) -> Optional[tuple[int, int]]:
    """optax's ``_factored_dims``: the second-largest and the largest
    axis of ``shape`` (numpy's ``argsort`` order among equal sizes), or
    None below two axes or when the second-largest is under
    ``ADAFACTOR_MIN_DIM_TO_FACTOR``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(torch.optim.Optimizer):
    """optax ``adafactor(learning_rate)`` (optax 0.2.6's defaults), in
    fp32, one parameter at a time:

    1. ``scale_by_factored_rms``: with decay ``1 - (t + 1)^-0.8`` at step
       ``t`` (from 0) and ``g² + 1e-30``, a parameter with two axes of at
       least 128 (:func:`factored_dims`) keeps the mean of ``g²`` over its
       largest axis (``v_row``) and over its second-largest (``v_col``),
       and its update is ``g · (v_row / mean(v_row))^-1/2 ·
       v_col^-1/2``; any other keeps the full ``v`` and takes ``g ·
       v^-1/2``;
    2. ``clip_by_block_rms(1.0)``: divided by ``max(1, rms(update))``;
    3. times the learning rate (the group's ``lr``, which the trainer sets
       from the schedule each update);
    4. ``scale_by_param_block_rms``: times ``max(rms(p), 1e-3)`` of the
       parameter before the update;
    5. subtracted from the parameter.

    The state (``step``, ``v_row``/``v_col`` or ``v``) goes through
    ``state_dict()``, so checkpoints carry it. A parameter without a
    gradient is skipped."""

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, group)

    def _update(self, p, group) -> None:
        g = p.grad.float()
        dims = factored_dims(tuple(p.shape))
        state = self.state[p]
        if not state:
            state["step"] = 0
            if dims is None:
                state["v"] = torch.zeros_like(g)
            else:
                d1, d0 = dims
                state["v_row"] = g.new_zeros(tuple(np.delete(p.shape, d0)))
                state["v_col"] = g.new_zeros(tuple(np.delete(p.shape, d1)))
        t = torch.tensor(state["step"] + 1, dtype=torch.float32)
        decay = (1.0 - t ** -ADAFACTOR_DECAY).to(g.device)
        g2 = g * g + ADAFACTOR_EPS
        if dims is None:
            v = decay * state["v"] + (1.0 - decay) * g2
            state["v"] = v
            u = g * v ** -0.5
        else:
            d1, d0 = dims
            v_row = decay * state["v_row"] + (1.0 - decay) * g2.mean(d0)
            v_col = decay * state["v_col"] + (1.0 - decay) * g2.mean(d1)
            state["v_row"], state["v_col"] = v_row, v_col
            row_col_mean = v_row.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
            u = (g * ((v_row / row_col_mean) ** -0.5).unsqueeze(d0)
                 * (v_col ** -0.5).unsqueeze(d1))
        state["step"] += 1
        u = u / torch.clamp(torch.sqrt((u * u).mean()) / ADAFACTOR_CLIP, min=1.0)
        u = u * group["lr"]
        p32 = p.float()
        rms = torch.sqrt((p32 * p32).mean())
        u = u * torch.where(rms <= ADAFACTOR_MIN_SCALE, ADAFACTOR_MIN_SCALE, rms)
        p.copy_((p32 - u).to(p.dtype))


def build_optimizer(config: TrainConfig, params, world_size: int = 1,
                    total_steps: Optional[int] = None):
    """Returns ``(torch optimizer, schedule, scaled base lr)``; the caller
    sets each update's learning rate from ``schedule`` (see
    :func:`set_lr`)."""
    if config.optimizer not in ("adam", "adamw", "adafactor"):
        raise NotImplementedError(
            f"optimizer {config.optimizer!r} is not ported to the PyTorch "
            "package yet: ROADMAP queue 1, item 4")
    schedule, lr = lr_schedule(config, world_size, total_steps)
    params = list(params)
    if config.optimizer == "adafactor":
        opt = Adafactor(params, lr=schedule(0))
    elif config.optimizer == "adamw" and config.weight_decay > 0:
        opt = torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=config.weight_decay)
    else:
        opt = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8)
    return opt, schedule, lr


def set_lr(optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def global_norm(params) -> torch.Tensor:
    """optax ``global_norm`` of the ``.grad`` of ``params`` (a device
    scalar, no host sync)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad.float()) for p in params if p.grad is not None]))


def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place and without a host sync; returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = global_norm(params)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))
    return norm
