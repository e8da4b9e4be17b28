"""Optimizer construction (counterpart of the JAX package's
``train/optim.py::build_optimizer`` for ``adam``/``adamw``).

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
- ``max_grad_norm > 0`` clips by the global norm as optax does (kept
  below the norm, ``g / norm * max_norm`` above it);
  ``gradient_accumulation_steps`` averages micro-batch gradients into one
  update (optax ``MultiSteps``); both are applied by the trainer at
  update time.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

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


def build_optimizer(config: TrainConfig, params, world_size: int = 1,
                    total_steps: Optional[int] = None):
    """Returns ``(torch optimizer, schedule, scaled base lr)``; the caller
    sets each update's learning rate from ``schedule`` (see
    :func:`set_lr`)."""
    if config.optimizer not in ("adam", "adamw"):
        raise NotImplementedError(
            f"optimizer {config.optimizer!r} is not ported to the PyTorch "
            "package yet: ROADMAP queue 1, item 4")
    schedule, lr = lr_schedule(config, world_size, total_steps)
    params = list(params)
    if config.optimizer == "adamw" and config.weight_decay > 0:
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
