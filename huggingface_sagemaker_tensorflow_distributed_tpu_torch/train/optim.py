"""Optimizer construction (counterpart of the JAX package's
``train/optim.py``: ``build_optimizer`` for ``adam``, ``adamw``,
``adafactor`` and ``lamb``, and ``scale_by_adam_lowp``, the bf16-moment
Adam).

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
- ``optimizer_state_dtype='bfloat16'`` (``adam``/``adamw`` only) is
  :class:`AdamLowp`: the JAX package's ``scale_by_adam_lowp`` chain, both
  moments stored in bf16 and every step computed in fp32.
- ``lamb`` is :class:`Lamb`, optax's ``lamb(lr, weight_decay=wd)`` chain
  step for step.
- ``max_grad_norm > 0`` clips by the global norm as optax does (kept
  below the norm, ``g / norm * max_norm`` above it);
  ``gradient_accumulation_steps`` averages micro-batch gradients into one
  update (optax ``MultiSteps``); both are applied by the trainer at
  update time.
- Over a mesh (``parallel/sharding.py``) the parameters, gradients and
  moments are DTensors. The elementwise updates (Adam, AdamW,
  ``AdamLowp``, LAMB's Adam part) run on each rank's shard. What is a
  whole-parameter quantity stays one: the global norm of the clip and
  LAMB's trust-ratio norms sum each shard's squares over the mesh dims
  that shard it (:func:`_whole_norms`), and Adafactor gathers a sharded
  parameter and its gradient whole, so its factored row and column
  statistics are those of the whole parameter (its state is then whole on
  every rank).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.config import TrainConfig
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.sharding import (
    full_tensor,
    is_dtensor,
    local_tensor,
    shard_like,
)


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
        # a sharded parameter is updated whole (the row and column
        # statistics span every shard), then each rank keeps its shard
        whole = is_dtensor(p)
        g = (full_tensor(p.grad) if whole else p.grad).float()
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
        p32 = (full_tensor(p) if whole else p).float()
        rms = torch.sqrt((p32 * p32).mean())
        u = u * torch.where(rms <= ADAFACTOR_MIN_SCALE, ADAFACTOR_MIN_SCALE, rms)
        if whole:
            local_tensor(p).copy_(shard_like((p32 - u).to(p.dtype), p))
        else:
            p.copy_((p32 - u).to(p.dtype))


# the fp32 working copies a foreach pass of AdamLowp or Lamb holds at once
# are those of at most this many parameter elements (a larger tensor is a
# run of its own): the update's transient memory stays small next to the
# moments it halves
FOREACH_BUCKET = 1 << 25


def _buckets(params, limit: int = FOREACH_BUCKET):
    """``params`` in order, cut into runs of at most ``limit`` elements."""
    run, n = [], 0
    for p in params:
        if run and n + p.numel() > limit:
            yield run
            run, n = [], 0
        run.append(p)
        n += p.numel()
    if run:
        yield run


def _fp32(tensors) -> list:
    """``tensors`` as fp32 (the same tensors where they already are)."""
    return [t if t.dtype == torch.float32 else t.float() for t in tensors]


def _locals(tensors) -> list:
    """Each rank's shard of ``tensors`` (the tensors themselves off a
    mesh): the elementwise updates run on these, in place."""
    return [local_tensor(t) for t in tensors]


def _whole_norms(tensors, like) -> torch.Tensor:
    """The L2 norm of each of ``tensors`` (rank-local shards, fp32) as a
    whole: where ``like[i]`` is a DTensor, the shard's sum of squares summed
    over every mesh dim that shards it (one all-reduce per mesh dim and
    layout); where none is, ``torch._foreach_norm`` as before."""
    if not any(is_dtensor(t) for t in like):
        return torch.stack(torch._foreach_norm(tensors))
    sq = torch.stack([torch.sum(t * t) for t in tensors])
    layouts: dict = {}
    for i, t in enumerate(like):
        if is_dtensor(t):
            dims = tuple(d for d, pl in enumerate(t.placements) if not pl.is_replicate())
            if dims:
                layouts.setdefault((id(t.device_mesh), dims), (t.device_mesh, []))[1].append(i)
    for (_, dims), (mesh, idx) in layouts.items():
        part = sq[idx]
        for d in dims:
            dist.all_reduce(part, group=mesh.get_group(d))
        sq[idx] = part
    return torch.sqrt(sq)


def _moments(opt, run, dtype) -> tuple[list, list, list]:
    """The states of ``run`` (made on a parameter's first step: ``step`` 0
    and zero moments of ``dtype``), each step count advanced; returns
    (states, first moments, second moments)."""
    states = []
    for p in run:
        st = opt.state[p]
        if not st:
            st["step"] = 0
            st["exp_avg"] = torch.zeros_like(p, dtype=dtype)
            st["exp_avg_sq"] = torch.zeros_like(p, dtype=dtype)
        st["step"] += 1
        states.append(st)
    return states, [st["exp_avg"] for st in states], [st["exp_avg_sq"] for st in states]


def _bias_correction(decay: float, step: int) -> float:
    """``1 - decay^step`` in fp32, as optax and the JAX package compute it
    (``decay`` rounded to fp32 first: 1 - 0.999 is 1.3e-5 off in fp32, a
    difference that would show in the first steps' updates)."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(step))


def _adam_direction(m, v, grads, states, b1: float, b2: float, eps: float) -> list:
    """In place on the fp32 moments ``m``/``v``: ``m = b1 m + (1 - b1) g``,
    ``v = b2 v + (1 - b2) g²``; returns Adam's bias-corrected direction
    ``(m / bc1) / (sqrt(v / bc2) + eps)`` (each parameter's own step count,
    :func:`_bias_correction`)."""
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, grads, alpha=1.0 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
    denom = torch._foreach_div(v, [_bias_correction(b2, st["step"]) for st in states])
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    direction = torch._foreach_div(m, [_bias_correction(b1, st["step"]) for st in states])
    torch._foreach_div_(direction, denom)
    return direction


def _apply(run, p32, update, lr: float) -> None:
    """``p -= lr * update`` (``run`` rank-local), written back where the
    parameter is not fp32."""
    torch._foreach_add_(p32, update, alpha=-lr)
    for p, q in zip(run, p32):
        if q is not p:
            p.copy_(q)


class AdamLowp(torch.optim.Optimizer):
    """The JAX package's bf16-moment Adam (``scale_by_adam_lowp``, then
    ``add_decayed_weights`` for ``adamw`` with ``weight_decay > 0``, then
    the learning rate), over the parameters in foreach runs of
    :data:`FOREACH_BUCKET` elements:

    1. the stored moments upcast to fp32;
    2. ``m = b1 m + (1 - b1) g`` and ``v = b2 v + (1 - b2) g²`` in fp32;
    3. the update ``(m / bc1) / (sqrt(v / bc2) + eps)`` from those fp32
       values (``bc = 1 - b^t`` at step ``t`` from 1), plus ``wd * p``;
    4. ``p -= lr * update``, and only then m and v rounded to
       ``state_dtype`` for storage.

    ``state_dict()`` holds the moments in ``state_dtype`` and the step
    count; :meth:`load_state_dict` keeps that dtype (torch's casts a loaded
    state to the parameter's), so a resume is bitwise. A parameter without
    a gradient is skipped, as torch's Adam skips it."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, state_dtype=torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.state_dtype = state_dtype

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            (b1, b2), wd = group["betas"], group["weight_decay"]
            for run in _buckets([p for p in group["params"] if p.grad is not None]):
                states, m_low, v_low = _moments(self, run, self.state_dtype)
                m_low, v_low, local = _locals(m_low), _locals(v_low), _locals(run)
                m = [torch.empty_like(t, dtype=torch.float32) for t in m_low]
                v = [torch.empty_like(t, dtype=torch.float32) for t in v_low]
                torch._foreach_copy_(m, m_low)
                torch._foreach_copy_(v, v_low)
                p32 = _fp32(local)
                update = _adam_direction(m, v, _fp32(_locals([p.grad for p in run])),
                                         states, b1, b2, group["eps"])
                if wd > 0:
                    torch._foreach_add_(update, p32, alpha=wd)
                _apply(local, p32, update, group["lr"])
                torch._foreach_copy_(m_low, m)
                torch._foreach_copy_(v_low, v)

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for st in self.state.values():
            for k in ("exp_avg", "exp_avg_sq"):
                st[k] = st[k].to(self.state_dtype)


class Lamb(torch.optim.Optimizer):
    """optax ``lamb(learning_rate, weight_decay=wd)`` (optax 0.2.6's
    defaults), over the parameters in foreach runs of
    :data:`FOREACH_BUCKET` elements:

    1. ``scale_by_adam`` with b1 0.9, b2 0.999, eps 1e-6 and eps_root 0,
       fp32 moments;
    2. ``add_decayed_weights(wd)`` with no mask: every parameter, biases
       and layer norms too, takes ``+ wd * p``;
    3. ``scale_by_trust_ratio``: each tensor's update times ``‖p‖ / ‖u‖``,
       or 1 where either norm is 0 (both norms of a run from
       ``torch._foreach_norm``, no host sync; a sharded tensor's norms are
       its whole norms, :func:`_whole_norms`);
    4. ``p -= lr * update``.

    The state (``step``, ``exp_avg``, ``exp_avg_sq``) goes through
    ``state_dict()``. A parameter without a gradient is skipped."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            (b1, b2), wd = group["betas"], group["weight_decay"]
            for run in _buckets([p for p in group["params"] if p.grad is not None]):
                states, m, v = _moments(self, run, torch.float32)
                m, v, local = _locals(m), _locals(v), _locals(run)
                p32 = _fp32(local)
                update = _adam_direction(m, v, _fp32(_locals([p.grad for p in run])),
                                         states, b1, b2, group["eps"])
                if wd > 0:
                    torch._foreach_add_(update, p32, alpha=wd)
                p_norm = _whole_norms(p32, run)
                u_norm = _whole_norms(update, run)
                ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                                    p_norm / u_norm)
                torch._foreach_mul_(update, list(ratio.unbind()))
                _apply(local, p32, update, group["lr"])


def build_optimizer(config: TrainConfig, params, world_size: int = 1,
                    total_steps: Optional[int] = None):
    """Returns ``(torch optimizer, schedule, scaled base lr)``; the caller
    sets each update's learning rate from ``schedule`` (see
    :func:`set_lr`). The config has already refused bf16 state with
    ``lamb`` or ``adafactor``."""
    schedule, lr = lr_schedule(config, world_size, total_steps)
    params = list(params)
    decay = config.weight_decay if config.optimizer == "adamw" else 0.0
    if config.optimizer == "adafactor":
        opt = Adafactor(params, lr=schedule(0))
    elif config.optimizer == "lamb":
        opt = Lamb(params, lr=schedule(0), weight_decay=config.weight_decay)
    elif config.optimizer_state_dtype == "bfloat16":
        opt = AdamLowp(params, lr=schedule(0), weight_decay=decay)
    elif decay > 0:
        opt = torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=decay)
    else:
        opt = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8)
    return opt, schedule, lr


def set_lr(optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def global_norm(params) -> torch.Tensor:
    """optax ``global_norm`` of the ``.grad`` of ``params`` (a device
    scalar, no host sync; over sharded gradients the whole norm)."""
    grads = [p.grad for p in params if p.grad is not None]
    if any(is_dtensor(g) for g in grads):
        return torch.linalg.vector_norm(_whole_norms(_fp32(_locals(grads)), grads))
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))


def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place and without a host sync; returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = global_norm(params)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in _locals(grads):
        g.mul_(factor.to(g.dtype))
    return norm
