"""The replica-divergence check (counterpart of the JAX package's
``parallel/collectives.py`` ``param_fingerprint``,
``make_replica_divergence_fn`` and ``ReplicaDivergenceError``).

Data parallelism keeps one replica of the parameters on every rank and
assumes they stay equal. Every rank computes one checksum of its own
parameters (the sum of squares, in fp32 per tensor, accumulated in
fp64); one all-reduce gathers them, and the relative deviation is
``max |c_r - mean(c)| / max |c_r|``: 0.0 when the replicas agree bit for
bit. The trainer runs it before each checkpoint save, so a divergent
replica is never persisted silently. Over a mesh the checksum is of each
rank's own shards and compares the ``data`` replicas of each shard only
(``group``): the ``fsdp`` and ``tensor`` ranks hold different shards.

Sequence parallelism's two collectives live here too: :func:`ring_shift`
(JAX ``ppermute_shift``), which hands ring attention's K/V block to the
next rank of the ``seq`` axis, and :func:`gather_along`, which gathers the
sequence shards back before the heads.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.distributed import (
    gather_scalars,
    world_size,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.sharding import (
    local_tensor,
)


class ReplicaDivergenceError(RuntimeError):
    """Raised when the parameter replicas disagree across the ranks."""


def param_fingerprint(params) -> torch.Tensor:
    """Scalar fp64 checksum of ``params`` (this rank's shard of a
    DTensor): the sum of squares, computed in fp32 per tensor on its
    device."""
    return torch.stack([torch.sum(local_tensor(p.detach()).float() ** 2).double()
                        for p in params]).sum()


def replica_divergence(params, group=None) -> float:
    """The relative deviation of this rank's parameter checksum from the
    other ranks' of ``group`` (all ranks when None; a collective: every
    rank must call it). 0.0 with one rank."""
    n = world_size() if group is None else dist.get_world_size(group)
    if n == 1:
        return 0.0
    mine = param_fingerprint(params)
    grid = gather_scalars(mine, mine.device, group)
    dev = torch.max(torch.abs(grid - grid.mean()))
    scale = torch.clamp(torch.max(torch.abs(grid)), min=1e-30)
    return float(dev / scale)


# -- sequence parallelism: the ring shift and the gather over ``seq`` ------------------

#: this process's ring shifts: how many, and the host seconds spent in them
#: (a shift over gloo copies a CUDA tensor through the host, which waits
#: there for the kernels queued before the copy)
RING_SHIFTS = {"calls": 0, "seconds": 0.0}


def _backend(group) -> str:
    if not dist.is_initialized():
        raise RuntimeError("a collective over the seq axis needs a process group")
    backend = dist.get_backend(group)
    if backend not in ("gloo", "nccl"):
        raise RuntimeError(f"no ring collectives over a {backend!r} process group "
                           "(gloo or nccl)")
    return backend


def _on_host(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous CPU tensor, a CUDA one copied into pinned host
    memory (gloo's point-to-point calls take CPU tensors only)."""
    if not x.is_cuda:
        return x.contiguous()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """What rank ``(i - shift) mod n`` of ``group`` holds of ``x``; this
    rank's ``x`` goes to rank ``(i + shift) mod n``. Both halves are posted
    before either is waited on (a ring whose ranks all send first would
    deadlock)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    t0 = time.perf_counter()
    backend = _backend(group)
    i = dist.get_rank(group)
    dst = dist.get_global_rank(group, (i + shift) % n)
    src = dist.get_global_rank(group, (i - shift) % n)
    if backend == "nccl":
        send = x.contiguous()
        recv = torch.empty_like(send)
        works = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, group),
                                        dist.P2POp(dist.irecv, recv, src, group)])
    else:
        send = _on_host(x)
        recv = torch.empty(send.shape, dtype=send.dtype, pin_memory=x.is_cuda)
        works = [dist.isend(send, dst, group=group), dist.irecv(recv, src, group=group)]
    for work in works:
        work.wait()
    out = recv if backend == "nccl" else recv.to(x.device)
    RING_SHIFTS["calls"] += 1
    RING_SHIFTS["seconds"] += time.perf_counter() - t0
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -ctx.shift), None, None


def ring_shift(x: torch.Tensor, group, shift: int = -1) -> torch.Tensor:
    """The ring shift over ``group`` (JAX ``ppermute_shift``): rank ``i``
    sends ``x`` to rank ``(i + shift) mod n`` and returns what rank ``(i -
    shift) mod n`` sent. Differentiable: the backward shifts the gradient
    the other way. NCCL takes the tensors as they are; gloo takes CPU
    tensors only, so a CUDA tensor goes through pinned host memory."""
    return _RingShift.apply(x, group, shift)


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if _backend(group) == "nccl":
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, src, group=group)
        return out.movedim(0, dim)
    src = _on_host(x)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _reduce_scatter_sum(grad: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    part = grad.shape[dim] // n
    if _backend(group) == "nccl":
        src = grad.movedim(dim, 0).contiguous()
        out = torch.empty((part,) + tuple(src.shape[1:]), dtype=grad.dtype,
                          device=grad.device)
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim)
    # gloo has no reduce-scatter: the sum, and this rank's block of it
    total = _on_host(grad).clone()
    dist.all_reduce(total, group=group)
    rank = dist.get_rank(group)
    return total.narrow(dim, rank * part, part).to(grad.device)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_sum(grad, ctx.group, ctx.dim), None, None


def gather_along(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in rank
    order. Differentiable: the backward sums the gradients over the ranks
    and hands each its own block (a reduce-scatter)."""
    if dist.get_world_size(group) == 1:
        return x
    return _GatherSeq.apply(x, group, dim)
