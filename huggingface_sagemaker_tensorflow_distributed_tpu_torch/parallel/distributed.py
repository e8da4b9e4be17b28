"""Multi-process initialization and the data-parallel reductions
(counterpart of the JAX package's ``parallel/distributed.py``).

A job of several processes names its rendezvous in the environment: the
JAX package's triplet ``TPU_COORDINATOR_ADDRESS`` (``host:port``),
``TPU_NUM_PROCESSES``, ``TPU_PROCESS_ID``, or torch's own
``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``.
:func:`initialize_distributed` then starts a ``torch.distributed``
process group over TCP: NCCL on CUDA, gloo on the CPU. With one process
nothing is initialized.

Data parallelism is one explicit all-reduce of the flattened gradients
after backward, divided by the world size, so every rank applies the
gradient of the global-batch mean loss, as the JAX package's sharded
global mean does.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _rendezvous() -> tuple[str, int, int] | None:
    """(tcp init address, world size, rank) from the environment, or None."""
    coord = os.environ.get("TPU_COORDINATOR_ADDRESS")
    nproc = os.environ.get("TPU_NUM_PROCESSES")
    pid = os.environ.get("TPU_PROCESS_ID")
    if coord and nproc and pid:
        return f"tcp://{coord}", int(nproc), int(pid)
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    world, rank = os.environ.get("WORLD_SIZE"), os.environ.get("RANK")
    if addr and port and world and rank:
        return f"tcp://{addr}:{port}", int(world), int(rank)
    return None


def initialize_distributed(device_type: str = "cuda") -> tuple[int, int]:
    """Join the process group the environment names (no-op when already
    joined or with one process). Returns ``(rank, world_size)``. On CUDA
    each process takes the card ``LOCAL_RANK`` (else ``rank`` modulo the
    visible cards)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    spec = _rendezvous()
    if spec is None or spec[1] <= 1:
        return 0, 1
    init_method, world, rank = spec
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=init_method, world_size=world, rank=rank)
    obs.set_host(rank, world)
    logger.info("distributed init: rank %d/%d via %s", rank, world, init_method)
    return rank, world


def local_device(device_type: str) -> torch.device:
    """This process's device: its current card on CUDA, else the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def all_reduce_mean_grads(params) -> None:
    """Average ``.grad`` over the ranks in one flat all-reduce (no-op with
    one process)."""
    if world_size() == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat.div_(world_size())
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks (``t`` itself with one process)."""
    if world_size() > 1:
        dist.all_reduce(t)
    return t


def gather_scalars(value, device=None) -> torch.Tensor:
    """Every rank's ``value`` as one fp64 vector in rank order (a
    collective; ``device`` is where it lives, the card under NCCL)."""
    vals = torch.zeros(world_size(), dtype=torch.float64, device=device)
    vals[rank()] = value
    if world_size() > 1:
        dist.all_reduce(vals)
    return vals


def host_step_stats(step_seconds: float, device=None) -> Optional[dict]:
    """Every rank's mean step time, for straggler visibility: ``{n_hosts,
    min, max, mean, straggler_ratio, argmax}`` (a collective with several
    ranks: every rank calls it under the same condition). None when the
    value is not a finite number yet."""
    v = float(step_seconds)
    if not math.isfinite(v):
        return None
    world = world_size()
    if world == 1:
        return {"n_hosts": 1, "min": v, "max": v, "mean": v,
                "straggler_ratio": 1.0, "argmax": 0}
    vals = gather_scalars(v, device)
    mean = float(vals.mean())
    return {"n_hosts": world, "min": float(vals.min()), "max": float(vals.max()),
            "mean": mean, "straggler_ratio": float(vals.max()) / max(mean, 1e-12),
            "argmax": int(vals.argmax())}


def agree_compile_budget_crossed(local_crossed: bool, device=None) -> bool:
    """True when any rank's compile tracker has crossed
    ``HSTD_COMPILE_BUDGET_S``: a MAX all-reduce of the local flag (a
    collective; ``device`` is where the flag lives, the card under NCCL).
    The budget is crossed at a rank-local instant, so the ranks agree on
    the crossing at an epoch boundary and their bucket ladders cap at the
    same step. With one process, the local flag."""
    if world_size() == 1:
        return bool(local_crossed)
    flag = torch.tensor([1.0 if local_crossed else 0.0], dtype=torch.float64,
                        device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item() > 0.5)
