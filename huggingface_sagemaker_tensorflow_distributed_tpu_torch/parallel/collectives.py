"""The replica-divergence check (counterpart of the JAX package's
``parallel/collectives.py`` ``param_fingerprint``,
``make_replica_divergence_fn`` and ``ReplicaDivergenceError``).

Data parallelism keeps one replica of the parameters on every rank and
assumes they stay equal. Every rank computes one checksum of its own
parameters (the sum of squares, in fp32 per tensor, accumulated in
fp64); one all-reduce gathers them, and the relative deviation is
``max |c_r - mean(c)| / max |c_r|``: 0.0 when the replicas agree bit for
bit. The trainer runs it before each checkpoint save, so a divergent
replica is never persisted silently.
"""

from __future__ import annotations

import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.distributed import (
    gather_scalars,
    world_size,
)


class ReplicaDivergenceError(RuntimeError):
    """Raised when the parameter replicas disagree across the ranks."""


def param_fingerprint(params) -> torch.Tensor:
    """Scalar fp64 checksum of ``params``: the sum of squares, computed in
    fp32 per tensor on its device."""
    return torch.stack([torch.sum(p.detach().float() ** 2).double()
                        for p in params]).sum()


def replica_divergence(params) -> float:
    """The relative deviation of this rank's parameter checksum from the
    other ranks' (a collective: every rank must call it). 0.0 with one
    rank."""
    if world_size() == 1:
        return 0.0
    mine = param_fingerprint(params)
    grid = gather_scalars(mine, mine.device)
    dev = torch.max(torch.abs(grid - grid.mean()))
    scale = torch.clamp(torch.max(torch.abs(grid)), min=1e-30)
    return float(dev / scale)
