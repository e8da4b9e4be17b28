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
"""

from __future__ import annotations

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
