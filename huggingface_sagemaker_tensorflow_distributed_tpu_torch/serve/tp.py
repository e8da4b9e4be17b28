"""Tensor-parallel serving's ranks: how one engine runs over ``tp`` processes.

The JAX engine has one controller: its scheduler, block manager, prefix
cache and clocks run once, and every step it dispatches is SPMD over the
mesh. The port has one process per rank, and the scheduler's choices depend
on the wall clock (SLO aging, the timeline's stamps, the dispatch-ahead
loop's flushes, swap), so ranks that each scheduled for themselves could
part ways and leave the next collective waiting for a rank that never
comes. So only rank 0 (the leader) runs the engine. Every operation the
engine runs on its model or its pools goes through :meth:`Control.send`
first: a short descriptor (the operation's name and its host arguments:
token ids, positions, block tables, context lengths, sampling parameters,
block ids, a block set) broadcast over a CPU process group, which the other
ranks (the followers, :meth:`~.engine.ServeEngine.follow`) receive and run
on their own shards of the weights and pools. The ranks therefore run the
same operations in the same order on the same inputs, and the collectives
inside them (the row-parallel layers' all-reduces) pair up. The followers'
loop ends at the stop descriptor the leader sends when its engine closes, or
fails when no descriptor comes within the group's timeout.

Block sets leave the pools whole (JAX's ``device_get`` of a head-sharded
pool assembles every head): each rank extracts its heads and the leader
gathers them along the heads axis (:meth:`Control.gather`); an insert sends
the whole set and each rank scatters its heads (:func:`heads_of`).
"""

from __future__ import annotations

import time
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.paged_kv import BlockSet

#: the descriptor that ends the followers' loop
STOP = "stop"

# the control groups made for meshes: id(mesh) -> group
_CONTROL: dict = {}


def control_group(mesh, timeout: Optional[timedelta] = None):
    """The CPU (gloo) process group over ``mesh``'s ranks that carries the
    descriptors and the block sets: the mesh's own group when it is gloo,
    else a gloo group made once per mesh with ``timeout`` (the job's
    ``PROCESS_GROUP_TIMEOUT`` when None). Every rank calls it in the same
    order (a new group is a collective)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.distributed import (
        PROCESS_GROUP_TIMEOUT,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.mesh import (
        AXIS_TENSOR,
    )

    key = id(mesh)
    if key not in _CONTROL:
        group = mesh.get_group(AXIS_TENSOR)
        if dist.get_backend(group) != "gloo":
            group = dist.new_group(dist.get_process_group_ranks(group),
                                   timeout=timeout or PROCESS_GROUP_TIMEOUT, backend="gloo")
        _CONTROL[key] = group
    return _CONTROL[key]


class Control:
    """One rank's end of the descriptor channel over ``group`` (``tp``
    ranks, the leader rank 0 of the group)."""

    def __init__(self, group, tp: int, rank: int):
        self.group, self.tp, self.rank = group, tp, rank
        self.leader = rank == 0
        self._src = dist.get_global_rank(group, 0)
        self.sent = 0
        self.send_s = 0.0
        self.closed = False

    def send(self, op: str, args: tuple) -> None:
        """The leader's descriptor for one operation (``sent`` counts them,
        ``send_s`` sums their host seconds)."""
        t0 = time.perf_counter()
        dist.broadcast_object_list([(op, args)], src=self._src, group=self.group)
        self.sent += 1
        self.send_s += time.perf_counter() - t0

    def receive(self) -> tuple:
        """A follower's next ``(op, args)``; raises when none comes within
        the group's timeout."""
        box = [None]
        dist.broadcast_object_list(box, src=self._src, group=self.group)
        return box[0]

    def gather(self, sets: list) -> Optional[list]:
        """Every rank's block sets (one per id list, this rank's heads) ->
        on the leader the whole sets, each pool's heads in rank order; None
        on the followers."""
        parts = [None] * self.tp if self.leader else None
        dist.gather_object(sets, parts, dst=self._src, group=self.group)
        if not self.leader:
            return None
        return [_joined([p[i] for p in parts]) for i in range(len(sets))]


def _joined(shards: list) -> BlockSet:
    """One block set from the ranks' sets of the same blocks (heads axis 2)."""
    def cat(groups):
        return tuple(torch.cat(ps, dim=2) for ps in zip(*groups))
    draft = None if shards[0].draft_payloads is None else cat([s.draft_payloads for s in shards])
    return BlockSet(cat([s.payloads for s in shards]), draft)


def heads_of(bset: BlockSet, rank: int, tp: int) -> BlockSet:
    """Rank ``rank``'s heads of a whole block set (itself at ``tp`` 1)."""
    if tp == 1:
        return bset

    def cut(ps):
        out = []
        for p in ps:
            h = p.shape[2] // tp
            out.append(p.narrow(2, rank * h, h).contiguous())
        return tuple(out)
    return BlockSet(cut(bset.payloads),
                    None if bset.draft_payloads is None else cut(bset.draft_payloads))
