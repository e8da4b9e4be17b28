"""The device mesh (counterpart of the JAX package's ``parallel/mesh.py``).

The JAX package names seven axes and reshapes its devices row-major into
``(dcn, data, fsdp, expert, pipe, seq, tensor)``. The port keeps the names,
``data_axis_names()`` and ``MeshConfig.resolve`` with the JAX errors, and
builds a ``torch.distributed.device_mesh.DeviceMesh`` over the four axes it
runs today, in the JAX order with the others left out: ``data`` (plain
replicas), ``fsdp`` (FSDP2's parameter shards; over ``data`` × ``fsdp`` it
is HSDP), ``seq`` (sequence parallelism: ring attention,
``parallel/ring_attention.py``) and ``tensor`` (Megatron tensor
parallelism, ``parallel/sharding.py``). Ranks are laid out row-major with
``data`` outermost and ``tensor`` innermost, the JAX device order, so rank
``r`` holds what JAX device ``r`` of the same mesh holds.

Two sizes differ once ``seq`` or ``tensor`` > 1: :func:`world_size` counts
every rank (MFU is per chip), :func:`data_parallel_size` counts the
replicas of a batch (``dcn × data × fsdp × expert``): the ``seq`` and
``tensor`` ranks of one replica share its rows. The loss, the gradient
scale and the learning-rate scale use the latter. :func:`seq_group` and
:func:`seq_rank` are the ``seq`` axis's group and this rank's coordinate on
it.

Tensor-parallel serving has a mesh of its own, :func:`tensor_parallel_mesh`:
one ``tensor`` dim over the ``tp`` ranks of the process group (JAX's ``dp=1 ×
tp`` serving mesh), cached per degree.

Not ported yet, each raising ``NotImplementedError`` that names ROADMAP
queue 1, item 11: ``dcn_dp > 1``, ``pp`` and ``ep`` meshes and
:func:`shard_map_compat`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from datetime import timedelta

AXIS_DCN = "dcn"
AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_EXPERT = "expert"
AXIS_PIPE = "pipe"
AXIS_TENSOR = "tensor"
AXIS_SEQ = "seq"

MESH_AXES = (AXIS_DCN, AXIS_DATA, AXIS_FSDP, AXIS_EXPERT, AXIS_PIPE,
             AXIS_SEQ, AXIS_TENSOR)

# the axes the port's DeviceMesh has, outermost first
PORTED_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_SEQ, AXIS_TENSOR)


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet: ROADMAP queue 1, "
        "item 11 (parallelism beyond DP)")


def data_axis_names() -> tuple[str, ...]:
    """Axes over which a global batch is sharded; ``seq`` and ``tensor``
    are not among them."""
    return (AXIS_DCN, AXIS_DATA, AXIS_FSDP, AXIS_EXPERT)


@dataclass(frozen=True)
class MeshConfig:
    """Mesh shape request. ``dp=-1`` absorbs all remaining devices."""

    dp: int = -1
    fsdp: int = 1
    ep: int = 1
    pp: int = 1
    tp: int = 1
    sp: int = 1
    dcn_dp: int = 1

    def resolve(self, n_devices: int) -> tuple[int, ...]:
        """The seven axis sizes in ``MESH_AXES`` order (the JAX errors)."""
        fixed = (self.dcn_dp * self.fsdp * self.ep * self.pp * self.tp
                 * self.sp)
        if n_devices % fixed != 0:
            raise ValueError(
                f"dcn_dp*fsdp*ep*pp*tp*sp={fixed} does not divide device "
                f"count {n_devices}"
            )
        dp = self.dp if self.dp != -1 else n_devices // fixed
        if dp * fixed != n_devices:
            raise ValueError(
                f"mesh {self.dcn_dp}x{dp}x{self.fsdp}x{self.ep}x{self.pp}"
                f"x{self.sp}x{self.tp} != {n_devices} devices"
            )
        return (self.dcn_dp, dp, self.fsdp, self.ep, self.pp, self.sp,
                self.tp)


# the ambient mesh, strictly LIFO (use the context manager); the JAX
# package's API: a tensor-parallel ServeEngine runs its device work under its
# mesh (the Trainer holds its mesh on the sharded model, ``model.mesh``)
_CURRENT_MESH: list = []


def current_mesh():
    if not _CURRENT_MESH:
        raise RuntimeError(
            "no ambient mesh set — wrap the code that reads it in "
            "parallel.mesh.use_mesh(mesh)")
    return _CURRENT_MESH[-1]


def maybe_current_mesh():
    return _CURRENT_MESH[-1] if _CURRENT_MESH else None


class use_mesh:
    """Push an ambient mesh for the duration of a block (LIFO)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        _CURRENT_MESH.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _CURRENT_MESH.pop()


def build_mesh(config: MeshConfig | None = None, device_type: str = "cuda",
               timeout: timedelta | None = None):
    """A ``DeviceMesh`` over every rank of the joined process group, with
    named dims ``("data", "fsdp", "seq", "tensor")``, ranks row-major. Each dim's
    process group is made here with ``timeout`` (the job's
    ``PROCESS_GROUP_TIMEOUT`` when None), so a collective over any axis
    fails after it instead of waiting for a rank that never comes. Needs
    the process group up (``parallel.distributed.initialize_distributed``,
    or ``torch.distributed.init_process_group`` with a ``timeout``)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.distributed import (
        PROCESS_GROUP_TIMEOUT,
        mesh_group,
    )

    config = config or MeshConfig()
    for size, what in ((config.dcn_dp, "dcn_dp>1"), (config.pp, "pp>1"),
                       (config.ep, "ep>1")):
        if size > 1:
            raise _unported(what)
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a process group: call "
                           "parallel.distributed.initialize_distributed first")
    _, dp, fsdp, _, _, sp, tp = config.resolve(dist.get_world_size())
    timeout = timeout or PROCESS_GROUP_TIMEOUT
    grid = torch.arange(dp * fsdp * sp * tp).reshape(dp, fsdp, sp, tp)
    groups = []
    for dim in range(grid.dim()):
        rest = [d for d in range(grid.dim()) if d != dim]
        rows = grid.permute(*rest, dim).reshape(-1, grid.shape[dim]).tolist()
        mine, _ = dist.new_subgroups_by_enumeration(rows, timeout=timeout)
        groups.append(mine)
    mesh = DeviceMesh.from_group(groups, device_type, mesh=grid, mesh_dim_names=PORTED_AXES)
    # the data-parallel group (the loss sums, the batch's replicas), made now
    # with the same timeout
    mesh_group(mesh, (AXIS_DATA, AXIS_FSDP), timeout)
    return mesh


def mesh_shape(mesh) -> dict:
    """Every one of ``MESH_AXES`` with its size (1 for an axis the mesh
    does not have), the JAX ``mesh.shape``."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return {ax: int(sizes.get(ax, 1)) for ax in MESH_AXES}


# tensor_parallel_mesh's meshes: (degree, device type, process group) -> mesh
_TP_MESHES: dict = {}


def tensor_parallel_mesh(tp: int, device_type: str | None = None,
                         timeout: timedelta | None = None):
    """Tensor-parallel serving's mesh (JAX ``tensor_parallel_mesh``): a
    ``DeviceMesh`` with the one dim ``("tensor",)`` over the ``tp`` ranks
    of the joined process group, rank ``r`` holding shard ``r``. Its dim
    group is made here with ``timeout`` (the job's
    ``PROCESS_GROUP_TIMEOUT`` when None), so a collective fails after it
    when a rank does not come. Cached per degree and device type (``cuda``
    when None and the card is there, else ``cpu``) for the life of the
    process group: every caller of one degree gets the same mesh. Raises
    ``ValueError`` naming the world size when no process group of ``tp``
    ranks is up."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.distributed import (
        PROCESS_GROUP_TIMEOUT,
    )

    if tp < 1:
        raise ValueError(f"tensor-parallel degree must be >= 1, got {tp}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != tp or not dist.is_initialized():
        raise ValueError(
            f"tensor-parallel degree {tp} needs a process group of {tp} ranks, "
            f"the world has {world}: start one process per rank (torchrun "
            "or the port's launcher)")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    key = (tp, device_type, id(dist.group.WORLD))
    if key not in _TP_MESHES:
        group = dist.new_group(list(range(tp)), timeout=timeout or PROCESS_GROUP_TIMEOUT)
        _TP_MESHES[key] = DeviceMesh.from_group(group, device_type, mesh=torch.arange(tp),
                                                mesh_dim_names=(AXIS_TENSOR,))
    return _TP_MESHES[key]


def shard_map_compat(fn, *, mesh, in_specs, out_specs, check_vma=None):
    """JAX ``shard_map_compat``: the port shards through FSDP2 and DTensor,
    not ``shard_map``."""
    raise _unported("shard_map_compat")


def seq_group(mesh):
    """The process group of ``mesh``'s ``seq`` axis that holds this rank."""
    return mesh.get_group(AXIS_SEQ)


def seq_rank(mesh) -> int:
    """This rank's coordinate on ``mesh``'s ``seq`` axis (0 when the mesh has
    no such dim)."""
    if AXIS_SEQ not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(AXIS_SEQ)


def world_size(mesh) -> int:
    """Total rank count (``hvd.size()``)."""
    return math.prod(mesh_shape(mesh).values())


def data_parallel_size(mesh) -> int:
    """Number of data-parallel replicas (dcn × data × fsdp × expert)."""
    shape = mesh_shape(mesh)
    return math.prod(shape[ax] for ax in data_axis_names())
