"""Sharding rules: how parameters and batches map to the mesh (counterpart
of the JAX package's ``parallel/sharding.py``).

The JAX package matches parameter paths against ``_PARAM_RULES`` and lets
GSPMD insert the collectives. The port's rule table matches its module
paths and drives two wrappers, both applied by :func:`shard_model`:

- a tensor-parallel plan (``torch.distributed.tensor.parallel``) over the
  mesh's ``tensor`` dim, in the Megatron layout: QKV and FFN-in
  column-parallel (the output features over ``tensor``), attention-out and
  FFN-out row-parallel (the input features). A column-parallel layer's bias
  is cut with its output features (eager PyTorch adds it per shard; GSPMD
  slices the replicated JAX bias itself); a row-parallel layer's bias, the
  embeddings, the norms and the heads are not ``tensor``-sharded, as in
  JAX. Each rank computes the attention of its own heads, ``H / tp`` of
  them (K1 runs on those), so the plan is head-granular where JAX's rule
  is dim-granular: a head count that ``tp`` does not divide raises
  ``NotImplementedError`` naming ROADMAP queue 1, item 11;
- FSDP2 (``torch.distributed.fsdp.fully_shard``) over ``fsdp``, per layer
  and at the root; over ``data`` × ``fsdp`` it is HSDP (replicas over
  ``data``, shards over ``fsdp``).

GPT-2's fused ``qkv`` is laid out ``[q | k | v]``: a column shard of it
would give rank 0 all of q and part of k. :func:`shard_model` permutes the
fused weight to head-group-major order first, each ``tensor`` rank's slice
being the q, k and v of its own heads (``qkv_groups`` on the attention
module); :func:`export_state` permutes it back, so checkpoints keep the
mesh's layout and the HF export keeps its own.

The batch (JAX ``batch_sharding``): the data-parallel rank is its
coordinate over ``data`` × ``fsdp`` (:func:`data_parallel_rank`); the
``seq`` and ``tensor`` ranks of one replica take the same rows. The ``seq``
axis holds no parameter shard: FSDP2 shards over ``fsdp`` and replicates
over ``data`` alone, and the Trainer averages the ``seq`` ranks' gradient
shards itself (:func:`check_sequence_parallel` names what cannot run over
``seq`` yet).

Serving (JAX ``param_shardings`` and ``kv_pool_sharding`` under
``ServeEngine(mesh=...)``): :func:`shard_for_serving` cuts a GPT-2 or dense
Llama model in place over a :func:`~.mesh.tensor_parallel_mesh` with the same
rule table and the same qkv permutation, so training and serving put the same
heads on the same rank. It holds plain local tensors, not DTensors (a decode
step's host time is the serving bill): a column-parallel layer keeps its
rows of the weight and bias, a row-parallel layer its columns, and a forward
hook sums the partial outputs over ``tensor`` (one all-reduce) before the
bias is added once. Every rank then holds the same hidden states, the
replicated embeddings, norms and head compute the same logits, and the
attention runs on the rank's ``H / tp`` heads against K/V pools of
``num_kv_heads / tp`` heads (:func:`kv_pool_heads`).
"""

from __future__ import annotations

import re
import time
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_TENSOR,
    mesh_shape,
)

# (module path regex, Megatron role) — first match wins; a linear layer no
# rule names is not tensor-sharded (embeddings, norms, pooler, heads)
_PARAM_RULES = (
    (r"\.(query|key|value|q_proj|k_proj|v_proj|qkv)$", "column"),
    (r"\.(attention_out|o_proj|attn_out)$", "row"),
    (r"\.(intermediate|fc_in|gate_proj|up_proj)$", "column"),
    (r"\.(ffn_out|fc_out|down_proj)$", "row"),
)

# models whose tensor-parallel layout is a later part of item 11
_TP_LATER = (("T5", "T5"), ("Bart", "BART"), ("Deberta", "DeBERTa"),
             ("DistilBert", "DistilBERT"))

# the model methods besides ``forward`` that run the sharded modules (FSDP2
# all-gathers a unit's parameters around each registered method)
_FORWARD_METHODS = ("hidden_and_embedding", "seq2seq_hidden_and_embedding")


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet: ROADMAP queue 1, "
        "item 11 (parallelism beyond DP)")


def linear_role(module_path: str):
    """``"column"``, ``"row"`` or None for the module at ``module_path``."""
    for pattern, role in _PARAM_RULES:
        if re.search(pattern, "." + module_path):
            return role
    return None


def tensor_dim(param_name: str):
    """The dim of the parameter ``param_name`` (``nn.Linear`` layout,
    weight ``[out, in]``) that the ``tensor`` axis shards, or None."""
    module_path, leaf = param_name.rsplit(".", 1)
    role = linear_role(module_path)
    if role == "column":
        return 0
    if role == "row" and leaf == "weight":
        return 1
    return None


def _attention_heads(module) -> list[tuple[str, int]]:
    """``(what, count)`` of the head counts a tensor shard of ``module``
    must divide: the query heads, and the K/V heads under GQA."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.gpt2 import (
        Gpt2Attention,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.layers import (
        SelfAttention,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.llama import (
        LlamaAttention,
    )

    if isinstance(module, (SelfAttention, Gpt2Attention)):
        return [("num_heads", module.cfg.num_heads)]
    if isinstance(module, LlamaAttention):
        return [("num_heads", module.cfg.num_heads),
                ("num_kv_heads", module.cfg.num_kv_heads)]
    return []


def _tp_later(model: nn.Module):
    """What of ``model`` has its tensor-parallel layout in a later part of
    item 11 (its family, or its MoE layers), or None."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.moe import _Routed

    name = type(model).__name__
    for prefix, family in _TP_LATER:
        if name.startswith(prefix):
            return family
    for path, module in model.named_modules():
        if isinstance(module, _Routed):
            return f"MoE layers ({path})"
    return None


def check_tensor_parallel(model: nn.Module, tp: int) -> None:
    """Raise ``NotImplementedError`` (ROADMAP item 11) where ``model`` has
    no tensor-parallel layout over ``tp`` ranks yet: T5, BART, DeBERTa,
    DistilBERT, any MoE layer, and a head or FFN width ``tp`` does not
    divide."""
    if tp <= 1:
        return
    later = _tp_later(model)
    if later is not None:
        raise _unported(f"tp>1 with {later}")
    for path, module in model.named_modules():
        for what, count in _attention_heads(module):
            if count % tp:
                raise _unported(f"tp={tp} over {what}={count} ({path}: the heads "
                                "must divide over the tensor ranks)")
        if isinstance(module, nn.Linear) and linear_role(path):
            width = module.out_features if linear_role(path) == "column" else \
                module.in_features
            if width % tp:
                raise _unported(f"tp={tp} over a width of {width} ({path})")


# models whose sequence-parallel layout is a later part of item 11
_SP_LATER = (("Bart", "BART"), ("Deberta", "DeBERTa"))


def check_sequence_parallel(model: nn.Module, sp: int) -> None:
    """Raise ``NotImplementedError`` (ROADMAP item 11) where ``model`` has no
    sequence-parallel layout over ``sp`` ranks yet: BART, DeBERTa (no ring
    site in the JAX package either) and any MoE layer (its expert capacity
    follows the call's sequence length, which a rank's block would cut)."""
    if sp <= 1:
        return
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.moe import _Routed

    name = type(model).__name__
    for prefix, family in _SP_LATER:
        if name.startswith(prefix):
            raise _unported(f"sp>1 with {family}")
    for path, module in model.named_modules():
        if isinstance(module, _Routed):
            raise _unported(f"sp>1 with MoE layers ({path})")


def tensor_parallel_plan(model: nn.Module) -> dict:
    """``{module path: ColwiseParallel() | RowwiseParallel()}`` of every
    linear layer the rule table names."""
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

    plan = {}
    for path, module in model.named_modules():
        role = linear_role(path) if isinstance(module, nn.Linear) else None
        if role is not None:
            plan[path] = ColwiseParallel() if role == "column" else RowwiseParallel()
    return plan


# -- GPT-2's fused qkv -----------------------------------------------------------

def _qkv_order(width: int, groups: int) -> torch.Tensor:
    """Row order taking ``[q | k | v]`` (each ``width / 3``) to ``groups``
    slices of ``[q_g | k_g | v_g]``."""
    h = width // 3
    part = h // groups
    idx = torch.arange(width).view(3, groups, part)
    return idx.transpose(0, 1).reshape(-1)


@torch.no_grad()
def _permute_qkv(model: nn.Module, groups: int) -> None:
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.gpt2 import (
        Gpt2Attention,
    )

    for module in model.modules():
        if isinstance(module, Gpt2Attention) and groups > 1:
            order = _qkv_order(module.qkv.out_features, groups)
            # every tensor of the layer with the output features first: the
            # weight and bias, or an int8 layer's weight, scales and bias
            for p in module.qkv.parameters():
                p.copy_(p[order.to(p.device)])
            module.qkv_groups = groups


def canonical_state(model: nn.Module, state: dict) -> dict:
    """``state`` (a gathered ``state_dict`` of ``model``) with GPT-2's fused
    qkv back in its ``[q | k | v]`` layout."""
    out = dict(state)
    for path, module in model.named_modules():
        groups = getattr(module, "qkv_groups", 1)
        if groups > 1:
            inverse = torch.argsort(_qkv_order(module.qkv.out_features, groups))
            for leaf in ("weight", "bias"):
                key = f"{path}.qkv.{leaf}"
                if key in out:
                    out[key] = out[key][inverse.to(out[key].device)]
    return out


# -- the wrappers ------------------------------------------------------------------

def _fsdp_api():
    try:
        from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    except ImportError:          # torch before 2.6 keeps FSDP2 under _composable
        from torch.distributed._composable.fsdp import (
            fully_shard,
            register_fsdp_forward_method,
        )
    return fully_shard, register_fsdp_forward_method


def _fsdp_units(model: nn.Module) -> list[nn.Module]:
    """The per-layer FSDP2 units: every element of the model's module
    lists that holds parameters (a layer or block of each family)."""
    units = []
    for module in model.modules():
        if isinstance(module, nn.ModuleList):
            units += [m for m in module if any(True for _ in m.parameters())]
    return units


def data_parallel_mesh(mesh):
    """The mesh FSDP2 shards over: ``fsdp`` alone, or ``data`` × ``fsdp``
    (HSDP) when there are several replicas."""
    if mesh_shape(mesh)[AXIS_DATA] > 1:
        return mesh[AXIS_DATA, AXIS_FSDP]
    return mesh[AXIS_FSDP]


def shard_model(model: nn.Module, mesh, tensor_plan: bool = True) -> nn.Module:
    """Apply the tensor-parallel plan over ``tensor`` and FSDP2 over
    ``fsdp`` (HSDP with ``data``) to ``model`` in place, whatever the axes'
    sizes: a ``(1, 1, 1)`` mesh still wraps it (a family whose tensor
    layout is still to come takes FSDP2 alone, at ``tp`` 1). With
    ``tensor_plan`` False the plan is left out (``tp`` must be 1): FSDP2
    alone. FSDP2's mixed precision is not used: the model's own casts stay
    those of the DP path. Returns ``model``."""
    from torch.distributed.tensor.parallel import parallelize_module

    tp = mesh_shape(mesh)[AXIS_TENSOR]
    if not tensor_plan and tp > 1:
        raise ValueError(f"tensor_plan=False over tp={tp}: the plan is what shards tensor")
    check_tensor_parallel(model, tp)
    if tensor_plan and _tp_later(model) is None:     # tp is 1 for the others
        _permute_qkv(model, tp)
        parallelize_module(model, mesh[AXIS_TENSOR], tensor_parallel_plan(model))
    fully_shard, register_method = _fsdp_api()
    dp_mesh = data_parallel_mesh(mesh)
    for unit in _fsdp_units(model):
        fully_shard(unit, mesh=dp_mesh)
    fully_shard(model, mesh=dp_mesh)
    for name in _FORWARD_METHODS:
        if hasattr(model, name):
            register_method(model, name)
    model.mesh = mesh
    return model


def is_sharded(model: nn.Module) -> bool:
    return getattr(model, "mesh", None) is not None


def data_parallel_rank(mesh) -> int:
    """This rank's batch shard: its coordinate over ``data`` × ``fsdp``."""
    fsdp = mesh_shape(mesh)[AXIS_FSDP]
    return mesh.get_local_rank(AXIS_DATA) * fsdp + mesh.get_local_rank(AXIS_FSDP)


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def shard_like(whole: torch.Tensor, like) -> torch.Tensor:
    """This rank's shard of ``whole`` laid out as the DTensor ``like`` (every
    rank holds ``whole``: no communication)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(whole, like.device_mesh, like.placements,
                             src_data_rank=None).to_local()


def dtensor_like(whole: torch.Tensor, like):
    """``whole`` as a DTensor laid out as ``like`` (no communication)."""
    return DTensor.from_local(shard_like(whole, like), like.device_mesh, like.placements,
                              shape=like.shape, stride=like.stride())


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """``t`` whole: a DTensor gathered (a collective over its mesh), any
    other tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of ``t`` (``t`` itself when it is no DTensor)."""
    return t.to_local() if isinstance(t, DTensor) else t


def whole_on_rank0(t: torch.Tensor):
    """``t`` whole on rank 0's host, None on every other rank (a collective
    over ``t``'s mesh: every rank calls it). One tensor at a time reaches a
    card whole."""
    whole = full_tensor(t)
    return whole.cpu() if dist.get_rank() == 0 else None


def export_state(model: nn.Module) -> dict:
    """The whole ``state_dict`` of a :func:`shard_model`-wrapped model, in
    the unwrapped model's layout, on rank 0's host; ``{}`` on every other
    rank (a collective: every rank calls it). Each parameter is gathered
    and offloaded in turn, so no card ever holds the whole model."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        get_model_state_dict,
    )

    state = get_model_state_dict(
        model, options=StateDictOptions(full_state_dict=True, cpu_offload=True))
    return canonical_state(model, state)


# -- serving ---------------------------------------------------------------------

class ServeShard(NamedTuple):
    """What a model cut by :func:`shard_for_serving` holds: its degree and
    its rank's coordinate over ``tensor``."""

    tp: int
    rank: int


def kv_pool_heads(num_kv_heads: int, tp: int) -> int:
    """The K/V heads one rank's pools hold (JAX ``kv_pool_sharding``): it is
    the K/V heads that must divide over ``tp``, not the query heads (GQA).
    Raises the JAX ``ValueError`` when they do not."""
    if num_kv_heads % tp:
        raise ValueError(
            f"KV pool with {num_kv_heads} kv heads cannot shard over a "
            f"tensor={tp} mesh: num_kv_heads must be divisible by the "
            f"tensor-parallel degree (GQA models shard their KV heads, "
            f"not the query heads)")
    return num_kv_heads // tp


def _cut(param: nn.Parameter, dim: int, rank: int, tp: int) -> nn.Parameter:
    part = param.shape[dim] // tp
    piece = param.detach().narrow(dim, rank * part, part).clone()
    return nn.Parameter(piece, requires_grad=param.requires_grad)


#: this process's row-parallel all-reduces of models cut for serving: how
#: many, and the seconds the host spent in them (a gloo all-reduce of a CUDA
#: tensor waits there for the kernels queued before it)
ROW_REDUCES = {"calls": 0, "seconds": 0.0}


def _reduce_partials(group):
    """The row-parallel layer's forward hook: its partial products summed
    over ``tensor``, then its bias (held aside, added once)."""
    def hook(module, args, out):
        t0 = time.perf_counter()
        dist.all_reduce(out, group=group)
        ROW_REDUCES["calls"] += 1
        ROW_REDUCES["seconds"] += time.perf_counter() - t0
        bias = module.serve_bias
        return out if bias is None else out + bias.to(out.dtype)
    return hook


@torch.no_grad()
def shard_for_serving(model: nn.Module, mesh) -> nn.Module:
    """Cut ``model`` (GPT-2, or a dense Llama-family model) in place to this
    rank's shard over ``mesh``'s ``tensor`` dim (every rank calls it with
    the same whole weights; no communication). Raises the JAX
    ``ValueError`` when ``num_kv_heads`` does not divide, and
    ``NotImplementedError`` (ROADMAP item 11) where the model has no
    tensor-parallel layout. Returns ``model``, which carries its
    :class:`ServeShard` as ``model.serve_shard``."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.kv_cache import (
        kv_heads_and_dim,
    )

    if getattr(model, "serve_shard", None) is not None:
        raise ValueError("the model is already cut for serving")
    tp = mesh_shape(mesh)[AXIS_TENSOR]
    kv_pool_heads(kv_heads_and_dim(model.config)[0], tp)
    check_tensor_parallel(model, tp)
    rank = mesh.get_local_rank(AXIS_TENSOR)
    group = mesh.get_group(AXIS_TENSOR)
    _permute_qkv(model, tp)
    for path, module in model.named_modules():
        role = linear_role(path) if hasattr(module, "in_features") else None
        if role is None:
            continue
        if role == "column":
            for name, p in list(module.named_parameters(recurse=False)):
                setattr(module, name, _cut(p, 0, rank, tp))
            module.out_features //= tp
            continue
        leaf = "weight_q" if hasattr(module, "weight_q") else "weight"
        setattr(module, leaf, _cut(getattr(module, leaf), 1, rank, tp))
        module.in_features //= tp
        module.serve_bias = module.bias
        module.bias = None
        module.register_forward_hook(_reduce_partials(group))
    model.serve_shard = ServeShard(tp, rank)
    return model
