"""Ring attention: sequence-parallel exact attention over the ``seq`` mesh
axis (counterpart of the JAX package's ``parallel/ring_attention.py``).

Each ``seq`` rank keeps its block of the queries and passes its K/V block
(with its padding mask) round the ring. At each step it folds the tile of
its queries against the K/V block it holds into running statistics (max,
denominator, numerator) in fp32, then hands the block to the previous rank
(:func:`~.collectives.ring_shift`). After ``sp`` steps every query block has
seen every key block, and the normalised numerator is exact softmax
attention. The causal mask and T5's relative-position bias are made per
step from global positions, so neither the ``[S, S]`` mask nor the bias
ever exists. The fold is plain PyTorch, as the JAX fold is einsums outside
any Pallas kernel: a run over ``sp > 1`` launches no flash kernel (K1).

The JAX function takes global arrays under ``shard_map``; the port's
:func:`ring_attention` takes this rank's **local** shards ``[b, h_local,
S/sp, d]`` and returns its local output. The models split the sequence
themselves (:func:`model_seq_shard`): they compute everything that depends
on a whole row (positions, masks, embeddings) on the whole row, keep their
rank's tokens ``[r·S/sp, (r+1)·S/sp)`` for the layer stack
(:meth:`SeqShard.local`), and gather the final hidden states back before
any head (:meth:`SeqShard.gather`, whose backward sums the ranks'
gradients: a reduce-scatter).

:func:`ring_attention_or_fallback` is the models' dispatch: with no ambient
mesh, or one whose ``seq`` axis is 1, it is the plain attention with the
whole bias and causal mask (the JAX fallback); under an active ``seq`` axis
a padding mask rides the ring, and a general ``[b, h, q, k]`` mask (Mistral's
band) takes the gathered route: K and V (and the mask's key columns, when
they are local) all-gathered over ``seq`` and attended by the local query
rows. That route is as exact as the ring.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.attention import (
    NEG,
    make_causal_mask,
    relative_position_bias,
    xla_attention,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.collectives import (
    gather_along,
    ring_shift,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.mesh import (
    AXIS_SEQ,
    maybe_current_mesh,
    mesh_shape,
    seq_group,
    seq_rank,
)

_NEG_INF = float("-inf")


class SeqShard(NamedTuple):
    """This rank's place on the ``seq`` axis: its group, its coordinate and
    the axis size."""

    group: object
    rank: int
    size: int

    def block(self, length: int) -> int:
        """The tokens a rank holds of a sequence of ``length`` (the JAX
        ``ValueError`` when ``size`` does not divide it)."""
        if length % self.size:
            raise ValueError(f"seq len {length} not divisible by seq axis {self.size}")
        return length // self.size

    def local(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's tokens of ``x`` along ``dim``."""
        n = self.block(x.shape[dim])
        return x.narrow(dim, self.rank * n, n)

    def local_mask(self, mask):
        """This rank's part of an additive mask: a padding mask ``[b, 1, 1,
        S]`` keeps its key columns (they travel with K/V round the ring), a
        general ``[b, h, S, S]`` one its query rows (its keys stay whole for
        the gathered route)."""
        if mask is None:
            return None
        return self.local(mask, -1 if mask.shape[-2] == 1 else -2)

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Every rank's ``x`` along ``dim``, in rank order (the backward
        sums the gradients over the ranks: a reduce-scatter)."""
        return gather_along(x, self.group, dim)


def seq_shard(mesh=None) -> Optional[SeqShard]:
    """``mesh``'s (the ambient mesh's when None) ``seq`` shard, or None
    when there is no mesh or its ``seq`` axis is 1."""
    mesh = maybe_current_mesh() if mesh is None else mesh
    if mesh is None:
        return None
    size = mesh_shape(mesh)[AXIS_SEQ]
    if size <= 1:
        return None
    return SeqShard(seq_group(mesh), seq_rank(mesh), size)


def model_seq_shard(attention_impl: str) -> Optional[SeqShard]:
    """The shard a model's forward splits its sequence over: the ambient
    mesh's ``seq`` shard when ``attention_impl`` is ``ring``, else None
    (the model runs whole)."""
    return seq_shard() if attention_impl == "ring" else None


def _repeat_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """GQA: ``x``'s K/V heads repeated to ``heads``."""
    return x if x.shape[1] == heads else x.repeat_interleave(heads // x.shape[1], dim=1)


class _Tie(torch.autograd.Function):
    """``out`` unchanged, with ``kv`` made a dependency of it: its backward
    hands ``kv`` a zero gradient. A rank whose last K/V blocks were all
    masked (causal) still runs every shift's backward that way, and the
    ring's backward stays a collective every rank joins."""

    @staticmethod
    def forward(ctx, out, kv):
        ctx.kv_meta = (kv.shape, kv.dtype, kv.device)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.kv_meta
        return grad, torch.zeros(shape, dtype=dtype, device=device)


def _ring_shard(q, k, v, mask, rel_table, *, scale: float, seq: SeqShard, causal: bool,
                rel):
    """The ring over local blocks: ``q`` ``[b, h, sq, d]``, ``k``/``v`` ``[b,
    hk, sk, d]`` (``hk`` dividing ``h``: GQA's K/V heads travel un-repeated),
    ``mask`` additive ``[b, 1, 1, sk]`` or None, ``rel_table`` ``[buckets,
    h]`` or None with ``rel`` = ``(bidirectional, buckets, max_distance)``.
    The running max is a stabiliser the result does not depend on, so it is
    kept out of the graph."""
    n, me = seq.size, seq.rank
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dev = q.device
    q32 = q.float()
    m = torch.full((b, h, sq, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=dev)
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    kv = torch.stack([k, v])
    q_pos = me * sq + torch.arange(sq, device=dev)[:, None]
    used = False
    for i in range(n):
        # the K/V block held at step i started at rank (me + i) mod n
        src = (me + i) % n
        used = not (causal and src > me)   # a block wholly after the queries adds nothing
        if used:
            kv_pos = src * sk + torch.arange(sk, device=dev)[None, :]
            logits = torch.matmul(q32, _repeat_heads(kv[0], h).float().transpose(-1, -2))
            logits = logits * scale
            if mask is not None:
                logits = logits + mask.float()
            if rel is not None:
                bidirectional, buckets, max_distance = rel
                logits = logits + relative_position_bias(
                    rel_table, q_pos, kv_pos, bidirectional=bidirectional,
                    num_buckets=buckets, max_distance=max_distance)
            if causal:
                logits = logits.masked_fill(q_pos < kv_pos, _NEG_INF)
            new_m = torch.maximum(m, logits.detach().amax(-1, keepdim=True))
            # -inf guards: a fully masked running max or block adds exactly 0
            safe = torch.where(new_m == _NEG_INF, 0.0, new_m)
            corr = torch.exp(m - safe)
            e = torch.exp(logits - safe)
            l = l * corr + e.sum(-1, keepdim=True)
            o = o * corr + torch.matmul(e, _repeat_heads(kv[1], h).float())
            m = new_m
        if i < n - 1:       # the n-th shift would only bring the block home
            kv = ring_shift(kv, seq.group, shift=-1)
            if mask is not None:
                mask = ring_shift(mask, seq.group, shift=-1)
    out = (o / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out if used or not kv.requires_grad else _Tie.apply(out, kv)


def ring_attention(q, k, v, mask=None, scale=None, *, mesh, causal: bool = False,
                   rel_bias_table=None, rel_bias_spec: tuple | None = None):
    """Exact attention with the sequence dim sharded over ``mesh``'s
    ``seq`` axis.

    q: this rank's LOCAL ``[batch, heads, S/sp, head_dim]``; k, v: its local
    ``[batch, kv_heads, S/sp, head_dim]`` (``kv_heads`` dividing ``heads``).
    mask: optional additive padding mask over this rank's keys,
    broadcastable to ``[batch, 1, 1, S/sp]``; general ``[b, h, q, k]``
    masks have no ring form (``ring_attention_or_fallback`` routes them).
    ``causal`` and T5's ``rel_bias_table`` ``[num_buckets, heads]`` with
    ``rel_bias_spec`` ``(bidirectional, num_buckets, max_distance)`` are
    made per ring step from global positions. Statistics in fp32, output
    in q's dtype: this rank's local ``[batch, heads, S/sp, head_dim]``.
    Every rank of the ``seq`` axis must call it (the shifts are
    collectives)."""
    seq = seq_shard(mesh)
    if seq is None:
        raise ValueError("ring_attention needs a mesh whose seq axis is > 1")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if k.shape != v.shape or q.shape[1] % k.shape[1] or q.shape[0] != k.shape[0]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v {tuple(v.shape)} "
                         "do not form one attention")
    if mask is not None:
        mask = mask.expand(q.shape[0], 1, 1, k.shape[2]).float()
    has_rel = rel_bias_table is not None
    return _ring_shard(q, k, v, mask, rel_bias_table, scale=scale, seq=seq, causal=causal,
                       rel=rel_bias_spec if has_rel else None)


def _plain(q, k, v, mask, scale, causal, rel_bias_table, rel_bias_spec, q_offset: int = 0):
    """The plain attention of ``q`` (its rows at global positions from
    ``q_offset``) against whole ``k``/``v``, with the bias from the table
    and the causal mask added to ``mask`` (the JAX fallback's math)."""
    dev = q.device
    full = mask
    q_pos = q_offset + torch.arange(q.shape[2], device=dev)[:, None]
    kv_pos = torch.arange(k.shape[2], device=dev)[None, :]
    if rel_bias_table is not None:
        bidirectional, buckets, max_distance = rel_bias_spec
        bias = relative_position_bias(rel_bias_table, q_pos, kv_pos,
                                      bidirectional=bidirectional, num_buckets=buckets,
                                      max_distance=max_distance)
        full = bias if full is None else full + bias
    if causal:
        if q_offset == 0 and q.shape[2] == k.shape[2]:
            cm = make_causal_mask(q.shape[2], k.shape[2], device=dev)
        else:
            cm = torch.where(kv_pos <= q_pos, 0.0, NEG)[None, None]
        full = cm if full is None else full + cm
    h = q.shape[1]
    return xla_attention(q, _repeat_heads(k, h), _repeat_heads(v, h), mask=full, scale=scale)


def ring_attention_or_fallback(q, k, v, mask=None, scale=None, causal: bool = False,
                               rel_bias_table=None, rel_bias_spec: tuple | None = None):
    """The models' ring dispatch. With no ambient mesh (``parallel.mesh.
    use_mesh``), or one whose ``seq`` axis is 1, the tensors are whole and
    this is the plain attention with the whole bias and causal mask (the
    JAX fallback). Under an active ``seq`` axis they are this rank's local
    blocks (the model split the sequence): a padding mask (or none) rides
    the ring (:func:`ring_attention`); a general ``[b, h, q, k]`` mask
    takes the gathered route, K and V all-gathered over ``seq`` (their
    backward a reduce-scatter) and attended by the local query rows, the
    mask's key columns gathered too when they are local. K/V may carry
    fewer heads than q (GQA): they are repeated where they are used."""
    seq = seq_shard()
    if seq is None:
        return _plain(q, k, v, mask, scale, causal, rel_bias_table, rel_bias_spec)
    general = mask is not None and (mask.shape[-2] != 1 or mask.shape[1] != 1)
    if not general:
        return ring_attention(q, k, v, mask=mask, scale=scale, mesh=maybe_current_mesh(),
                              causal=causal, rel_bias_table=rel_bias_table,
                              rel_bias_spec=rel_bias_spec)
    k_all = gather_along(k, seq.group, 2)
    v_all = gather_along(v, seq.group, 2)
    if mask.shape[-1] == k.shape[2]:
        with torch.no_grad():
            mask = gather_along(mask.float(), seq.group, mask.dim() - 1)
    return _plain(q, k_all, v_all, mask, scale, causal, rel_bias_table, rel_bias_spec,
                  q_offset=seq.rank * q.shape[2])
