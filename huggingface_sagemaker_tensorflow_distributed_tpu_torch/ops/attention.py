"""Attention math and the paged-KV addressing helpers.

Counterpart of the JAX package's ``ops/attention.py``: the einsum
attention with fp32 logits and softmax (probabilities cast back to the
value dtype), the implementation dispatch (``xla`` | ``flash`` | ``ring``), the
``-1e9`` additive padding, segment, causal and banded masks, T5's
relative-position buckets and bias, and the block-table gather/scatter
of the serving engine's paged KV pools.
Tensors keep the JAX package's layouts: q/k/v ``[batch, heads, len,
head_dim]``, pools ``[num_blocks, block_size, heads, head_dim]``, block
tables ``[slots, blocks_per_slot]`` int32.

Unlike the JAX package, :func:`scatter_paged_kv` writes the pool in
place (the pools are the engine's largest buffers; a copy per layer per
step would double their traffic).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.flash_attention import (
    flash_attention,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    truncate_tables,
)

NEG = -1e9


def xla_attention(q, k, v, mask=None, scale=None, dropout=None):
    """Plain attention: fp32 logits plus the additive ``mask``
    (broadcastable to [B, H, Q, K]), fp32 softmax, probabilities cast to
    q's dtype before the product with ``v``. ``dropout`` (a callable such
    as an ``nn.Dropout``) is applied to the cast probabilities."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = (torch.matmul(q, k.transpose(-1, -2)) * scale).float()
    if mask is not None:
        logits = logits + mask.float()
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout is not None:
        weights = dropout(weights)
    return torch.matmul(weights, v)


def dot_product_attention(q, k, v, mask=None, scale=None, impl: str = "xla",
                          causal: bool = False, window: int | None = None,
                          dropout=None):
    """Dispatch on implementation: ``flash`` goes to the flash kernels
    (:func:`~.flash_attention.flash_attention`, which skip causal tiles);
    ``xla`` is :func:`xla_attention` with the causal or banded mask added
    (``window``, which needs ``causal``, keeps each query's last ``window``
    positions) and the probability ``dropout``, which only that route has;
    ``ring`` is sequence-parallel ring attention over the ambient mesh's
    ``seq`` axis, or the plain path where there is none
    (:func:`~..parallel.ring_attention.ring_attention_or_fallback`; it takes
    no ``window``: a banded mask goes in ``mask``)."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True (sliding-window "
                         "attention is an autoregressive construct)")
    if dropout is not None and impl != "xla":
        raise ValueError(f"probability dropout needs impl='xla' (got {impl!r}: "
                         "the flash kernels have no dropout hook)")
    if impl == "flash":
        return flash_attention(q, k, v, mask=mask, scale=scale, causal=causal,
                               window=window)
    if impl == "ring":
        if window is not None:
            # ring attention shards the seq axis; banding it needs
            # window-aware ring scheduling
            raise ValueError("sliding window is not supported with impl='ring'")
        from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.ring_attention import (
            ring_attention_or_fallback,
        )
        return ring_attention_or_fallback(q, k, v, mask=mask, scale=scale, causal=causal)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r} (xla | flash | ring)")
    if window is not None:
        band = make_banded_causal_mask(q.shape[2], window, k.shape[2], device=q.device)
        mask = band if mask is None else mask + band
    elif causal:
        cm = make_causal_mask(q.shape[2], k.shape[2], device=q.device)
        mask = cm if mask is None else mask + cm
    return xla_attention(q, k, v, mask=mask, scale=scale, dropout=dropout)


def make_attention_mask(attention_mask, dtype=torch.float32, neg: float = NEG,
                        segment_ids=None):
    """[batch, kv_len] {0,1} padding mask -> additive [batch, 1, 1, kv_len]
    ``(1 - m) * neg``; with ``segment_ids`` the block-diagonal
    [batch, 1, q_len, kv_len] segment mask instead."""
    if segment_ids is not None:
        return make_segment_mask(segment_ids, dtype=dtype, neg=neg)
    m = attention_mask[:, None, None, :].to(dtype)
    return (1.0 - m) * neg


def make_segment_mask(segment_ids, dtype=torch.float32, neg: float = NEG):
    """[batch, len] segment ids (1-based, 0 on padding) -> additive
    [batch, 1, len, len] mask keeping (query, key) iff both lie in the same
    nonzero segment."""
    seg_q = segment_ids[:, None, :, None]
    seg_k = segment_ids[:, None, None, :]
    keep = (seg_q == seg_k) & (seg_k > 0)
    return torch.where(keep, 0.0, neg).to(dtype)


def make_causal_mask(q_len: int, kv_len: int | None = None, device=None,
                     dtype=torch.float32, neg: float = NEG):
    """Additive [1, 1, q_len, kv_len] mask: key j allowed iff j <= i."""
    kv_len = kv_len or q_len
    i = torch.arange(q_len, device=device)[:, None]
    j = torch.arange(kv_len, device=device)[None, :]
    return torch.where(j <= i, 0.0, neg).to(dtype)[None, None]


def make_decoder_mask(decoder_input_ids, decoder_attention_mask=None):
    """A teacher-forced decoder's self-attention mask: causal ``[1, 1, T,
    T]``, plus the decoder padding ``[B, 1, 1, T]`` when given."""
    causal = make_causal_mask(decoder_input_ids.shape[1], device=decoder_input_ids.device)
    if decoder_attention_mask is None:
        return causal
    return causal + make_attention_mask(decoder_attention_mask)


def make_step_mask(index, q_len: int, max_len: int):
    """A cached decode step's self-attention mask ``[B, 1, q_len,
    max_len]``: cache slot ``j`` is visible to the step's query ``i`` iff
    ``j <= index[b] + i`` (``index`` ``[B]``: each row's write position)."""
    dev = index.device
    valid = (torch.arange(max_len, device=dev)[None, None, :]
             <= index[:, None, None] + torch.arange(q_len, device=dev)[None, :, None])
    return torch.where(valid, 0.0, NEG)[:, None]


def make_banded_causal_mask(q_len: int, window: int,
                            kv_len: int | None = None, device=None,
                            dtype=torch.float32, neg: float = NEG):
    """Causal plus sliding window: key j allowed iff 0 <= i - j < window
    (Mistral semantics). Additive [1, 1, q_len, kv_len]."""
    kv_len = kv_len or q_len
    i = torch.arange(q_len, device=device)[:, None]
    j = torch.arange(kv_len, device=device)[None, :]
    keep = (j <= i) & (j > i - window)
    return torch.where(keep, 0.0, neg).to(dtype)[None, None]


def relative_position_bucket(relative_position, bidirectional: bool,
                             num_buckets: int, max_distance: int):
    """HF ``T5Attention._relative_position_bucket``: the exact offsets
    below ``num_buckets // 2`` (halved again for the sign split when
    ``bidirectional``), log-spaced buckets up to ``max_distance`` beyond,
    the last bucket past it. The log is fp32 and truncated to an integer,
    as the JAX package's is: one ulp moves a bucket at its boundary."""
    ret = torch.zeros_like(relative_position)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (relative_position > 0).to(relative_position.dtype) * num_buckets
        rp = relative_position.abs()
    else:
        rp = -torch.clamp(relative_position, max=0)
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(rp.float() / max_exact + 1e-9)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).to(relative_position.dtype)
    large = torch.clamp(large, max=num_buckets - 1)
    return ret + torch.where(rp < max_exact, rp, large)


def relative_position_bias(table, q_pos, kv_pos, bidirectional: bool,
                           num_buckets: int, max_distance: int):
    """fp32 additive bias from a ``[num_buckets, heads]`` table and
    position grids ``q_pos`` ``[q, 1]`` (or ``[B, q, 1]``) and ``kv_pos``
    ``[1, kv]``: ``[1, heads, q, kv]`` (``[B, heads, q, kv]``)."""
    buckets = relative_position_bucket(kv_pos - q_pos, bidirectional, num_buckets,
                                       max_distance)
    # an embedding lookup, not an index: its backward sums the q·kv
    # duplicates of each bucket in parallel, where an index's backward walks
    # them one at a time (16 ms a T5-small step at S 512 on an H100)
    values = F.embedding(buckets, table.float())      # [..., q, kv, heads]
    if values.dim() == 4:
        return values.permute(0, 3, 1, 2)
    return values.permute(2, 0, 1)[None]


def gather_paged_kv(pool, block_tables, width: int | None = None):
    """Per-slot contiguous KV from a paged pool: returns
    [slots, heads, blocks * block_size, head_dim], where logical position
    ``p`` of slot ``s`` is ``pool[block_tables[s, p // bs], p % bs]``.
    ``width`` gathers only the first ``width`` positions (a block
    multiple)."""
    tables = truncate_tables(block_tables, pool.shape[1], width)
    g = pool[tables.long()]                        # [S, nb, bs, H, D]
    S, nb, bs, H, D = g.shape
    return g.permute(0, 3, 1, 2, 4).reshape(S, H, nb * bs, D)


def scatter_paged_kv(pool, block_tables, positions, values):
    """Write ``values`` [n, heads, head_dim] at logical ``positions`` [n]
    through ``block_tables`` [n, blocks_per_slot] (one row per written
    token), in place; returns ``pool``. Callers route the writes of
    inactive slots to the reserved null block 0."""
    bs = pool.shape[1]
    positions = positions.long()
    block_ids = torch.gather(block_tables.long(), 1,
                             (positions // bs)[:, None])[:, 0]
    pool[block_ids, positions % bs] = values.to(pool.dtype)
    return pool


def paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                    scale=None, width: int | None = None,
                    window: int | None = None,
                    k_scale_pool=None, v_scale_pool=None):
    """Single-token decode attention against a paged KV pool.

    ``q`` [slots, heads, head_dim]; pools and tables as in
    :func:`gather_paged_kv`; ``context_lens`` [slots] counts valid
    tokens per slot, the query's own included. CUDA tensors go through
    the hand-written kernel (:func:`~.paged_attention.
    paged_decode_attention`, which returns zeros for context-0 rows).
    CPU tensors go through the plain gather-then-attend path: keys at
    positions >= context are masked with -1e9, so a context-0 row is a
    softmax over masked junk there (callers discard those rows). GQA is
    native; ``k_scale_pool``/``v_scale_pool`` mark int8 pools."""
    if q.device.type != "cpu":
        return paged_decode_attention(
            q, k_pool, v_pool, block_tables, context_lens, scale=scale,
            width=width, window=window, k_scale_pool=k_scale_pool,
            v_scale_pool=v_scale_pool)
    k = gather_paged_kv(k_pool, block_tables, width=width)
    v = gather_paged_kv(v_pool, block_tables, width=width)
    if k_scale_pool is not None:
        ks = gather_paged_kv(k_scale_pool, block_tables, width=width)
        vs = gather_paged_kv(v_scale_pool, block_tables, width=width)
        k = (k.float() * ks).to(q.dtype)
        v = (v.float() * vs).to(q.dtype)
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]           # GQA: repeat kv heads
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    pos = torch.arange(k.shape[2])[None, :]
    ctx = context_lens.long()[:, None]
    valid = pos < ctx
    if window is not None:
        valid = valid & (pos > ctx - 1 - window)
    mask = torch.where(valid, 0.0, NEG)[:, None, None, :]
    return xla_attention(q[:, :, None, :], k, v, mask=mask,
                         scale=scale)[:, :, 0, :]
