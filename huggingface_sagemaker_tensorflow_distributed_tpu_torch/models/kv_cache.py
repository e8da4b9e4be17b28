"""Decode KV-cache storage for the port's decoder models.

Counterpart of ``kv_quantize``, ``write_kv_cache`` and
``write_paged_kv`` in the JAX package's ``models/llama.py`` (GPT-2
borrows them from there). Two cache forms:

- :class:`DenseCache`: per-row ``[B, H, max_len, D]`` buffers per layer
  and one write index per row, advanced by the model after every layer
  has written (the JAX package keeps one ``cache_index`` per layer; all
  of them move together);
- :class:`PagedCache`: the serving engine's block pools
  ``[num_blocks, block_size, H, D]`` per layer plus per-row block tables.

With ``kv_cache_dtype='int8'`` values are stored int8 with fp32 scales
per (row, head, position), the same symmetric quantization in both
forms. Writes happen in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.attention import (
    scatter_paged_kv,
)


def kv_heads_and_dim(cfg) -> tuple[int, int]:
    """(K/V heads, head dim) of a decoder config's cache: GPT-2's heads
    and ``hidden / heads``; the Llama family's ``num_kv_heads`` and
    ``resolved_head_dim``."""
    heads = getattr(cfg, "num_kv_heads", cfg.num_heads)
    return heads, getattr(cfg, "resolved_head_dim", cfg.hidden_size // cfg.num_heads)


def local_heads(model, heads: int) -> int:
    """``heads`` on this rank: all of them, or ``heads / tp`` on a model cut
    for tensor-parallel serving (``parallel/sharding.py:shard_for_serving``)."""
    shard = getattr(model, "serve_shard", None)
    return heads if shard is None else heads // shard.tp


def kv_quantize(x):
    """Symmetric per-(batch, head, position) int8 quantization of
    [B, H, S, D]: scale = amax/127 over head_dim; all-zero rows keep
    scale 0 and dequantize to exact zeros. Returns (int8, fp32 scale
    [B, H, S, 1])."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.where(scale > 0, x32 / torch.where(scale > 0, scale, 1.0), 0.0)
    return q.round().clamp(-127, 127).to(torch.int8), scale


@dataclass
class DenseCache:
    keys: list            # per layer [B, H, max_len, D]
    values: list
    key_scales: Optional[list]    # per layer [B, H, max_len, 1] fp32 (int8 only)
    value_scales: Optional[list]
    index: torch.Tensor   # [B] int64: next write position per row

    @classmethod
    def empty(cls, num_layers: int, batch: int, heads: int, max_len: int,
              head_dim: int, dtype, device, int8: bool = False,
              index=None) -> "DenseCache":
        store = torch.int8 if int8 else dtype

        def bufs(d, dt):
            return [torch.zeros(batch, heads, max_len, d, dtype=dt,
                                device=device) for _ in range(num_layers)]

        idx = (torch.zeros(batch, dtype=torch.long, device=device)
               if index is None else index.to(device=device, dtype=torch.long))
        return cls(bufs(head_dim, store), bufs(head_dim, store),
                   bufs(1, torch.float32) if int8 else None,
                   bufs(1, torch.float32) if int8 else None, idx)


@dataclass
class PagedCache:
    key_pools: list       # per layer [num_blocks, block_size, H, D]
    value_pools: list
    key_scale_pools: Optional[list]   # per layer [num_blocks, block_size, H, 1]
    value_scale_pools: Optional[list]
    block_tables: torch.Tensor        # [B, blocks_per_slot] int32
    context_lens: torch.Tensor        # [B] int32: tokens already resident


def _row_write(buf, new, cur):
    """buf [B, H, L, D'] <- new [B, H, q, D'] at positions cur[b] + i."""
    B, _, q, _ = new.shape
    pos = cur.long()[:, None] + torch.arange(q, device=buf.device)[None, :]
    rows = torch.arange(B, device=buf.device)[:, None]
    buf[rows, :, pos] = new.transpose(1, 2).to(buf.dtype)


def write_kv_cache(cache: DenseCache, layer: int, k, v, compute_dtype):
    """Write one step's K/V [B, H, q, D] at each row's ``cache.index``
    and return the layer's full [B, H, max_len, D] buffers for attention
    (dequantized to ``compute_dtype`` for int8 storage)."""
    cur = cache.index
    if cache.key_scales is not None:
        qk, sk = kv_quantize(k)
        qv, sv = kv_quantize(v)
        _row_write(cache.keys[layer], qk, cur)
        _row_write(cache.values[layer], qv, cur)
        _row_write(cache.key_scales[layer], sk, cur)
        _row_write(cache.value_scales[layer], sv, cur)
        kd = (cache.keys[layer].float() * cache.key_scales[layer])
        vd = (cache.values[layer].float() * cache.value_scales[layer])
        return kd.to(compute_dtype), vd.to(compute_dtype)
    _row_write(cache.keys[layer], k, cur)
    _row_write(cache.values[layer], v, cur)
    return cache.keys[layer], cache.values[layer]


def write_paged_kv(cache: PagedCache, layer: int, k, v):
    """Scatter one decode step's K/V [B, H, 1, D] at each row's
    ``cache.context_lens`` through its block table into the layer's
    pools (int8 plus scales when the cache has scale pools)."""
    tables, cur = cache.block_tables, cache.context_lens
    if cache.key_scale_pools is not None:
        qk, sk = kv_quantize(k)
        qv, sv = kv_quantize(v)
        scatter_paged_kv(cache.key_pools[layer], tables, cur, qk[:, :, 0])
        scatter_paged_kv(cache.value_pools[layer], tables, cur, qv[:, :, 0])
        scatter_paged_kv(cache.key_scale_pools[layer], tables, cur, sk[:, :, 0])
        scatter_paged_kv(cache.value_scale_pools[layer], tables, cur,
                         sv[:, :, 0])
        return
    scatter_paged_kv(cache.key_pools[layer], tables, cur, k[:, :, 0])
    scatter_paged_kv(cache.value_pools[layer], tables, cur, v[:, :, 0])
