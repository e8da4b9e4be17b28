"""Paged single-token decode attention: the hand-written CUDA kernels
(``csrc/paged_attention.cu``: a split-context kernel and its combine),
their ctypes wrapper, and the plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas_paged_attention.py``
(``paged_decode_attention``, the Pallas kernel ``_paged_kernel``). Same
contract and layouts:

- ``q`` [slots, heads, head_dim], one query per slot (the decode step's
  newest token, whose K/V is already in the pools);
- ``k_pool``/``v_pool`` [num_blocks, block_size, kv_heads, head_dim],
  fp (the query's dtype) or int8 with ``k_scale_pool``/``v_scale_pool``
  [num_blocks, block_size, kv_heads, 1] fp32;
- ``block_tables`` [slots, blocks_per_slot] int32; ``context_lens``
  [slots] int32 counts the valid tokens of each slot, the query's own
  included;
- ``width`` (a block multiple) restricts the walk to the first
  ``width`` positions of each table; ``window`` keeps key ``j`` iff
  ``0 <= (ctx - 1) - j < window``;
- GQA is native: query heads are a multiple of the pools' kv heads;
- the kernels have instances at head_dim 64, 128 and 256; another
  head_dim up to 256 runs on the next instance with ``q`` and the pools
  zero-padded on it and the real head_dim's scale (exact), the output
  sliced back (:func:`~.flash_attention.kernel_head_dim`);
- fp32 logits, softmax and accumulation; the output is in q's dtype;
  rows without any valid key (context 0) are zeros.

:func:`paged_decode_attention` launches the kernels for CUDA tensors and
raises for anything it cannot take; it uses the plain version only for
tensors on the CPU. ``paged_decode_attention.launches`` counts calls that
launched the kernels (one per call: the split kernel and its combine).

The kernel splits each slot's walked span into chunks of positions, one
block per (kv head, slot, chunk); :func:`split_plan` picks the chunk
length on the host from the shapes alone.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.flash_attention import (
    kernel_head_dim,
    pad_head_dim,
)

_NEG_INF = -1e30
MAX_GROUP = 8           # query heads per kv head the kernel takes (kMaxGroup)
WARPS = 4               # warps of a split block (kWarps)
STAGE_KEYS = 8          # positions a warp takes per stage (kKeys)
TILE = WARPS * STAGE_KEYS  # positions a block takes per round (kTile)
MIN_CHUNK = 2 * TILE    # every warp of a block takes at least two stages
BLOCKS_PER_SM = 8       # split blocks per SM the plan aims for at full span
H100_SMS = 132


def truncate_tables(block_tables: torch.Tensor, block_size: int,
                    width: int | None) -> torch.Tensor:
    """The first ``width // block_size`` columns of ``block_tables``
    (all of them without ``width``); ``width`` must be a block multiple
    that the table can hold."""
    if width is None:
        return block_tables
    if width % block_size:
        raise ValueError(f"bucket width {width} must be a multiple "
                         f"of block_size {block_size}")
    nb = width // block_size
    if nb > block_tables.shape[1]:
        raise ValueError(
            f"bucket width {width} needs {nb} blocks/slot but the "
            f"block table holds {block_tables.shape[1]}")
    return block_tables[:, :nb]


def _check_args(q, k_pool, k_scale_pool, v_scale_pool, window):
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 when set, got {window}")
    if (k_scale_pool is None) != (v_scale_pool is None):
        raise ValueError("int8 pools need BOTH k_scale_pool and "
                         "v_scale_pool (or neither)")
    if q.shape[1] % k_pool.shape[2]:
        raise ValueError(
            f"query heads {q.shape[1]} must be a multiple of pool kv "
            f"heads {k_pool.shape[2]} (GQA grouping)")


def paged_decode_attention_reference(q, k_pool, v_pool, block_tables,
                                     context_lens, scale=None,
                                     width: int | None = None,
                                     window: int | None = None,
                                     k_scale_pool=None, v_scale_pool=None):
    """The plain PyTorch version of the kernel: gather each slot's
    blocks, dequantize, attend in fp32 with the context/band mask, zeros
    for rows without a valid key."""
    _check_args(q, k_pool, k_scale_pool, v_scale_pool, window)
    S, Hq, D = q.shape
    _, bs, Hkv, _ = k_pool.shape
    G = Hq // Hkv
    tables = truncate_tables(block_tables, bs, width).long()
    scale = D ** -0.5 if scale is None else scale

    def gather(pool):                           # -> [S, Hkv, W, D'] fp32
        g = pool[tables].float()                # [S, nb, bs, Hkv, D']
        return g.permute(0, 3, 1, 2, 4).reshape(S, Hkv, -1, g.shape[-1])

    k, v = gather(k_pool), gather(v_pool)
    if k_scale_pool is not None:
        k = k * gather(k_scale_pool)
        v = v * gather(v_scale_pool)
    qg = q.float().reshape(S, Hkv, G, D)
    logits = torch.einsum("shgd,shwd->shgw", qg, k) * scale
    pos = torch.arange(k.shape[2], device=q.device)[None, :]
    ctx = context_lens.to(q.device).long()[:, None]
    valid = pos < ctx
    if window is not None:
        valid = valid & (pos > ctx - 1 - window)
    valid = valid[:, None, None, :]
    logits = torch.where(valid, logits, torch.full_like(logits, _NEG_INF))
    p = torch.exp(logits - logits.amax(-1, keepdim=True)) * valid
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("shgw,shwd->shgd", p, v) / torch.where(l == 0, 1.0, l)
    return out.reshape(S, Hq, D).to(q.dtype)


@functools.lru_cache(maxsize=None)
def split_plan(slots: int, kv_heads: int, span: int, block_size: int,
               sms: int = H100_SMS) -> tuple[int, int]:
    """``(chunk, chunks)`` of the split kernel: ``chunk`` positions per
    block, a multiple of :data:`TILE` and of ``block_size``, and
    ``chunks`` blocks per (slot, kv head), enough to cover ``span`` (the
    walked width, or the window when it is narrower). Chosen from the
    shapes alone, so that a full span gives the grid
    ``slots * kv_heads * chunks`` about :data:`BLOCKS_PER_SM` blocks per SM,
    one request included, with chunks of at least :data:`MIN_CHUNK`
    positions (a block's fixed cost, its table, q and merge, then spans
    two stages of every warp)."""
    unit = math.lcm(TILE, block_size)
    want = -(-sms * BLOCKS_PER_SM // max(1, slots * kv_heads))
    per = max(MIN_CHUNK, -(-span // want))  # positions a chunk for `want` chunks
    chunk = -(-per // unit) * unit
    return chunk, max(1, -(-span // chunk))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the split kernel's partials, one fp32 buffer per (device, stream)
_WORKSPACE: dict[tuple[int, int], torch.Tensor] = {}


def _workspace(numel: int, device: torch.device, stream: int) -> torch.Tensor:
    """At least ``numel`` fp32 values for the partials, kept per (device,
    stream) and grown when a call needs more: the calls on one stream run
    one after another, so each reuses the buffer the last one left."""
    buf = _WORKSPACE.get((device.index, stream))
    if buf is None or buf.numel() < numel:
        buf = torch.empty(numel, dtype=torch.float32, device=device)
        _WORKSPACE[(device.index, stream)] = buf
    return buf


def _kernel_lib():
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import _build

    lib = _build.load("paged_attention")
    fn = lib.paged_decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        lib.paged_decode_split_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.paged_decode_split_smem_bytes.restype = ctypes.c_size_t
    return lib


def load_kernel() -> None:
    """Build (at first use) and load the kernel's library."""
    _kernel_lib()


def paged_decode_attention(q, k_pool, v_pool, block_tables, context_lens,
                           scale=None, width: int | None = None,
                           window: int | None = None,
                           k_scale_pool=None, v_scale_pool=None, *,
                           chunk: int | None = None):
    """Fused single-token paged decode attention (contract in the module
    docstring). CUDA tensors go through the kernels; CPU tensors through
    :func:`paged_decode_attention_reference`. ``chunk`` forces the split
    kernel's chunk length (a multiple of :data:`TILE` and of the block
    size; tests and tuning); by default :func:`split_plan` picks it."""
    _check_args(q, k_pool, k_scale_pool, v_scale_pool, window)
    if chunk is not None and (chunk <= 0 or chunk % math.lcm(TILE, k_pool.shape[1])):
        raise ValueError(f"chunk {chunk} must be a positive multiple of {TILE} "
                         f"and of block_size {k_pool.shape[1]}")
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pool, v_pool, block_tables, context_lens, scale=scale,
            width=width, window=window, k_scale_pool=k_scale_pool,
            v_scale_pool=v_scale_pool)
    D = q.shape[-1]
    if kernel_head_dim(D) != D:
        qp, kp, vp = pad_head_dim(kernel_head_dim(D), q, k_pool, v_pool)
        return paged_decode_attention(
            qp, kp, vp, block_tables, context_lens,
            scale=D ** -0.5 if scale is None else scale, width=width, window=window,
            k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool, chunk=chunk)[..., :D]
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention has no kernel for device "
                         f"{q.device}")
    S, Hq, D = q.shape
    N, bs, Hkv, Dk = k_pool.shape
    nb = truncate_tables(block_tables, bs, width).shape[1]
    int8 = k_scale_pool is not None
    tensors = [q, k_pool, v_pool, block_tables, context_lens]
    if int8:
        tensors += [k_scale_pool, v_scale_pool]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all tensors must be on {q.device}, got one "
                             f"on {t.device}")
        if not t.is_contiguous():
            raise ValueError("paged_decode_attention needs contiguous tensors")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    want_kv = torch.int8 if int8 else q.dtype
    if k_pool.dtype != want_kv or v_pool.dtype != want_kv:
        raise ValueError(f"pools must be {want_kv} for q {q.dtype}"
                         f"{' with scale pools' if int8 else ''}, got "
                         f"{k_pool.dtype}/{v_pool.dtype}")
    if v_pool.shape != k_pool.shape or Dk != D:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not fit q {tuple(q.shape)}")
    if int8:
        for sp in (k_scale_pool, v_scale_pool):
            if sp.dtype != torch.float32 or sp.shape != (N, bs, Hkv, 1):
                raise ValueError("scale pools must be float32 "
                                 f"[{N}, {bs}, {Hkv}, 1]")
    if Hq // Hkv > MAX_GROUP:
        raise ValueError(f"kernel takes up to {MAX_GROUP} query heads per kv "
                         f"head, got {Hq // Hkv}")
    if bs % 4:
        raise ValueError(f"kernel needs a block_size multiple of 4, got {bs}")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the kernel reads the pools with 16-byte loads: "
                         "they must start 16-byte aligned")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise ValueError("block_tables and context_lens must be int32")
    if block_tables.shape[0] != S or context_lens.shape != (S,):
        raise ValueError("block_tables / context_lens must have one row "
                         "per query slot")
    out = torch.empty_like(q)
    if S == 0:
        return out
    scale = D ** -0.5 if scale is None else scale
    span = nb * bs if window is None else min(nb * bs, window)
    if chunk is None:
        chunk, chunks = split_plan(S, Hkv, span, bs, _sm_count(q.device.index or 0))
    else:
        chunks = max(1, -(-span // chunk))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # each chunk's partial running max and sum, and accumulator
    work = _workspace(S * Hq * chunks * (D + 2), q.device, stream)
    lib = _kernel_lib()
    err = lib.paged_decode_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale_pool.data_ptr() if int8 else None,
        v_scale_pool.data_ptr() if int8 else None,
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        work.data_ptr(), S, Hq, Hkv, D, bs, nb, block_tables.shape[1], chunk,
        chunks, float(scale), 0 if window is None else int(window),
        int(q.dtype == torch.bfloat16), int(int8), stream)
    if err != 0:
        raise RuntimeError(
            "paged_decode_attention kernel launch failed: "
            f"{lib.paged_attention_error_string(err).decode()} ({err})")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
