"""Fused LM head + cross-entropy: the hand-written CUDA kernels of its
forward, dH and dW (``csrc/vocab_ce.cu``, with the bf16 forward in
``csrc/vocab_ce_fwd.cuh`` and the bf16 backward in ``csrc/vocab_ce_bwd.cuh``
on the GEMM core of ``csrc/hopper_gemm.cuh``), their ctypes wrappers, their
plain PyTorch versions, and the ``torch.autograd.Function`` that joins them.

Counterpart of the JAX package's ``ops/pallas_vocab_ce.py``:

========================  ===================================  =============================
wrapper                   CUDA kernels                         TPU kernel it replaces
========================  ===================================  =============================
:func:`fused_ce_fwd`      bf16: ``vocab_ce_fwd_split_w_kernel``, ``_fwd_kernel`` (``_fused_ce_fwd_call``)
                          ``vocab_ce_fwd_wgmma_kernel``,
                          ``vocab_ce_combine_kernel``;
                          fp32: ``vocab_ce_fwd_kernel``,
                          ``vocab_ce_combine_kernel``
:func:`fused_ce_bwd`      bf16: ``vocab_ce_split_w_kernel``,   ``_dh_kernel`` and ``_dw_kernel``
                          ``vocab_ce_ds_wgmma_kernel``,        (``_fused_ce_bwd_call``)
                          ``vocab_ce_dh_wgmma_kernel``,
                          ``vocab_ce_dw_wgmma_kernel``,
                          ``vocab_ce_transpose_h_kernel``,
                          ``vocab_ce_dh_reduce_kernel``;
                          fp32: ``vocab_ce_bwd_dh_kernel``,
                          ``vocab_ce_bwd_dw_kernel``
:func:`fused_ce_bwd_dh`   :func:`fused_ce_bwd` for dH alone    ``_dh_kernel``
:func:`fused_ce_bwd_dw`   :func:`fused_ce_bwd` for dW alone    ``_dw_kernel``
========================  ===================================  =============================

Contract (the JAX kernel's): ``hidden`` ``[N, H]`` in bfloat16 or float32,
``weight`` ``[V, H]`` in float32 (the tied embedding in its param dtype),
``labels`` ``[N]`` integer ids in ``[0, V)`` (callers pass masked
positions as id 0 and mask the loss themselves). The logits ``H·Wᵀ`` and
every statistic are fp32 and never written out: the forward gives the
per-token loss ``lse - z_label`` (with label smoothing ``eps``:
``lse - (1 - eps) z_label - eps mean(z)``), the LSE and the first maximal
id; the backward's ``dS = g (softmax - target)`` stays fp32 before
``dS·W`` and is rounded to ``hidden``'s dtype before ``dSᵀ·H``; dH comes
back in ``hidden``'s dtype, dW in ``weight``'s. Any other pair of dtypes
raises.

What bounds the kernels on an H100 and what their design does about it
is written in the CUDA sources: they are bound by operations. With bf16
hidden every product runs on the bf16 tensor cores on ``wgmma`` at every
H, with W split into three bf16 pieces that keep the fp32 logits
(:func:`split_bf16` is the split), the vocab walked in chunks of Vc ids
whose scratch stays within :data:`SCRATCH_BYTES`: the forward
(:func:`fused_ce_fwd`, chunks from :func:`fwd_plan`) splits each chunk's W
and reduces each 128-id logit tile to per-token statistics, merged in
vocab order at the end (3 bf16 passes of ``2·N·V·H``); the backward
(:func:`fused_ce_bwd`, chunks from :func:`bwd_plan`) is one route for dH
and dW: each chunk's W split once, one dS a chunk shared by the dH and dW
products (7 passes where separate dH and dW kernels take 10). float32
hidden runs in fp32 on CUDA cores.

Each wrapper launches its kernels for CUDA tensors and raises for anything
they cannot take; it uses the plain version only for tensors on the CPU.
``fused_ce_fwd.launches`` counts forward calls that launched,
``fused_ce_bwd_dh.launches`` and ``fused_ce_bwd_dw.launches`` backward
calls that computed dH and dW.
"""

from __future__ import annotations

import ctypes

import torch

_VOCAB_TILE = 64          # vocab ids per kernel tile (csrc/vocab_ce.cu kBV)
_FWD_ROWS = 64            # tokens per forward block
_BWD_ROWS = 32            # tokens per dH block
# blocks the vocab splits aim for: enough to fill 132 SMs several times
_FWD_TARGET_BLOCKS = 1024
_DH_TARGET_BLOCKS = 512
# the bf16 routes (csrc/vocab_ce_fwd.cuh, csrc/vocab_ce_bwd.cuh, csrc/hopper_gemm.cuh)
SCRATCH_BYTES = 256 << 20  # the scratch budget that sets each route's vocab chunk
_GEMM_TILE = 128          # rows and columns of a wgmma tile (kBM, kBN)
_GEMM_DEPTH = 64          # depth of a ring stage (kBK)
_GEMM_SMEM = 196608 + 1024 + 256   # its ring, alignment and barriers (kSmemBytes)
_SMS = 132                # streaming multiprocessors of an H100 SXM
_MAX_DH_SPLITS = 16


# ---------------------------------------------------------------------------
# argument handling shared by the plain versions and the kernels
# ---------------------------------------------------------------------------

def _check(hidden, weight, labels):
    if hidden.dim() != 2 or weight.dim() != 2 or hidden.shape[1] != weight.shape[1]:
        raise ValueError(f"hidden must be [N, H] and weight [V, H], got "
                         f"{tuple(hidden.shape)} and {tuple(weight.shape)}")
    if labels.shape != (hidden.shape[0],):
        raise ValueError(f"labels must be [{hidden.shape[0]}], got {tuple(labels.shape)}")
    if weight.dtype != torch.float32 or hidden.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("fused vocab CE takes (bfloat16 or float32 hidden, float32 "
                         f"weight), got ({hidden.dtype}, {weight.dtype})")
    if labels.dtype.is_floating_point or labels.dtype == torch.bool:
        raise ValueError(f"labels must be integer ids, got {labels.dtype}")


def _smoothing(label_smoothing):
    eps = float(label_smoothing)
    if not 0.0 <= eps < 1.0:
        raise ValueError(f"label_smoothing must be in [0, 1), got {eps}")
    return eps


def fwd_splits(n_tok: int, vocab: int) -> int:
    """How many blocks share each forward token tile's vocab range: enough
    blocks in all to fill the card, no split without a vocab tile."""
    return _splits(-(-n_tok // _FWD_ROWS), vocab, _FWD_TARGET_BLOCKS)


def dh_splits(n_tok: int, vocab: int) -> int:
    """How many blocks share each dH token tile's vocab range."""
    return _splits(-(-n_tok // _BWD_ROWS), vocab, _DH_TARGET_BLOCKS)


def tc_smem_bytes(kernel: str, h_dim: int) -> int:
    """Dynamic shared memory a block of the tensor-core kernel of
    ``kernel`` (``"fwd"``, ``"dh"`` or ``"dw"``) takes at depth ``h_dim``:
    the mirror of the library's ``vocab_ce_wgmma_smem_bytes``
    (``csrc/vocab_ce.cu``). Each runs on the ``wgmma`` core, which holds its
    stage ring (192 KB), the ring's 1024-byte alignment and its barriers
    whatever H: every H fits a block, so H picks no route."""
    if kernel not in ("fwd", "dh", "dw"):
        raise ValueError(f"no tensor-core kernel {kernel!r}")
    return _GEMM_SMEM


def _ceil(x: int, m: int) -> int:
    return -(-x // m) * m


def _wave_use(tiles: int) -> float:
    """The share of the SMs' block slots that ``tiles`` persistent tiles
    keep busy over their waves."""
    return tiles / (-(-tiles // _SMS) * _SMS)


def _even_chunk(vocab: int, vc_max: int) -> int:
    """The vocab chunk: as few chunks of at most ``vc_max`` ids (a
    multiple of 128) as cover ``vocab``, evened out, a multiple of 128."""
    padded = _ceil(vocab, _GEMM_TILE)
    chunks = -(-padded // vc_max)
    return _ceil(-(-padded // chunks), _GEMM_TILE)


def fwd_plan(n_tok: int, vocab: int, h_dim: int) -> tuple[int, int]:
    """``(Vc, scratch bytes)`` of the bf16 forward at ``n_tok`` tokens,
    ``vocab`` ids and depth ``h_dim`` (a multiple of 8: the wrapper pads).
    The scratch, every buffer a ``torch.empty`` in the wrapper: W's hi,
    mid, lo ``[Vc, H]`` bf16, and the per-tile statistics of every 128-id
    vocab tile and token, fp32 ``[4, T, N]`` and int32 ids ``[T, N]`` (T =
    ceil(V / 128)). ``Vc``: the largest multiple of 128 whose scratch stays
    within :data:`SCRATCH_BYTES` (at least 128), then evened out over the
    chunks, as :func:`bwd_plan`'s."""
    fixed = 5 * 4 * -(-vocab // _GEMM_TILE) * n_tok
    per_id = 3 * h_dim * 2
    vc = _even_chunk(vocab, max(_GEMM_TILE,
                                (SCRATCH_BYTES - fixed) // per_id // _GEMM_TILE * _GEMM_TILE))
    return vc, fixed + per_id * vc


def bwd_plan(n_tok: int, vocab: int, h_dim: int, need_dh: bool = True,
             need_dw: bool = True) -> tuple[int, int, int]:
    """``(Vc, splits, scratch bytes)`` of the bf16 backward at ``n_tok``
    tokens, ``vocab`` ids and depth ``h_dim`` (a multiple of 8: the wrapper
    pads). ``splits``: the K ranges of the dH product (split-K), the fewest
    that keep 85% of the SMs' slots busy over the ``ceil(N/128)·ceil(H/128)``
    output tiles, each range at least 4 stages of the vocab deep, at most
    16. ``Vc``: the vocab chunk, a multiple of 128, the largest whose
    scratch for dH and dW together stays within :data:`SCRATCH_BYTES` (at
    least 128), then evened out over the chunks. Vc and splits do not
    depend on what is asked, so a lone dH or dW is bit for bit the joint
    call's; the scratch is what the call asks for, every buffer a
    ``torch.empty`` in the wrapper: W's hi, mid, lo ``[Vc, H]`` bf16; for dH
    W's hiᵀ, midᵀ ``[H, Vc]``, dS_hi and dS_lo ``[N, Vc]`` and the fp32
    partials ``[splits, N, H]``; for dW dS_hiᵀ ``[Vc, N8]`` and hᵀ ``[H,
    N8]`` (N8: N rounded up to 8)."""
    n8 = _ceil(n_tok, 8)
    tiles = -(-n_tok // _GEMM_TILE) * -(-h_dim // _GEMM_TILE)
    depth = -(-vocab // _GEMM_DEPTH)
    splits = 1
    while (splits < _MAX_DH_SPLITS and _wave_use(tiles * splits) < 0.85
           and depth // (splits + 1) >= 4):
        splits += 1

    def scratch(dh: bool, dw: bool) -> tuple[int, int]:
        fixed = (splits * n_tok * h_dim * 4 if dh else 0) + (h_dim * n8 * 2 if dw else 0)
        per_id = 3 * h_dim * 2 + (2 * h_dim * 2 + 2 * n_tok * 2 if dh else 0) + (
            n8 * 2 if dw else 0)
        return fixed, per_id

    fixed, per_id = scratch(True, True)
    vc = _even_chunk(vocab, max(_GEMM_TILE,
                                (SCRATCH_BYTES - fixed) // per_id // _GEMM_TILE * _GEMM_TILE))
    fixed, per_id = scratch(need_dh, need_dw)
    return vc, splits, fixed + per_id * vc


def _splits(row_tiles: int, vocab: int, target: int) -> int:
    vtiles = -(-vocab // _VOCAB_TILE)
    want = min(vtiles, max(1, -(-target // row_tiles)))
    per = -(-vtiles // want)
    return -(-vtiles // per)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def split_bf16(x, pieces: int = 3):
    """``x`` as ``pieces`` bf16 tensors whose sum is ``x`` (fp32): the
    first is ``bf16(x)`` rounded to nearest, each later one the bf16
    truncation of what the ones before it leave. Each difference is exact
    in fp32 and the first leaves at most 16 significant bits, so three
    pieces carry fp32's 24 and sum to ``x`` exactly (while they stay normal
    numbers). The split the bf16-hidden dH kernel makes of W (three
    pieces) and of dS (two)."""
    rest = x.float()
    out = []
    for i in range(pieces):
        if i == 0:
            piece = rest.to(torch.bfloat16)
        else:  # truncation: the upper 16 bits of the fp32 value
            piece = (rest.view(torch.int32) & -65536).view(torch.float32).to(torch.bfloat16)
        out.append(piece)
        rest = rest - piece.float()
    return tuple(out)


def _logits(hidden, weight):
    """fp32 ``hidden·weightᵀ`` [N, V]."""
    return torch.matmul(hidden.float(), weight.float().t())


def fused_ce_fwd_reference(hidden, weight, labels, label_smoothing: float = 0.0):
    """The plain version of the forward kernel: ``(loss, lse, pred)`` over
    the whole logit matrix at once."""
    _check(hidden, weight, labels)
    eps = _smoothing(label_smoothing)
    s = _logits(hidden, weight)
    lse = torch.logsumexp(s, dim=-1)
    target = torch.gather(s, 1, labels.long()[:, None])[:, 0]
    if eps > 0:
        target = (1.0 - eps) * target + eps * s.sum(-1) / weight.shape[0]
    return lse - target, lse, s.argmax(-1).to(torch.int32)


def _dlogits(hidden, weight, labels, lse, g, eps):
    """dS = g (softmax - target) [N, V] fp32, target the (smoothed) one-hot."""
    s = _logits(hidden, weight)
    p = torch.exp(s - lse.float()[:, None])
    target = torch.zeros_like(s).scatter_(1, labels.long()[:, None], 1.0)
    if eps > 0:
        target = (1.0 - eps) * target + eps / weight.shape[0]
    return (p - target) * g.float()[:, None]


def fused_ce_bwd_dh_reference(hidden, weight, labels, lse, g,
                              label_smoothing: float = 0.0):
    """The plain version of the dH kernel: ``dS·W`` in ``hidden``'s dtype."""
    _check(hidden, weight, labels)
    ds = _dlogits(hidden, weight, labels, lse, g, _smoothing(label_smoothing))
    return torch.matmul(ds.to(weight.dtype).float(), weight.float()).to(hidden.dtype)


def fused_ce_bwd_dw_reference(hidden, weight, labels, lse, g,
                              label_smoothing: float = 0.0):
    """The plain version of the dW kernel: ``dSᵀ·H`` with dS rounded to
    ``hidden``'s dtype, in ``weight``'s dtype."""
    _check(hidden, weight, labels)
    ds = _dlogits(hidden, weight, labels, lse, g, _smoothing(label_smoothing))
    return torch.matmul(ds.to(hidden.dtype).float().t(), hidden.float()).to(weight.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _kernel_lib():
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import _build

    lib = _build.load("vocab_ce")
    if lib.vocab_ce_fwd_launch.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vocab_ce_fwd_launch.argtypes = [p] * 8 + [i] * 4 + [f] * 3 + [p]
        lib.vocab_ce_fwd_split_w_launch.argtypes = [p, i, i, i] + [p] * 4
        lib.vocab_ce_fwd_wgmma_launch.argtypes = [p] * 7 + [i] * 5 + [p]
        lib.vocab_ce_fwd_combine_launch.argtypes = [p] * 5 + [i] * 3 + [f] * 3 + [p]
        lib.vocab_ce_bwd_dh_launch.argtypes = [p] * 7 + [i] * 4 + [f] * 3 + [p]
        lib.vocab_ce_bwd_dw_launch.argtypes = [p] * 6 + [i] * 3 + [f] * 3 + [p]
        lib.vocab_ce_split_w_launch.argtypes = [p, i, i, i] + [p] * 5 + [i, p]
        lib.vocab_ce_transpose_h_launch.argtypes = [p, i, i, p, i, p]
        lib.vocab_ce_ds_launch.argtypes = [p] * 10 + [i] * 7 + [f] * 3 + [p]
        lib.vocab_ce_dh_product_launch.argtypes = [p] * 5 + [i] * 7 + [p]
        lib.vocab_ce_dw_product_launch.argtypes = [p] * 3 + [i] * 4 + [p]
        lib.vocab_ce_dh_cast_launch.argtypes = [p, p, i, i, i, p]
        for fn in (lib.vocab_ce_fwd_launch, lib.vocab_ce_fwd_split_w_launch,
                   lib.vocab_ce_fwd_wgmma_launch, lib.vocab_ce_fwd_combine_launch,
                   lib.vocab_ce_bwd_dh_launch,
                   lib.vocab_ce_bwd_dw_launch, lib.vocab_ce_split_w_launch,
                   lib.vocab_ce_transpose_h_launch, lib.vocab_ce_ds_launch,
                   lib.vocab_ce_dh_product_launch, lib.vocab_ce_dw_product_launch,
                   lib.vocab_ce_dh_cast_launch):
            fn.restype = ctypes.c_int
        lib.vocab_ce_wgmma_smem_bytes.argtypes = []
        lib.vocab_ce_wgmma_smem_bytes.restype = ctypes.c_longlong
        lib.vocab_ce_error_string.argtypes = [ctypes.c_int]
        lib.vocab_ce_error_string.restype = ctypes.c_char_p
    return lib


def load_kernel() -> None:
    """Build (at first use) and load the kernels' library."""
    _kernel_lib()


def _kernel_args(name, hidden, weight, labels, extra=()):
    """Checks what the kernels take; returns (lib, labels as contiguous
    int32)."""
    if hidden.device.type != "cuda":
        raise ValueError(f"{name} has no kernel for device {hidden.device}")
    for t in (weight, labels) + tuple(extra):
        if t.device != hidden.device:
            raise ValueError(f"{name}: all tensors must be on {hidden.device}, got "
                             f"one on {t.device}")
    for t in (hidden, weight):
        if not t.is_contiguous():
            raise ValueError(f"{name}: hidden and weight must be contiguous")
    for t in extra:
        if t.dtype != torch.float32 or t.shape != (hidden.shape[0],):
            raise ValueError(f"{name}: lse and g must be float32 [{hidden.shape[0]}], "
                             f"got {t.dtype} {tuple(t.shape)}")
    return _kernel_lib(), labels.to(torch.int32).contiguous()


def _eps_tail(eps, vocab):
    """(eps, 1 - eps, eps / V) rounded once to fp32, as the JAX kernel's
    Python-float constants are."""
    return (eps, 1.0 - eps, eps / vocab) if eps > 0 else (0.0, 1.0, 0.0)


def _raise_on(lib, name, err):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.vocab_ce_error_string(err).decode()} ({err})")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _fwd_outputs(n_tok, dev):
    """loss and LSE [N] fp32, pred [N] int32."""
    return (torch.empty(n_tok, dtype=torch.float32, device=dev),
            torch.empty(n_tok, dtype=torch.float32, device=dev),
            torch.empty(n_tok, dtype=torch.int32, device=dev))


def _fwd_fp32(lib, hidden, weight, lab, eps):
    """float32 hidden: ``vocab_ce_fwd_kernel`` on CUDA cores over
    :func:`fwd_splits` vocab ranges, then ``vocab_ce_combine_kernel``."""
    (N, H), V = hidden.shape, weight.shape[0]
    splits = fwd_splits(N, V)
    loss, lse, pred = _fwd_outputs(N, hidden.device)
    scratch = torch.empty(4 * splits * N, dtype=torch.float32, device=hidden.device)
    scratch_ix = torch.empty(splits * N, dtype=torch.int32, device=hidden.device)
    _raise_on(lib, "fused_ce_fwd", lib.vocab_ce_fwd_launch(
        hidden.data_ptr(), weight.data_ptr(), lab.data_ptr(), loss.data_ptr(),
        lse.data_ptr(), pred.data_ptr(), scratch.data_ptr(), scratch_ix.data_ptr(),
        N, V, H, splits, *_eps_tail(eps, V), _stream(hidden)))
    return loss, lse, pred


def _tma_operands(hidden, weight):
    """``(hidden, weight, H8)`` as the ``wgmma`` routes take them: TMA needs
    16-byte rows, so an H that is not a multiple of 8 is padded to H8 with
    zero columns of h and W (which add nothing to any product), and 16-byte
    aligned bases, so an h that is not is copied (a fresh allocation is).
    A layout step: the kernels run all the same. No model's H is such a
    width (the MLM fold widens H to a multiple of 8:
    ``train/trainer.py:bias_fold_width``). A W whose base is not 16-byte
    aligned (a parameter that is a view into a flat buffer) is refused:
    the wrapper raises rather than copy the largest operand a call."""
    h8 = _ceil(hidden.shape[1], 8)
    if h8 != hidden.shape[1]:
        pad = (0, h8 - hidden.shape[1])
        return torch.nn.functional.pad(hidden, pad), torch.nn.functional.pad(weight, pad), h8
    if weight.data_ptr() % 16:
        raise ValueError(f"the wgmma routes read W by TMA from a 16-byte aligned base; got "
                         f"W at address {weight.data_ptr():#x}")
    if hidden.data_ptr() % 16:
        hidden = hidden.clone()
    return hidden, weight, h8


def _fwd_bf16(lib, hidden, weight, lab, eps):
    """bf16 hidden: the chunked route of ``csrc/vocab_ce_fwd.cuh``. Per
    chunk of Vc ids (:func:`fwd_plan`): the split of W, then the logits on
    ``wgmma`` reduced to one partial a (128-id tile, token); after the last
    chunk the partials merged in vocab order."""
    N, V = hidden.shape[0], weight.shape[0]
    hidden, weight, h8 = _tma_operands(hidden, weight)
    vc, _ = fwd_plan(N, V, h8)
    tiles = -(-V // _GEMM_TILE)
    dev, stream = hidden.device, _stream(hidden)
    hi, mid, lo = (torch.empty(vc, h8, dtype=torch.bfloat16, device=dev) for _ in range(3))
    part = torch.empty(4, tiles, N, dtype=torch.float32, device=dev)
    part_ix = torch.empty(tiles, N, dtype=torch.int32, device=dev)
    loss, lse, pred = _fwd_outputs(N, dev)
    for v0 in range(0, V, vc):
        rows = min(vc, V - v0)
        _raise_on(lib, "fused_ce_fwd", lib.vocab_ce_fwd_split_w_launch(
            weight.data_ptr(), h8, v0, rows, hi.data_ptr(), mid.data_ptr(), lo.data_ptr(),
            stream))
        _raise_on(lib, "fused_ce_fwd", lib.vocab_ce_fwd_wgmma_launch(
            hidden.data_ptr(), hi.data_ptr(), mid.data_ptr(), lo.data_ptr(), lab.data_ptr(),
            part.data_ptr(), part_ix.data_ptr(), N, h8, V, v0, rows, stream))
    _raise_on(lib, "fused_ce_fwd", lib.vocab_ce_fwd_combine_launch(
        part.data_ptr(), part_ix.data_ptr(), loss.data_ptr(), lse.data_ptr(), pred.data_ptr(),
        N, V, tiles, *_eps_tail(eps, V), stream))
    return loss, lse, pred


def fused_ce_fwd(hidden, weight, labels, label_smoothing: float = 0.0):
    """Forward: ``(loss [N] fp32, lse [N] fp32, pred [N] int32)``. CUDA
    tensors with bf16 hidden go through the chunked ``wgmma`` route
    (``_fwd_bf16``), with float32 hidden through ``vocab_ce_fwd_kernel`` on
    CUDA cores, each ending in ``vocab_ce_combine_kernel``; CPU tensors
    through :func:`fused_ce_fwd_reference`."""
    _check(hidden, weight, labels)
    eps = _smoothing(label_smoothing)
    if hidden.device.type == "cpu":
        return fused_ce_fwd_reference(hidden, weight, labels, eps)
    lib, lab = _kernel_args("fused_ce_fwd", hidden, weight, labels)
    route = _fwd_bf16 if hidden.dtype == torch.bfloat16 else _fwd_fp32
    out = route(lib, hidden, weight, lab, eps)
    fused_ce_fwd.launches += 1
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def _bwd_fp32(lib, hidden, weight, lab, lse, g, eps, need_dh, need_dw):
    """float32 hidden: ``vocab_ce_bwd_dh_kernel`` (+ its split reduce) and
    ``vocab_ce_bwd_dw_kernel`` on CUDA cores."""
    (N, H), V = hidden.shape, weight.shape[0]
    tail = _eps_tail(eps, V)
    dh = dw = None
    if need_dh:
        splits = dh_splits(N, V)
        dh = torch.empty_like(hidden)
        scratch = torch.empty(splits * N * H, dtype=torch.float32, device=hidden.device)
        _raise_on(lib, "fused_ce_bwd", lib.vocab_ce_bwd_dh_launch(
            hidden.data_ptr(), weight.data_ptr(), lab.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dh.data_ptr(), scratch.data_ptr(), N, V, H, splits, *tail,
            _stream(hidden)))
    if need_dw:
        dw = torch.empty_like(weight)
        _raise_on(lib, "fused_ce_bwd", lib.vocab_ce_bwd_dw_launch(
            hidden.data_ptr(), weight.data_ptr(), lab.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dw.data_ptr(), N, V, H, *tail, _stream(hidden)))
    return dh, dw


def _bwd_bf16(lib, hidden, weight, lab, lse, g, eps, need_dh, need_dw):
    """bf16 hidden: the chunked route of ``csrc/vocab_ce_bwd.cuh``. Per
    chunk of Vc ids (:func:`bwd_plan`): the split of W, dS on ``wgmma``
    (one dS for both products), the dH product into fp32 partials and the
    dW product into dW's rows; then the dH partials' sum and cast. dH and
    dW are sliced back where :func:`_tma_operands` padded H."""
    (N, H), V = hidden.shape, weight.shape[0]
    hidden, weight, h8 = _tma_operands(hidden, weight)
    vc, splits, _ = bwd_plan(N, V, h8, need_dh, need_dw)
    n8 = _ceil(N, 8)
    dev, bf = hidden.device, torch.bfloat16
    stream = _stream(hidden)
    hi, mid, lo = (torch.empty(vc, h8, dtype=bf, device=dev) for _ in range(3))
    hi_t = mid_t = ds_hi = ds_lo = part = ds_hi_t = h_t = dw = None
    if need_dh:
        hi_t, mid_t = (torch.empty(h8, vc, dtype=bf, device=dev) for _ in range(2))
        ds_hi, ds_lo = (torch.empty(N, vc, dtype=bf, device=dev) for _ in range(2))
        part = torch.empty(splits, N, h8, dtype=torch.float32, device=dev)
    if need_dw:
        ds_hi_t = torch.empty(vc, n8, dtype=bf, device=dev)
        h_t = torch.empty(h8, n8, dtype=bf, device=dev)
        dw = torch.empty(V, h8, dtype=torch.float32, device=dev)
        _raise_on(lib, "fused_ce_bwd", lib.vocab_ce_transpose_h_launch(
            hidden.data_ptr(), N, h8, h_t.data_ptr(), n8, stream))
    tail = _eps_tail(eps, V)
    for v0 in range(0, V, vc):
        rows = min(vc, V - v0)
        _raise_on(lib, "fused_ce_bwd", lib.vocab_ce_split_w_launch(
            weight.data_ptr(), h8, v0, rows, hi.data_ptr(), mid.data_ptr(), lo.data_ptr(),
            _ptr(hi_t), _ptr(mid_t), vc, stream))
        _raise_on(lib, "fused_ce_bwd", lib.vocab_ce_ds_launch(
            hidden.data_ptr(), hi.data_ptr(), mid.data_ptr(), lo.data_ptr(), lse.data_ptr(),
            g.data_ptr(), lab.data_ptr(), _ptr(ds_hi), _ptr(ds_lo), _ptr(ds_hi_t), N, h8, V,
            v0, rows, vc, n8, *tail, stream))
        if need_dh:
            _raise_on(lib, "fused_ce_bwd", lib.vocab_ce_dh_product_launch(
                ds_hi.data_ptr(), ds_lo.data_ptr(), hi_t.data_ptr(), mid_t.data_ptr(),
                part.data_ptr(), N, h8, rows, vc, vc, splits, int(v0 == 0), stream))
        if need_dw:
            _raise_on(lib, "fused_ce_bwd", lib.vocab_ce_dw_product_launch(
                ds_hi_t.data_ptr(), h_t.data_ptr(), dw.data_ptr() + v0 * h8 * 4, N, h8, rows,
                n8, stream))
    dh = None
    if need_dh:
        dh = torch.empty(N, h8, dtype=bf, device=dev)
        _raise_on(lib, "fused_ce_bwd", lib.vocab_ce_dh_cast_launch(
            part.data_ptr(), dh.data_ptr(), N, h8, splits, stream))
    if h8 != H:
        dh = None if dh is None else dh[:, :H].contiguous()
        dw = None if dw is None else dw[:, :H].contiguous()
    return dh, dw


def fused_ce_bwd(hidden, weight, labels, lse, g, label_smoothing: float = 0.0,
                 need_dh: bool = True, need_dw: bool = True):
    """The backward, ``(dH in hidden's dtype or None, dW in weight's dtype
    or None)``, computing only what ``need_dh`` and ``need_dw`` ask: the
    counterpart of JAX's ``_fused_ce_bwd_call``. CUDA tensors with bf16
    hidden go through the chunked ``wgmma`` route (``_bwd_bf16``: one dS a
    vocab chunk shared by dH and dW), with float32 hidden through the
    CUDA-core kernels; CPU tensors through :func:`fused_ce_bwd_dh_reference`
    and :func:`fused_ce_bwd_dw_reference`. Counts one launch on
    ``fused_ce_bwd_dh`` when it computed dH and on ``fused_ce_bwd_dw`` when
    it computed dW."""
    _check(hidden, weight, labels)
    eps = _smoothing(label_smoothing)
    if hidden.device.type == "cpu":
        return (fused_ce_bwd_dh_reference(hidden, weight, labels, lse, g, eps) if need_dh
                else None,
                fused_ce_bwd_dw_reference(hidden, weight, labels, lse, g, eps) if need_dw
                else None)
    if not (need_dh or need_dw):
        return None, None
    lse, g = lse.contiguous(), g.contiguous()
    lib, lab = _kernel_args("fused_ce_bwd", hidden, weight, labels, (lse, g))
    route = _bwd_bf16 if hidden.dtype == torch.bfloat16 else _bwd_fp32
    dh, dw = route(lib, hidden, weight, lab, lse, g, eps, need_dh, need_dw)
    fused_ce_bwd_dh.launches += int(need_dh)
    fused_ce_bwd_dw.launches += int(need_dw)
    return dh, dw


def fused_ce_bwd_dh(hidden, weight, labels, lse, g, label_smoothing: float = 0.0):
    """dH in ``hidden``'s dtype: :func:`fused_ce_bwd` without dW (CPU
    tensors through :func:`fused_ce_bwd_dh_reference`)."""
    return fused_ce_bwd(hidden, weight, labels, lse, g, label_smoothing, need_dw=False)[0]


def fused_ce_bwd_dw(hidden, weight, labels, lse, g, label_smoothing: float = 0.0):
    """dW in ``weight``'s dtype: :func:`fused_ce_bwd` without dH (CPU
    tensors through :func:`fused_ce_bwd_dw_reference`)."""
    return fused_ce_bwd(hidden, weight, labels, lse, g, label_smoothing, need_dh=False)[1]


fused_ce_fwd.launches = 0
fused_ce_bwd_dh.launches = 0
fused_ce_bwd_dw.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class FusedVocabCE(torch.autograd.Function):
    """``(loss, pred)`` whose backward is one :func:`fused_ce_bwd` for the
    gradients asked; saves only the inputs and the LSE (no [N, V]
    residual). ``pred`` takes no gradient."""

    @staticmethod
    def forward(ctx, hidden, weight, labels, label_smoothing):
        loss, lse, pred = fused_ce_fwd(hidden, weight, labels, label_smoothing)
        ctx.save_for_backward(hidden, weight, labels, lse)
        ctx.label_smoothing = label_smoothing
        ctx.mark_non_differentiable(pred)
        return loss, pred

    @staticmethod
    def backward(ctx, g_loss, _g_pred):
        hidden, weight, labels, lse = ctx.saved_tensors
        eps = ctx.label_smoothing
        g = g_loss.float().contiguous()
        dh, dw = fused_ce_bwd(hidden, weight, labels, lse, g, eps,
                              need_dh=ctx.needs_input_grad[0], need_dw=ctx.needs_input_grad[1])
        return dh, dw, None, None


def fused_vocab_cross_entropy(hidden, weight, labels, label_smoothing: float = 0.0):
    """Per-token CE and the first argmax of ``hidden·weightᵀ`` without the
    [N, V] logits (the JAX ``fused_vocab_cross_entropy``): ``(loss [N]
    fp32, pred [N] int32)``, differentiable in ``hidden`` and ``weight``.
    Without a gradient to take, only the forward kernel runs."""
    needs_grad = torch.is_grad_enabled() and (hidden.requires_grad or weight.requires_grad)
    if not needs_grad:
        loss, _, pred = fused_ce_fwd(hidden, weight, labels, label_smoothing)
        return loss, pred
    return FusedVocabCE.apply(hidden, weight, labels, float(label_smoothing))
