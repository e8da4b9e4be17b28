"""Fused LM head + cross-entropy: the hand-written CUDA kernels of its
forward, dH and dW (``csrc/vocab_ce.cu``, with the tensor-core ones in
``csrc/vocab_ce_tc.cuh``), their ctypes wrappers, their plain PyTorch
versions, and the ``torch.autograd.Function`` that joins them.

Counterpart of the JAX package's ``ops/pallas_vocab_ce.py``:

========================  ==============================  =============================
wrapper                   CUDA kernel                     TPU kernel it replaces
========================  ==============================  =============================
:func:`fused_ce_fwd`      ``vocab_ce_fwd_tc_kernel``,     ``_fwd_kernel`` (``_fused_ce_fwd_call``)
                          ``vocab_ce_fwd_kernel``
:func:`fused_ce_bwd_dh`   ``vocab_ce_bwd_dh_tc_kernel``,  ``_dh_kernel`` (``_fused_ce_bwd_call``)
                          ``vocab_ce_bwd_dh_kernel``
:func:`fused_ce_bwd_dw`   ``vocab_ce_bwd_dw_tc_kernel``,  ``_dw_kernel`` (``_fused_ce_bwd_call``)
                          ``vocab_ce_bwd_dw_kernel``
========================  ==============================  =============================

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
is written in ``csrc/vocab_ce.cu`` and ``csrc/vocab_ce_tc.cuh``: they are
bound by operations. With bf16 hidden all three (the ``_tc_`` kernels) run
on the bf16 tensor cores with W split into three bf16 pieces that keep the
fp32 logits (:func:`split_bf16` is the split; dH splits dS into two as
well), while their operands fit a block's shared memory
(:func:`tc_smem_bytes`: H up to 1216 for the forward and dH, 800 for dW);
beyond that, and with float32 hidden, they run in fp32 on CUDA cores.

Each wrapper launches its kernels for CUDA tensors and raises for anything
they cannot take; it uses the plain version only for tensors on the CPU.
``fused_ce_fwd.launches``, ``fused_ce_bwd_dh.launches`` and
``fused_ce_bwd_dw.launches`` count wrapper calls that launched.
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
_MAX_SMEM = 232448        # dynamic shared memory an H100 block may use


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
    ``kernel`` (``"fwd"``, ``"dh"`` or ``"dw"``) takes at depth ``h_dim``,
    or -1 where it does not fit a block and bf16 hidden runs on the CUDA
    cores: the mirror of ``vocab_ce_{kernel}_tc_smem_bytes`` in
    ``csrc/vocab_ce.cu``. The forward holds 64 rows of h (H rounded up to
    a 64-column chunk, 16 bytes of row pad), four fp32 partial logit tiles
    of 64 x 40 and two split W chunks; dH 32 rows of h, 32 x 40 partials,
    a split W panel and chunks, dS and the token statistics; dW W's three
    pieces and a 32-row h tile at H rounded up to 16, 32 x 40 partials,
    dSᵀ and the token statistics."""
    f32, b16 = 4, 2
    tile, chunk, kq = 32, 64, 4          # kTcRows = kTcVocab, kTcChunk, kTcKq
    ldr = lds = tile + 8                 # kTcLdr, kTcLds
    ldc, ldp = chunk + 8, 768 + 8        # kTcLdc, kTcLdp
    if kernel in ("fwd", "dh"):
        ldh = -(-h_dim // chunk) * chunk + 8
        if kernel == "fwd":
            rows = _FWD_ROWS
            size = (kq * rows * ldr * f32 + rows * ldh * b16 + 6 * tile * ldc * b16
                    + rows * 4)
        else:
            size = (kq * tile * ldr * f32 + tile * ldh * b16 + 2 * tile * ldp * b16
                    + 6 * tile * ldc * b16 + 2 * tile * lds * b16 + 3 * tile * 4)
    elif kernel == "dw":
        ldw = -(-h_dim // 16) * 16 + 8
        size = kq * tile * ldr * f32 + 4 * tile * ldw * b16 + tile * lds * b16 + 3 * tile * 4
    else:
        raise ValueError(f"no tensor-core kernel {kernel!r}")
    return size if size <= _MAX_SMEM else -1


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
        lib.vocab_ce_fwd_launch.argtypes = [p] * 8 + [i] * 4 + [f] * 3 + [i, p]
        lib.vocab_ce_bwd_dh_launch.argtypes = [p] * 7 + [i] * 4 + [f] * 3 + [i, p]
        lib.vocab_ce_bwd_dw_launch.argtypes = [p] * 6 + [i] * 3 + [f] * 3 + [i, p]
        for fn in (lib.vocab_ce_fwd_launch, lib.vocab_ce_bwd_dh_launch,
                   lib.vocab_ce_bwd_dw_launch):
            fn.restype = ctypes.c_int
        for fn in (lib.vocab_ce_fwd_tc_smem_bytes, lib.vocab_ce_dh_tc_smem_bytes,
                   lib.vocab_ce_dw_tc_smem_bytes):
            fn.argtypes = [i]
            fn.restype = ctypes.c_longlong
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


def fused_ce_fwd(hidden, weight, labels, label_smoothing: float = 0.0):
    """Forward: ``(loss [N] fp32, lse [N] fp32, pred [N] int32)``. CUDA
    tensors go through ``vocab_ce_fwd_tc_kernel`` (bf16 hidden) or
    ``vocab_ce_fwd_kernel`` (float32 hidden), and their combine kernel; CPU
    tensors through :func:`fused_ce_fwd_reference`."""
    _check(hidden, weight, labels)
    eps = _smoothing(label_smoothing)
    if hidden.device.type == "cpu":
        return fused_ce_fwd_reference(hidden, weight, labels, eps)
    lib, lab = _kernel_args("fused_ce_fwd", hidden, weight, labels)
    (N, H), V = hidden.shape, weight.shape[0]
    splits = fwd_splits(N, V)
    dev = hidden.device
    loss = torch.empty(N, dtype=torch.float32, device=dev)
    lse = torch.empty(N, dtype=torch.float32, device=dev)
    pred = torch.empty(N, dtype=torch.int32, device=dev)
    scratch = torch.empty(4 * splits * N, dtype=torch.float32, device=dev)
    scratch_ix = torch.empty(splits * N, dtype=torch.int32, device=dev)
    err = lib.vocab_ce_fwd_launch(
        hidden.data_ptr(), weight.data_ptr(), lab.data_ptr(), loss.data_ptr(),
        lse.data_ptr(), pred.data_ptr(), scratch.data_ptr(), scratch_ix.data_ptr(),
        N, V, H, splits, *_eps_tail(eps, V), int(hidden.dtype == torch.bfloat16),
        _stream(hidden))
    _raise_on(lib, "fused_ce_fwd", err)
    fused_ce_fwd.launches += 1
    return loss, lse, pred


def fused_ce_bwd_dh(hidden, weight, labels, lse, g, label_smoothing: float = 0.0):
    """dH in ``hidden``'s dtype. CUDA tensors go through
    ``vocab_ce_bwd_dh_tc_kernel`` (bf16 hidden) or ``vocab_ce_bwd_dh_kernel``
    (float32 hidden), and their split reduce; CPU tensors through
    :func:`fused_ce_bwd_dh_reference`."""
    _check(hidden, weight, labels)
    eps = _smoothing(label_smoothing)
    if hidden.device.type == "cpu":
        return fused_ce_bwd_dh_reference(hidden, weight, labels, lse, g, eps)
    lse, g = lse.contiguous(), g.contiguous()
    lib, lab = _kernel_args("fused_ce_bwd_dh", hidden, weight, labels, (lse, g))
    (N, H), V = hidden.shape, weight.shape[0]
    splits = dh_splits(N, V)
    dh = torch.empty_like(hidden)
    scratch = torch.empty(splits * N * H, dtype=torch.float32, device=hidden.device)
    err = lib.vocab_ce_bwd_dh_launch(
        hidden.data_ptr(), weight.data_ptr(), lab.data_ptr(), lse.data_ptr(),
        g.data_ptr(), dh.data_ptr(), scratch.data_ptr(), N, V, H, splits,
        *_eps_tail(eps, V), int(hidden.dtype == torch.bfloat16), _stream(hidden))
    _raise_on(lib, "fused_ce_bwd_dh", err)
    fused_ce_bwd_dh.launches += 1
    return dh


def fused_ce_bwd_dw(hidden, weight, labels, lse, g, label_smoothing: float = 0.0):
    """dW in ``weight``'s dtype. CUDA tensors go through
    ``vocab_ce_bwd_dw_tc_kernel`` (bf16 hidden) or ``vocab_ce_bwd_dw_kernel``
    (float32 hidden); CPU tensors through :func:`fused_ce_bwd_dw_reference`."""
    _check(hidden, weight, labels)
    eps = _smoothing(label_smoothing)
    if hidden.device.type == "cpu":
        return fused_ce_bwd_dw_reference(hidden, weight, labels, lse, g, eps)
    lse, g = lse.contiguous(), g.contiguous()
    lib, lab = _kernel_args("fused_ce_bwd_dw", hidden, weight, labels, (lse, g))
    (N, H), V = hidden.shape, weight.shape[0]
    dw = torch.empty_like(weight)
    err = lib.vocab_ce_bwd_dw_launch(
        hidden.data_ptr(), weight.data_ptr(), lab.data_ptr(), lse.data_ptr(),
        g.data_ptr(), dw.data_ptr(), N, V, H, *_eps_tail(eps, V),
        int(hidden.dtype == torch.bfloat16), _stream(hidden))
    _raise_on(lib, "fused_ce_bwd_dw", err)
    fused_ce_bwd_dw.launches += 1
    return dw


fused_ce_fwd.launches = 0
fused_ce_bwd_dh.launches = 0
fused_ce_bwd_dw.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class FusedVocabCE(torch.autograd.Function):
    """``(loss, pred)`` whose backward is the dH and dW kernels; saves only
    the inputs and the LSE (no [N, V] residual). ``pred`` takes no
    gradient."""

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
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = fused_ce_bwd_dh(hidden, weight, labels, lse, g, eps)
        if ctx.needs_input_grad[1]:
            dw = fused_ce_bwd_dw(hidden, weight, labels, lse, g, eps)
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
