"""Flash attention: the hand-written CUDA kernels
(``csrc/flash_attention.cu``, ``csrc/flash_attention_tc.cuh``), their
ctypes wrappers, their plain PyTorch versions, and the
``torch.autograd.Function`` that joins them.

Counterpart of the JAX package's ``ops/pallas_attention.py``:

========================  ===========================  =============================
wrapper                   CUDA kernel                  TPU kernel it replaces
========================  ===========================  =============================
:func:`flash_fwd`         ``flash_fwd_kernel``,        ``_fwd_kernel`` (``_flash_fwd_call``)
                          ``flash_fwd_tc_kernel``
:func:`flash_bwd_dq`      ``flash_bwd_dq_kernel``,     ``_dq_kernel`` (``_flash_bwd_call``)
                          ``flash_bwd_dq_tc_kernel``
:func:`flash_bwd_dkv`     ``flash_bwd_dkv_kernel``,    ``_dkv_kernel`` (``_flash_bwd_call``)
                          ``flash_bwd_dkv_tc_kernel``
========================  ===========================  =============================

Contract (the JAX kernel's): ``q``/``k``/``v`` ``[B, H, S, D]`` in fp32
or bf16 (one dtype), any ``D`` up to 256 for the kernels (instances at 64,
128 and 256; another ``D`` runs on the next instance with ``q``, ``k``,
``v`` (and ``o``, ``dO``) zero-padded on ``D`` and the real ``D``'s scale,
which is exact, and its outputs sliced back: :func:`kernel_head_dim`);
``mask`` ``None``
or additive, broadcastable to ``[B, 1, 1, S_k]``; ``scale`` defaults to
``D ** -0.5``. Logits, running max/sum and the log-sum-exp are fp32;
probabilities are rounded to ``v``'s dtype before ``P·V`` (and ``dS`` to
``k``'s/``q``'s before ``dS·K``/``dSᵀ·Q``); outputs are in the inputs'
dtype; rows whose softmax sum is 0 divide by 1. ``causal`` and
``window`` (which needs ``causal``) mask with ``-1e30`` inside a tile and
skip the tiles the TPU kernel skips. LSE is ``[B, H, S_q]`` fp32. General
``[B, H, Q, K]`` masks go to the plain attention path, as the JAX
dispatch sends them to XLA.

What bounds the kernels on an H100 and what their design does about it
is written at the top of ``csrc/flash_attention.cu`` and
``csrc/flash_attention_tc.cuh``: operations in fp32; in bf16 the bytes,
just above the operations on the tensor cores. In bf16 all three kernels
run their products on the tensor cores and copy 16-byte rows with
``cp.async``, so their bf16 tensors must be 16-byte aligned
(:func:`tc_aligned`); fp32 runs in fp32 on CUDA cores.

Each wrapper launches its kernel for CUDA tensors and raises for anything
the kernel cannot take; it uses the plain version only for tensors on the
CPU. ``flash_fwd.launches``, ``flash_bwd_dq.launches`` and
``flash_bwd_dkv.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

_NEG_INF = -1e30
_KERNEL_HEAD_DIMS = (64, 128, 256)


# ---------------------------------------------------------------------------
# argument handling shared by the plain versions and the kernels
# ---------------------------------------------------------------------------

def _check(q, k, v, mask, causal, window):
    if window is not None and not causal:
        raise ValueError("window requires causal=True (sliding-window "
                         "attention is an autoregressive construct)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 when set, got {window}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q/k/v must be [B, H, S, D] with k and v alike, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if mask is not None and is_general_mask(mask):
        raise ValueError("the flash kernels take a key mask broadcastable to "
                         f"[B, 1, 1, S_k], got {tuple(mask.shape)}")


def is_general_mask(mask) -> bool:
    """A mask that varies over heads or queries (``[B, H, Q, K]``): the JAX
    dispatch sends those to the plain attention path."""
    return mask.dim() == 4 and (mask.shape[1] > 1 or mask.shape[2] > 1)


def _key_mask(mask, B, Sk):
    """The additive mask as fp32 ``[B, S_k]`` (a view when it already is)."""
    if mask is None:
        return None
    return mask.float().expand(B, 1, 1, Sk).reshape(B, Sk).contiguous()


def _causal_add(Sq, Sk, window, device):
    """The TPU kernel's ``_causal_mask_block`` over the whole [Sq, Sk]."""
    i = torch.arange(Sq, device=device)[:, None]
    j = torch.arange(Sk, device=device)[None, :]
    keep = j <= i
    if window is not None:
        keep = keep & (j > i - window)
    return torch.where(keep, 0.0, _NEG_INF)


def _logits(q, k, mask, scale, causal, window):
    """fp32 ``q·kᵀ·scale + mask (+ causal)`` [B, H, Sq, Sk]."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = s + mask.float()
    if causal:
        s = s + _causal_add(q.shape[2], k.shape[2], window, q.device)
    return s


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def kernel_head_dim(D: int) -> int:
    """The head dim of the kernel instance that runs head dim ``D``: the
    least instance at or above it. Raises ``ValueError`` above 256, the
    widest instance (ROADMAP queue 2)."""
    for inst in _KERNEL_HEAD_DIMS:
        if D <= inst:
            return inst
    raise ValueError(f"the flash kernels take head_dim up to {_KERNEL_HEAD_DIMS[-1]}, "
                     f"got {D} (ROADMAP queue 2: head_dim above 256)")


def pad_head_dim(to: int, *tensors):
    """Each tensor (None stays None) zero-padded on its last dimension to
    ``to``. Attention on the padded q, k and v with the real head dim's
    scale is the attention of the unpadded ones, its extra output columns
    zero; so are the gradients, on padded ``o`` and ``dO``."""
    return tuple(None if t is None else
                 torch.nn.functional.pad(t, (0, to - t.shape[-1])) for t in tensors)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def flash_attention_fwd_reference(q, k, v, mask=None, scale=None,
                                  causal: bool = False,
                                  window: int | None = None):
    """The plain version of the forward kernel: ``(o, lse)`` from the
    same formulas, softmax over the whole row at once."""
    _check(q, k, v, mask, causal, window)
    s = _logits(q, k, mask, _scale(q, scale), causal, window)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    safe_l = torch.where(l == 0, 1.0, l)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / safe_l
    return o.to(q.dtype), (m + torch.log(safe_l))[..., 0]


def _bwd_terms(q, k, v, mask, o, lse, do, scale, causal, window):
    """P and dS = P ∘ (dO·Vᵀ − Δ), Δ = Σ_d dO·O, all fp32."""
    s = _logits(q, k, mask, scale, causal, window)
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    return p, p * (dp - delta)


def flash_bwd_dq_reference(q, k, v, mask, o, lse, do, scale=None,
                           causal: bool = False, window: int | None = None):
    """The plain version of the dQ kernel: ``scale · dS·K`` with dS
    rounded to ``k``'s dtype."""
    _check(q, k, v, mask, causal, window)
    scale = _scale(q, scale)
    _, ds = _bwd_terms(q, k, v, mask, o, lse, do, scale, causal, window)
    return (torch.matmul(ds.to(k.dtype).float(), k.float()) * scale).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, mask, o, lse, do, scale=None,
                            causal: bool = False, window: int | None = None,
                            want_dmask: bool = True):
    """The plain version of the dK/dV kernel: ``(dk, dv, dmask)`` with
    ``dk = scale · dSᵀ·Q``, ``dv = Pᵀ·dO`` (dS and P rounded to the input
    dtype) and ``dmask`` = dS summed over heads and queries to the mask's
    shape (fp32; None without a mask or ``want_dmask``)."""
    _check(q, k, v, mask, causal, window)
    scale = _scale(q, scale)
    p, ds = _bwd_terms(q, k, v, mask, o, lse, do, scale, causal, window)
    dk = (torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
          * scale).to(k.dtype)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2),
                      do.float()).to(v.dtype)
    dmask = None
    if want_dmask and mask is not None:
        # the mask broadcasts over heads and queries: its cotangent sums them
        dmask = ds.sum(dim=(1, 2), keepdim=True).sum_to_size(mask.shape)
    return dk, dv, dmask


def flash_attention_bwd_reference(q, k, v, mask, o, lse, do, scale=None,
                                  causal: bool = False,
                                  window: int | None = None):
    """The plain version of the two backward kernels, written out from the
    same formulas (not autograd): ``(dq, dk, dv, dmask)``, ``dmask`` None
    without a mask, else fp32 in the mask's shape."""
    dq = flash_bwd_dq_reference(q, k, v, mask, o, lse, do, scale, causal, window)
    dk, dv, dmask = flash_bwd_dkv_reference(q, k, v, mask, o, lse, do, scale,
                                            causal, window)
    return dq, dk, dv, dmask


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _kernel_lib():
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    if lib.flash_fwd_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        tail = [i] * 5 + [ctypes.c_float] + [i] * 3 + [p]
        lib.flash_fwd_launch.argtypes = [p] * 7 + tail
        lib.flash_bwd_dq_launch.argtypes = [p] * 9 + tail
        lib.flash_bwd_dkv_launch.argtypes = [p] * 11 + tail
        for fn in (lib.flash_fwd_launch, lib.flash_bwd_dq_launch,
                   lib.flash_bwd_dkv_launch):
            fn.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [i, i, i]
        lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def load_kernel() -> None:
    """Build (at first use) and load the kernels' library."""
    _kernel_lib()


def _kernel_args(name, q, k, v, mask, extra):
    """Checks what the kernels take; returns (lib, fp32 [B, Sk] mask or
    None, packed (batch, head, row) element strides of q, k, v and
    ``extra``, int bf16 flag)."""
    D = q.shape[-1]
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: kernel instances take head_dim {_KERNEL_HEAD_DIMS}, "
                         f"got {D} (a narrower one is padded first)")
    if q.device.type != "cuda":
        raise ValueError(f"{name} has no kernel for device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    tensors = [q, k, v] + list(extra)
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on {q.device}, got "
                             f"one on {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: all tensors must be {q.dtype}, got {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dimension must be contiguous")
    if mask is not None and mask.device != q.device:
        raise ValueError(f"{name}: mask must be on {q.device}")
    strides = [s for t in tensors for s in t.stride()[:3]]
    return (_kernel_lib(), _key_mask(mask, q.shape[0], k.shape[2]),
            (ctypes.c_longlong * len(strides))(*strides),
            int(q.dtype == torch.bfloat16))


def tc_aligned(t: torch.Tensor) -> bool:
    """Whether the tensor-core kernels can copy ``t`` ([B, H, S, D]) in
    16-byte rows: its base address and its batch, head and row strides
    are multiples of 16 bytes."""
    esz = t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(s * esz % 16 == 0 for s in t.stride()[:3]))


def _check_tc_aligned(name, tensors):
    for t in tensors:
        if not tc_aligned(t):
            raise ValueError(
                f"{name}: the bf16 kernel copies 16-byte rows; got a tensor at "
                f"address {t.data_ptr():#x} with strides {tuple(t.stride())} "
                f"(elements of {t.element_size()} bytes)")


def _raise_on(lib, name, err):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()} ({err})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _tail(q, k, scale, causal, window, bf16):
    B, H, Sq, D = q.shape
    return (B, H, Sq, k.shape[2], D, _scale(q, scale), int(causal),
            0 if window is None else int(window), bf16,
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_fwd(q, k, v, mask=None, scale=None, causal: bool = False,
              window: int | None = None, want_lse: bool = True):
    """Forward: ``(o, lse)`` (``lse`` None unless ``want_lse``). CUDA
    tensors go through ``flash_fwd_kernel`` (fp32) or
    ``flash_fwd_tc_kernel`` (bf16); CPU tensors through
    :func:`flash_attention_fwd_reference`."""
    _check(q, k, v, mask, causal, window)
    if q.device.type == "cpu":
        o, lse = flash_attention_fwd_reference(q, k, v, mask, scale, causal, window)
        return o, (lse if want_lse else None)
    D = q.shape[-1]
    if kernel_head_dim(D) != D:
        o, lse = flash_fwd(*pad_head_dim(kernel_head_dim(D), q, k, v), mask,
                           _scale(q, scale), causal, window, want_lse)
        return o[..., :D], lse
    lib, m, strides_in, bf16 = _kernel_args("flash_fwd", q, k, v, mask, ())
    if bf16:
        _check_tc_aligned("flash_fwd", (q, k, v))
    B, H, Sq, D = q.shape
    # O in [B, S, H, D] memory, viewed as [B, H, S, D]: merging heads after
    # attention is then free
    out = torch.empty(B, Sq, H, D, dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
           if want_lse else None)
    strides = (ctypes.c_longlong * 12)(*strides_in, *out.stride()[:3])
    err = lib.flash_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(m),
                               out.data_ptr(), _ptr(lse), strides,
                               *_tail(q, k, scale, causal, window, bf16))
    _raise_on(lib, "flash_fwd", err)
    flash_fwd.launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, mask, o, lse, do, scale=None, causal: bool = False,
                 window: int | None = None):
    """dQ. CUDA tensors go through ``flash_bwd_dq_kernel`` (fp32) or
    ``flash_bwd_dq_tc_kernel`` (bf16); CPU tensors through
    :func:`flash_bwd_dq_reference`."""
    _check(q, k, v, mask, causal, window)
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, mask, o, lse, do, scale, causal, window)
    D = q.shape[-1]
    if kernel_head_dim(D) != D:
        qp, kp, vp, op, dop = pad_head_dim(kernel_head_dim(D), q, k, v, o, do)
        return flash_bwd_dq(qp, kp, vp, mask, op, lse, dop, _scale(q, scale), causal,
                            window)[..., :D]
    lib, m, strides_in, bf16 = _kernel_args("flash_bwd_dq", q, k, v, mask, (o, do))
    if bf16:
        _check_tc_aligned("flash_bwd_dq", (q, k, v, o, do))
    lse = _float_rows(lse, q)
    dq = torch.empty_like(q)
    strides = (ctypes.c_longlong * 18)(*strides_in, *dq.stride()[:3])
    err = lib.flash_bwd_dq_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(m),
                                  o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                  dq.data_ptr(), strides,
                                  *_tail(q, k, scale, causal, window, bf16))
    _raise_on(lib, "flash_bwd_dq", err)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, mask, o, lse, do, scale=None, causal: bool = False,
                  window: int | None = None, want_dmask: bool = False):
    """``(dk, dv, dmask)``; ``dmask`` (fp32, the mask's shape) only with
    ``want_dmask`` and a mask. CUDA tensors go through
    ``flash_bwd_dkv_kernel`` (fp32) or ``flash_bwd_dkv_tc_kernel`` (bf16);
    the sum of its per-head ``dmask`` over heads is a plain ``torch.sum``,
    as the JAX package sums outside Pallas. CPU tensors go through
    :func:`flash_bwd_dkv_reference`."""
    _check(q, k, v, mask, causal, window)
    want_dmask = want_dmask and mask is not None
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, mask, o, lse, do, scale, causal,
                                       window, want_dmask)
    D = q.shape[-1]
    if kernel_head_dim(D) != D:
        qp, kp, vp, op, dop = pad_head_dim(kernel_head_dim(D), q, k, v, o, do)
        dk, dv, dmask = flash_bwd_dkv(qp, kp, vp, mask, op, lse, dop, _scale(q, scale),
                                      causal, window, want_dmask)
        return dk[..., :D], dv[..., :D], dmask
    lib, m, strides_in, bf16 = _kernel_args("flash_bwd_dkv", q, k, v, mask, (o, do))
    if bf16:
        _check_tc_aligned("flash_bwd_dkv", (q, k, v, o, do))
    lse = _float_rows(lse, q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    B, H, _, _ = q.shape
    dmask_bh = (torch.empty(B, H, k.shape[2], dtype=torch.float32, device=q.device)
                if want_dmask else None)
    strides = (ctypes.c_longlong * 21)(*strides_in, *dk.stride()[:3], *dv.stride()[:3])
    err = lib.flash_bwd_dkv_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(m),
                                   o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                   dk.data_ptr(), dv.data_ptr(), _ptr(dmask_bh),
                                   strides, *_tail(q, k, scale, causal, window, bf16))
    _raise_on(lib, "flash_bwd_dkv", err)
    flash_bwd_dkv.launches += 1
    dmask = None
    if want_dmask:
        dmask = dmask_bh.sum(1).reshape(B, 1, 1, -1).sum_to_size(mask.shape)
    return dk, dv, dmask


def _float_rows(lse, q):
    B, H, Sq, _ = q.shape
    if lse.dtype != torch.float32 or lse.shape != (B, H, Sq):
        raise ValueError(f"lse must be float32 [{B}, {H}, {Sq}], got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    return lse.contiguous()


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class FlashAttention(torch.autograd.Function):
    """``o = attention(q, k, v, mask)`` whose backward is the dQ and
    dK/dV/dmask kernels; saves only ``o`` and the LSE besides the inputs
    (no [S, S] residual)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, causal, window):
        o, lse = flash_fwd(q, k, v, mask, scale, causal, window, want_lse=True)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.attrs = (scale, causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, o, lse = ctx.saved_tensors
        scale, causal, window = ctx.attrs
        if do.stride(-1) != 1 or (do.dtype == torch.bfloat16 and not tc_aligned(do)):
            do = do.clone(memory_format=torch.contiguous_format)
        dq = dk = dv = dmask = None
        if ctx.needs_input_grad[0]:
            dq = flash_bwd_dq(q, k, v, mask, o, lse, do, scale, causal, window)
        if any(ctx.needs_input_grad[1:4]):
            dk, dv, dmask = flash_bwd_dkv(q, k, v, mask, o, lse, do, scale, causal,
                                          window, want_dmask=ctx.needs_input_grad[3])
        return dq, dk, dv, dmask, None, None, None


def flash_attention(q, k, v, mask=None, scale=None, causal: bool = False,
                    window: int | None = None):
    """Differentiable flash attention (the JAX ``flash_attention``).
    Without a gradient to take, only the forward kernel runs and no LSE is
    written (the JAX inference path); general ``[B, H, Q, K]`` masks go to
    the plain attention path."""
    if mask is not None and is_general_mask(mask):
        from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.attention import (
            dot_product_attention,
        )

        return dot_product_attention(q, k, v, mask, scale=scale, impl="xla",
                                     causal=causal, window=window)
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, mask))
    if not needs_grad:
        return flash_fwd(q, k, v, mask, scale, causal, window, want_lse=False)[0]
    return FlashAttention.apply(q, k, v, mask, scale, causal, window)
