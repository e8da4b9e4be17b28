"""PyTorch port: flash attention (``ops/flash_attention.py``) and the
attention dispatch and masks (``ops/attention.py``) against the JAX
package on the same numpy inputs: the plain forward ``(o, lse)`` against
the Pallas kernel in interpret mode, the plain backward ``(dq, dk, dv,
dmask)`` against ``jax.vjp`` through the same kernel and against
``torch.autograd`` over the port's plain attention, a fully padded row,
and the autograd ``Function`` on CPU tensors. Plus the three CUDA kernels
against their plain versions on the card (skipped without one).

Tolerances: fp32 1e-5 (the same fp32 arithmetic, summed in another order);
a bf16 output 2^-6 of its largest entry (one bf16 ulp is at most 2^-7 of a
value, and both sides round; the older bf16 forward test keeps 2e-2);
fp32 outputs of bf16 inputs (LSE, dmask) as fp32. The card's tests hold
the kernels to the same limits."""

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import attention as t_attn
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import flash_attention as fa

TOL = 1e-5
B, H, S, D = 2, 2, 32, 16
BLOCK = 16              # JAX kernel tiles: 2 x 2 tiles per (batch, head)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread per test worker runs
    them faster than a pool contending with the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _detached_compile_trackers():
    """A compile tracker that an earlier telemetry test installed in this
    worker rejects the ``fun_name`` keyword jax 0.9 passes to duration
    listeners, failing every later jax compile in the worker. Remove every
    installed tracker before and after this module, leaving the worker as a
    fresh one would be (a later telemetry test installs its own). (The
    card's machine runs the ``gpu`` tests without JAX: nothing to remove.)"""
    _drop_compile_trackers()
    yield
    _drop_compile_trackers()


def _drop_compile_trackers():
    try:
        from jax import monitoring

        from huggingface_sagemaker_tensorflow_distributed_tpu.obs import watchdog
    except ImportError:
        return
    for tracker in watchdog._INSTALLED:
        try:
            monitoring.unregister_event_duration_listener(tracker.observe)
        except AssertionError:
            pass
    watchdog._INSTALLED.clear()


def _inputs(seed, masked=True, pad_row=False, b=B, s=S, d=D):
    """numpy q, k, v, dO [b, H, s, d] and an additive [b, 1, 1, s] -1e9
    padding mask with ragged lengths (row 0 all padding with pad_row)."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(b, H, s, d).astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        lens = rng.randint(s // 4, s + 1, size=b)
        lens[-1] = s
        if pad_row:
            lens[0] = 0
        keep = (np.arange(s)[None, :] < lens[:, None]).astype(np.float32)
        mask = ((1.0 - keep) * -1e9)[:, None, None, :].astype(np.float32)
    return q, k, v, do, mask


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    import jax.numpy as jnp

    return None if x is None else jnp.asarray(x)


def _jax_fwd(q, k, v, mask, causal=False, window=None):
    from huggingface_sagemaker_tensorflow_distributed_tpu.ops.pallas_attention import (
        _flash_fwd_call,
    )

    o, lse = _flash_fwd_call(_j(q), _j(k), _j(v), _j(mask), D ** -0.5, BLOCK, BLOCK,
                             causal, True, want_lse=True, window=window)
    return np.asarray(o), np.asarray(lse)[..., 0]


def _jax_grads(q, k, v, mask, do, causal=False, window=None):
    import jax

    from huggingface_sagemaker_tensorflow_distributed_tpu.ops.pallas_attention import (
        flash_attention,
    )

    def f(q_, k_, v_, m_):
        return flash_attention(q_, k_, v_, mask=m_, block_q=BLOCK, block_k=BLOCK,
                               causal=causal, interpret=True, window=window)

    _, vjp = jax.vjp(f, _j(q), _j(k), _j(v), _j(mask))
    return [None if g is None else np.asarray(g) for g in vjp(_j(do))]


MODES = [("mask", True, False, None), ("nomask", False, False, None),
         ("causal", False, True, None), ("causal_window", True, True, 6)]


@pytest.mark.parametrize("mode", MODES, ids=[m[0] for m in MODES])
def test_forward_reference_matches_pallas(mode):
    _, masked, causal, window = mode
    q, k, v, _, mask = _inputs(1, masked=masked)
    o, lse = fa.flash_attention_fwd_reference(_t(q), _t(k), _t(v), _t(mask),
                                              causal=causal, window=window)
    want_o, want_lse = _jax_fwd(q, k, v, mask, causal, window)
    np.testing.assert_allclose(o.numpy(), want_o, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=TOL, atol=TOL)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)


@pytest.mark.parametrize("mode", MODES, ids=[m[0] for m in MODES])
def test_backward_reference_matches_pallas_vjp(mode):
    _, masked, causal, window = mode
    q, k, v, do, mask = _inputs(2, masked=masked)
    o, lse = fa.flash_attention_fwd_reference(_t(q), _t(k), _t(v), _t(mask),
                                              causal=causal, window=window)
    got = fa.flash_attention_bwd_reference(_t(q), _t(k), _t(v), _t(mask), o, lse, _t(do),
                                           causal=causal, window=window)
    want = _jax_grads(q, k, v, mask, do, causal, window)
    for name, g, w in zip(("dq", "dk", "dv", "dmask"), got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("mode", MODES, ids=[m[0] for m in MODES])
@pytest.mark.parametrize("d", [256, 96])
def test_wide_head_reference_matches_pallas(d, mode):
    """Gemma's head_dim 256, and 96 (which the card runs padded to 128):
    the plain forward (O, LSE) against the Pallas kernel, and the plain
    backward (dQ, dK, dV, dmask) against ``jax.vjp`` through it, both in
    interpret mode."""
    _, masked, causal, window = mode
    q, k, v, do, mask = _inputs(31, masked=masked, d=d)
    from huggingface_sagemaker_tensorflow_distributed_tpu.ops.pallas_attention import (
        _flash_fwd_call,
    )

    o, lse = fa.flash_attention_fwd_reference(_t(q), _t(k), _t(v), _t(mask),
                                              causal=causal, window=window)
    want_o, want_lse = _flash_fwd_call(_j(q), _j(k), _j(v), _j(mask), d ** -0.5, BLOCK,
                                       BLOCK, causal, True, want_lse=True, window=window)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], rtol=TOL, atol=TOL)
    got = fa.flash_attention_bwd_reference(_t(q), _t(k), _t(v), _t(mask), o, lse, _t(do),
                                           causal=causal, window=window)
    want = _jax_grads(q, k, v, mask, do, causal, window)
    for name, g, w in zip(("dq", "dk", "dv", "dmask"), got, want):
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("mode", MODES, ids=[m[0] for m in MODES])
def test_padded_head_dim_equals_the_unpadded_call(mode):
    """The wrappers' padding of a head_dim without a kernel instance: the
    plain twins on q, k, v, O and dO zero-padded from 96 to
    ``kernel_head_dim(96)`` (128) with 96's scale, sliced back, give the
    unpadded call's O, LSE, dQ, dK, dV and dmask (1e-6: the same sums with
    zero terms added)."""
    _, masked, causal, window = mode
    q, k, v, do, mask = (_t(x) for x in _inputs(32, masked=masked, d=96))
    to = fa.kernel_head_dim(96)
    assert to == 128
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention_fwd_reference(q, k, v, mask, **kw)
    qp, kp, vp, op, dop = fa.pad_head_dim(to, q, k, v, o, do)
    assert qp.shape[-1] == to and bool((qp[..., 96:] == 0).all())
    po, plse = fa.flash_attention_fwd_reference(qp, kp, vp, mask, 96 ** -0.5, **kw)
    np.testing.assert_allclose(po[..., :96].numpy(), o.numpy(), rtol=1e-6, atol=1e-6)
    assert bool((po[..., 96:] == 0).all())
    np.testing.assert_allclose(plse.numpy(), lse.numpy(), rtol=1e-6, atol=1e-6)
    want = fa.flash_attention_bwd_reference(q, k, v, mask, o, lse, do, **kw)
    got = fa.flash_attention_bwd_reference(qp, kp, vp, mask, op, lse, dop, 96 ** -0.5, **kw)
    for name, g, w in zip(("dq", "dk", "dv", "dmask"), got, want):
        if w is None:
            assert g is None, name
            continue
        g = g[..., :96] if name != "dmask" else g
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_reference_matches_torch_autograd_of_plain_attention(causal):
    q, k, v, do, mask = _inputs(3, masked=not causal)
    o, lse = fa.flash_attention_fwd_reference(_t(q), _t(k), _t(v), _t(mask), causal=causal)
    got = fa.flash_attention_bwd_reference(_t(q), _t(k), _t(v), _t(mask), o, lse, _t(do),
                                           causal=causal)
    leaves = [_t(x).clone().requires_grad_(True) for x in (q, k, v)]
    m = None if mask is None else _t(mask).clone().requires_grad_(True)
    out = t_attn.dot_product_attention(*leaves, mask=m, impl="xla", causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), o.numpy(), rtol=TOL, atol=TOL)
    want = torch.autograd.grad(out, leaves + ([m] if m is not None else []), _t(do))
    for name, g, w in zip(("dq", "dk", "dv", "dmask"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL, err_msg=name)


def test_fully_padded_row_matches_pallas():
    """A batch row whose keys are all padding: every logit is -1e9 (the
    scores vanish against it in fp32), so the row attends uniformly; the
    output is finite and equal to the Pallas kernel's, and so are the
    gradients (its LSE rounds to -1e9, as in the TPU kernel)."""
    q, k, v, do, mask = _inputs(4, pad_row=True)
    o, lse = fa.flash_attention_fwd_reference(_t(q), _t(k), _t(v), _t(mask))
    want_o, want_lse = _jax_fwd(q, k, v, mask)
    assert np.isfinite(o.numpy()).all()
    np.testing.assert_allclose(o.numpy(), want_o, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(o[0].numpy(), np.broadcast_to(v[0].mean(1, keepdims=True),
                                                             o[0].shape), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=TOL, atol=TOL)
    got = fa.flash_attention_bwd_reference(_t(q), _t(k), _t(v), _t(mask), o, lse, _t(do))
    for g, w in zip(got, _jax_grads(q, k, v, mask, do)):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)


def test_bf16_forward_matches_pallas():
    """bf16 inputs: P rounded to bf16 before P.V in both, output in bf16."""
    import jax.numpy as jnp

    q, k, v, _, mask = _inputs(5)
    to_bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    o, _ = fa.flash_attention_fwd_reference(*to_bf, _t(mask))
    assert o.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in to_bf)
    from huggingface_sagemaker_tensorflow_distributed_tpu.ops.pallas_attention import (
        flash_attention,
    )

    want = np.asarray(flash_attention(jq, jk, jv, mask=_j(mask), block_q=S, block_k=S,
                                      interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(o.float().numpy(), want, rtol=2e-2, atol=2e-2)


def _bf16(x):
    """numpy fp32 -> (torch bf16, jax bf16) holding the same values."""
    import jax.numpy as jnp

    if x is None:
        return None, None
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _bf16_limit(want):
    """A bf16 output against the Pallas kernel: 2^-6 x max|want| (one bf16
    ulp is at most 2^-7 of a value; both sides round their output, and P,
    dS and O round against other maxima or sums in another order, which can
    move a rounding by one step)."""
    return 2.0 ** -6 * float(np.abs(want).max())


@pytest.mark.parametrize("mode", MODES, ids=[m[0] for m in MODES])
def test_bf16_forward_reference_matches_pallas(mode):
    """bf16 q, k, v through the plain forward and through the Pallas kernel
    (interpret mode, 2 x 2 tiles, so the kernel rounds P against the running
    max): O in bf16 within the bf16 limit; the fp32 LSE to 1e-5 relative
    (fp32 logits of bf16-exact values)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.ops.pallas_attention import (
        _flash_fwd_call,
    )

    _, masked, causal, window = mode
    q, k, v, _, mask = _inputs(21, masked=masked)
    (tq, jq), (tk, jk), (tv, jv) = _bf16(q), _bf16(k), _bf16(v)
    o, lse = fa.flash_attention_fwd_reference(tq, tk, tv, _t(mask), causal=causal,
                                              window=window)
    want_o, want_lse = _flash_fwd_call(jq, jk, jv, _j(mask), D ** -0.5, BLOCK, BLOCK, causal,
                                       True, want_lse=True, window=window)
    want_o = np.asarray(want_o.astype(np.float32))
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert np.abs(o.float().numpy() - want_o).max() <= _bf16_limit(want_o)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], rtol=1e-5, atol=1e-5)


BF16_BWD_MODES = MODES + [("pad_row", True, False, None)]


@pytest.mark.parametrize("mode", BF16_BWD_MODES, ids=[m[0] for m in BF16_BWD_MODES])
def test_bf16_backward_reference_matches_pallas_vjp(mode):
    """bf16 q, k, v, dO: the plain backward (P and dS rounded to bf16 before
    their products) against ``jax.vjp`` through ``_flash_vjp`` with the
    Pallas kernels in interpret mode, fed the O and LSE of the Pallas
    forward that the vjp saves (so Δ reads the same bf16 O on both sides).
    dQ, dK, dV (bf16) within the bf16 limit; dmask, an fp32 sum of fp32 dS,
    within 1e-4 x max(1, max|want|)."""
    import jax

    from huggingface_sagemaker_tensorflow_distributed_tpu.ops.pallas_attention import (
        _flash_fwd_call,
        _flash_vjp,
    )

    name, masked, causal, window = mode
    q, k, v, do, mask = _inputs(22, masked=masked, pad_row=name == "pad_row")
    (tq, jq), (tk, jk), (tv, jv), (tdo, jdo) = _bf16(q), _bf16(k), _bf16(v), _bf16(do)
    jo, jlse = _flash_fwd_call(jq, jk, jv, _j(mask), D ** -0.5, BLOCK, BLOCK, causal, True,
                               want_lse=True, window=window)
    o = torch.from_numpy(np.array(jo.astype(np.float32))).to(torch.bfloat16)
    lse = torch.from_numpy(np.asarray(jlse)[..., 0].copy())
    got = fa.flash_attention_bwd_reference(tq, tk, tv, _t(mask), o, lse, tdo,
                                           causal=causal, window=window)

    def f(q_, k_, v_, m_):
        return _flash_vjp(q_, k_, v_, m_, D ** -0.5, BLOCK, BLOCK, causal, True, window)

    _, vjp = jax.vjp(f, jq, jk, jv, _j(mask))
    want = vjp(jdo)
    for gname, g, w in zip(("dq", "dk", "dv", "dmask"), got, want):
        if w is None:
            assert g is None, gname
            continue
        w = np.asarray(w.astype(np.float32))
        if gname == "dmask":
            assert g.dtype == torch.float32
            limit = 1e-4 * max(1.0, float(np.abs(w).max()))
        else:
            assert g.dtype == torch.bfloat16, gname
            limit = _bf16_limit(w)
        assert np.abs(g.float().numpy() - w).max() <= limit, gname


def test_bf16_autograd_function_on_cpu_tensors():
    """bf16 leaves through ``flash_attention``: the Function's gradients are
    the plain bf16 backward's, bit for bit, and no kernel launches."""
    q, k, v, do, mask = _inputs(23)
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True) for x in (q, k, v)]
    m = _t(mask).clone().requires_grad_(True)
    launches = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    tdo = torch.from_numpy(do).to(torch.bfloat16)
    out = fa.flash_attention(*leaves, m)
    out.backward(tdo)
    detached = [x.detach() for x in leaves]
    o, lse = fa.flash_attention_fwd_reference(*detached, _t(mask))
    want = fa.flash_attention_bwd_reference(*detached, _t(mask), o, lse, tdo)
    assert torch.equal(out.detach(), o)
    for g, w in zip([x.grad for x in leaves] + [m.grad], want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == launches


def _model_layout(b=2, s=16, h=3, d=64, dtype=torch.bfloat16):
    """[b, h, s, d] view of [b, s, h, d] memory, as the model makes q/k/v."""
    return torch.zeros(b, s, h, d, dtype=dtype).transpose(1, 2)


ALIGN_CASES = [
    # name, tensor, aligned
    ("model_layout", lambda: _model_layout(), True),
    ("contiguous", lambda: torch.zeros(2, 3, 16, 64, dtype=torch.bfloat16), True),
    ("fp32_model_layout", lambda: _model_layout(dtype=torch.float32), True),
    ("base_off_by_one", lambda: torch.zeros(2 * 16 * 3 * 64 + 8, dtype=torch.bfloat16)[1:]
     .as_strided((2, 3, 16, 64), (16 * 3 * 64, 64, 3 * 64, 1)), False),
    ("row_stride_not_16_bytes", lambda: torch.zeros(2, 16, 3 * 64 + 4, dtype=torch.bfloat16)
     .as_strided((2, 3, 16, 64), (16 * (3 * 64 + 4), 64, 3 * 64 + 4, 1)), False),
    ("head_stride_not_16_bytes", lambda: torch.zeros(2 * 16 * 208, dtype=torch.bfloat16)
     .as_strided((2, 3, 16, 64), (16 * 208, 68, 208, 1)), False),
]


@pytest.mark.parametrize("case", ALIGN_CASES, ids=[c[0] for c in ALIGN_CASES])
def test_tc_aligned(case):
    """The tensor-core kernels copy 16-byte rows: base address and batch,
    head and row strides must be multiples of 16 bytes."""
    _, make, aligned = case
    t = make()
    assert fa.tc_aligned(t) is aligned
    if aligned:
        fa._check_tc_aligned("flash_fwd", (t,))
    else:
        with pytest.raises(ValueError, match="16-byte rows"):
            fa._check_tc_aligned("flash_fwd", (t,))


def _on_meta(t):
    """``t``'s sizes, strides and storage offset on the meta device."""
    base = torch.empty(t.untyped_storage().nbytes() // t.element_size(), dtype=t.dtype,
                       device="meta")
    return base.as_strided(t.shape, t.stride(), t.storage_offset())


DQ_ALIGN_CASES = [
    # name, the tensor made misaligned (None: all aligned), its layout
    ("aligned", None, None),
    ("q_base_off_by_one", 0, "base_off_by_one"),
    ("k_row_stride", 1, "row_stride_not_16_bytes"),
    ("v_head_stride", 2, "head_stride_not_16_bytes"),
    ("o_base_off_by_one", 3, "base_off_by_one"),
    ("do_row_stride", 4, "row_stride_not_16_bytes"),
]


@pytest.mark.parametrize("case", DQ_ALIGN_CASES, ids=[c[0] for c in DQ_ALIGN_CASES])
def test_bf16_dq_checks_tc_alignment(case, monkeypatch):
    """The bf16 dQ runs on the tensor-core kernel, which copies 16-byte
    rows: ``flash_bwd_dq`` raises before any launch when one of q, k, v,
    o, dO is not 16-byte aligned, and launches otherwise. Meta tensors
    carry the CUDA-shaped layouts; the library and the stream are stubbed
    (the kernel runs only on the card)."""
    _, which, layout = case
    layouts = {c[0]: c[1] for c in ALIGN_CASES}
    tensors = [_on_meta(_model_layout()) for _ in range(5)]
    if which is not None:
        tensors[which] = _on_meta(layouts[layout]())
    q, k, v, o, do = tensors
    lse = torch.empty(2, 3, 16, device="meta")
    calls = []

    class Lib:
        def flash_bwd_dq_launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(fa, "_kernel_args", lambda name, q, k, v, mask, extra: (
        Lib(), None, [s for t in (q, k, v) + tuple(extra) for s in t.stride()[:3]], 1))
    monkeypatch.setattr(fa, "_tail", lambda *a: ())
    before = fa.flash_bwd_dq.launches
    if which is None:
        assert fa.flash_bwd_dq(q, k, v, None, o, lse, do).shape == q.shape
        assert len(calls) == 1 and fa.flash_bwd_dq.launches == before + 1
    else:
        with pytest.raises(ValueError, match="flash_bwd_dq: the bf16 kernel copies 16-byte rows"):
            fa.flash_bwd_dq(q, k, v, None, o, lse, do)
        assert not calls and fa.flash_bwd_dq.launches == before


@pytest.mark.parametrize("masked", [True, False])
def test_autograd_function_on_cpu_tensors(masked):
    """``flash_attention`` with gradients on CPU tensors: the Function runs
    the plain versions (no kernel launch), and its gradients are the plain
    backward's, the mask's included."""
    q, k, v, do, mask = _inputs(6, masked=masked)
    leaves = [_t(x).clone().requires_grad_(True) for x in (q, k, v)]
    m = None if mask is None else _t(mask).clone().requires_grad_(True)
    launches = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    out = fa.flash_attention(*leaves, m)
    out.backward(_t(do))
    o, lse = fa.flash_attention_fwd_reference(_t(q), _t(k), _t(v), _t(mask))
    want = fa.flash_attention_bwd_reference(_t(q), _t(k), _t(v), _t(mask), o, lse, _t(do))
    np.testing.assert_array_equal(out.detach().numpy(), o.numpy())
    got = [x.grad for x in leaves] + [None if m is None else m.grad]
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == launches
    with torch.no_grad():                       # the inference path: no LSE
        np.testing.assert_array_equal(fa.flash_attention(*leaves, m).numpy(), o.numpy())


def test_mask_without_grad_gets_no_gradient():
    q, k, v, do, mask = _inputs(7)
    leaves = [_t(x).clone().requires_grad_(True) for x in (q, k, v)]
    fa.flash_attention(*leaves, _t(mask)).backward(_t(do))
    assert all(x.grad is not None for x in leaves)


def test_wrappers_on_cpu_are_the_plain_versions():
    q, k, v, do, mask = (_t(x) for x in _inputs(8))
    o, lse = fa.flash_fwd(q, k, v, mask)
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, mask)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert fa.flash_fwd(q, k, v, mask, want_lse=False)[1] is None
    assert torch.equal(fa.flash_bwd_dq(q, k, v, mask, o, lse, do),
                       fa.flash_bwd_dq_reference(q, k, v, mask, o, lse, do))
    dk, dv, dm = fa.flash_bwd_dkv(q, k, v, mask, o, lse, do, want_dmask=True)
    rk, rv, rm = fa.flash_bwd_dkv_reference(q, k, v, mask, o, lse, do)
    assert torch.equal(dk, rk) and torch.equal(dv, rv) and torch.equal(dm, rm)
    assert dm.shape == mask.shape and dm.dtype == torch.float32
    assert fa.flash_bwd_dkv(q, k, v, mask, o, lse, do)[2] is None


def test_general_mask_takes_the_plain_path():
    """A [B, H, Q, K] mask goes to the plain attention path, as the JAX
    dispatch sends it to XLA."""
    q, k, v, _, _ = _inputs(9, masked=False)
    rng = np.random.RandomState(9)
    full = np.where(rng.rand(B, H, S, S) > 0.3, 0.0, -1e9).astype(np.float32)
    got = fa.flash_attention(_t(q), _t(k), _t(v), _t(full))
    want = t_attn.xla_attention(_t(q), _t(k), _t(v), _t(full))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError):
        fa.flash_fwd(_t(q), _t(k), _t(v), _t(full))


def test_dispatch_flash_matches_xla_and_jax():
    from huggingface_sagemaker_tensorflow_distributed_tpu.ops.attention import (
        dot_product_attention as jax_dpa,
    )

    q, k, v, _, mask = _inputs(10)
    for causal, window in ((False, None), (True, None), (True, 5)):
        m = None if causal else mask
        got_f = t_attn.dot_product_attention(_t(q), _t(k), _t(v), _t(m), impl="flash",
                                             causal=causal, window=window)
        got_x = t_attn.dot_product_attention(_t(q), _t(k), _t(v), _t(m), impl="xla",
                                             causal=causal, window=window)
        want = np.asarray(jax_dpa(_j(q), _j(k), _j(v), _j(m), impl="xla", causal=causal,
                                  window=window))
        np.testing.assert_allclose(got_f.numpy(), want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got_x.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bad", ["ring", "window_no_causal", "unknown", "window0",
                                 "shape"])
def test_dispatch_and_argument_checks_raise(bad):
    q, k, v, _, mask = (_t(x) for x in _inputs(11))
    if bad == "ring":
        # ring attention (ported; without a mesh the plain attention) takes
        # no window: the JAX ValueError
        with pytest.raises(ValueError, match="sliding window is not supported with impl='ring'"):
            t_attn.dot_product_attention(q, k, v, mask, impl="ring", causal=True, window=4)
    elif bad == "window_no_causal":
        with pytest.raises(ValueError):
            t_attn.dot_product_attention(q, k, v, mask, impl="flash", window=4)
    elif bad == "unknown":
        with pytest.raises(ValueError):
            t_attn.dot_product_attention(q, k, v, mask, impl="pallas")
    elif bad == "window0":
        with pytest.raises(ValueError):
            fa.flash_fwd(q, k, v, None, causal=True, window=0)
    else:
        with pytest.raises(ValueError):
            fa.flash_fwd(q, k[:, :, :, :8], v, mask)


def test_masks_match_jax():
    from huggingface_sagemaker_tensorflow_distributed_tpu.ops import attention as j

    rng = np.random.RandomState(12)
    am = (rng.rand(3, 7) > 0.3).astype(np.int32)
    seg = np.array([[1, 1, 2, 2, 2, 0, 0], [1, 2, 3, 3, 0, 0, 0], [1] * 7], np.int32)
    np.testing.assert_array_equal(t_attn.make_attention_mask(_t(am)).numpy(),
                                  np.asarray(j.make_attention_mask(_j(am))))
    np.testing.assert_array_equal(
        t_attn.make_attention_mask(_t(am), segment_ids=_t(seg)).numpy(),
        np.asarray(j.make_attention_mask(_j(am), segment_ids=_j(seg))))
    np.testing.assert_array_equal(t_attn.make_segment_mask(_t(seg)).numpy(),
                                  np.asarray(j.make_segment_mask(_j(seg))))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


GPU_CASES = [  # S, D, dtype, causal, window, pad_row
    (128, 64, "float32", False, None, False),
    (200, 64, "float32", False, None, True),
    (256, 64, "bfloat16", False, None, False),
    (192, 64, "float32", True, None, False),
    (192, 64, "float32", True, 40, False),
    (128, 128, "float32", False, None, False),
    # the tensor-core (bf16) kernels on every masking path
    (200, 64, "bfloat16", False, None, True),
    (192, 64, "bfloat16", True, None, False),
    (192, 64, "bfloat16", True, 40, False),
    (136, 128, "bfloat16", False, None, False),
    (136, 128, "bfloat16", True, None, False),
    # the tensor-core dQ: a ragged tile with a padded row, D 128 with a window
    (72, 64, "bfloat16", False, None, True),
    (136, 128, "bfloat16", True, 40, False),
    # D 256 (Gemma): the shared-tile fp32 kernels and the bf16 kernels'
    # D 256 work split (dQ's key sub-steps, dK/dV's 8 warps by role)
    (200, 256, "float32", False, None, True),
    (136, 256, "float32", True, 40, False),
    (200, 256, "bfloat16", False, None, True),
    (136, 256, "bfloat16", True, None, False),
    (192, 256, "bfloat16", True, 40, False),
    # a head dim without an instance: padded to the next one
    (136, 96, "bfloat16", True, None, False),
    (128, 96, "float32", False, None, True),
]


def _card_limit(got, want):
    """fp32 outputs (every output of an fp32 case, and the LSE and dmask
    of a bf16 one: fp32 arithmetic on the same inputs) 1e-4 x max(1,
    max|want|); a bf16 output 2^-6 x max|want|, no floor of 1 (one bf16
    ulp is at most 2^-7 of a value and both sides round once)."""
    top = want.abs().max().item()
    if got.dtype == torch.bfloat16:
        return 2.0 ** -6 * top
    return 1e-4 * max(1.0, top)


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernels_match_reference_on_card(cuda_device, case):
    s, d, dtype, causal, window, pad_row = case
    q, k, v, do, mask = _inputs(13, masked=not causal, pad_row=pad_row, b=3, s=s, d=d)
    dt = getattr(torch, dtype)
    # the model's layout: [B, S, H, D] memory viewed as [B, H, S, D]
    q, k, v, do = (torch.from_numpy(x).transpose(1, 2).contiguous().transpose(1, 2)
                   .to(cuda_device, dt) for x in (q, k, v, do))
    m = None if mask is None else torch.from_numpy(mask).to(cuda_device).requires_grad_(True)
    kw = dict(causal=causal, window=window)
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    o, lse = fa.flash_fwd(q, k, v, m, **kw)
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, m, **kw)
    dq = fa.flash_bwd_dq(q, k, v, m, ro, rlse, do, **kw)
    dk, dv, dm = fa.flash_bwd_dkv(q, k, v, m, ro, rlse, do, **kw, want_dmask=m is not None)
    rq = fa.flash_bwd_dq_reference(q, k, v, m, ro, rlse, do, **kw)
    rk, rv, rm = fa.flash_bwd_dkv_reference(q, k, v, m, ro, rlse, do, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(n + 1 for n in before)
    for g, w in ((o, ro), (lse, rlse), (dq, rq), (dk, rk), (dv, rv), (dm, rm)):
        if w is None:
            continue
        limit = _card_limit(g, w.detach().float())
        g, w = g.detach().float().cpu(), w.detach().float().cpu()
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= limit


@pytest.mark.parametrize("D", [256, 96, 288])
def test_head_dim_256_names_its_roadmap_entry(D):
    """Every head_dim up to 256 passes the wrappers' head-dim checks on the
    card's side: meta tensors stand in for the card's, and the call gets as
    far as the device check (96 after its padding to the 128 instance).
    Above 256 the wrappers raise ``ValueError`` naming ROADMAP queue 2's
    entry. The CPU path takes every width."""
    q = torch.empty(1, 2, 16, D, device="meta")
    lse = torch.empty(1, 2, 16, device="meta")
    match = "no kernel for device meta" if D <= 256 else "ROADMAP queue 2"
    for call in (lambda: fa.flash_fwd(q, q, q),
                 lambda: fa.flash_bwd_dq(q, q, q, None, q, lse, q),
                 lambda: fa.flash_bwd_dkv(q, q, q, None, q, lse, q)):
        with pytest.raises(ValueError, match=match):
            call()
    assert fa.kernel_head_dim(min(D, 256)) == (128 if D == 96 else 256)
    x = torch.randn(1, 2, 16, D)
    assert fa.flash_fwd(x, x, x)[0].shape == x.shape
