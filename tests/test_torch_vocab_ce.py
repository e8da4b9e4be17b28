"""PyTorch port: the fused LM head + cross-entropy (``ops/vocab_ce.py``)
against the JAX package's ``fused_vocab_cross_entropy`` with the Pallas
kernels in interpret mode, on the same numpy inputs: loss and prediction
over multi-tile, ragged and below-one-tile vocabularies, dH and dW through
``torch.autograd`` against ``jax.vjp``, first-max ties, label smoothing,
and the (bfloat16 hidden, float32 weight) contract of the GPT-2 path; the
bf16 split that the tensor-core dH kernel makes of W and dS
(``split_bf16``) and its arithmetic, in plain PyTorch, against fp64, the
plain dH and the Pallas kernel. Plus the three CUDA kernels against their
plain versions on the card (skipped without one).

The JAX function takes its Pallas path only when H is a multiple of 128
and N a multiple of an 8-aligned ``block_n`` (else it computes the unfused
loss), so every case here has H 128 and N a multiple of ``block_n``.

Tolerances: fp32 loss 1e-5 and pred exact (the same fp32 arithmetic summed
in another order); fp32 gradients rtol 1e-4 / atol 1e-5; with bf16 hidden
the loss keeps 1e-5 (fp32 products of bf16-exact values) and dH, rounded to
bf16 (8 mantissa bits, 3.9e-3 per rounding), and dW, whose dS is rounded to
bf16, keep 2e-2 of their largest entry."""

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import vocab_ce as vc

H = 128


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


def _inputs(n_tok, vocab, seed=0, h_dim=H):
    rng = np.random.RandomState(seed)
    hidden = rng.randn(n_tok, h_dim).astype(np.float32)
    weight = (rng.randn(vocab, h_dim) * 0.05).astype(np.float32)
    labels = rng.randint(0, vocab, n_tok).astype(np.int32)
    return hidden, weight, labels


def _jax(hidden, weight, labels, block_n, block_v, eps=0.0, g=None, h_dtype="float32"):
    """(loss, pred) and, with a cotangent ``g``, (dH, dW) of the JAX
    function with its Pallas kernels in interpret mode."""
    import jax
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.ops.pallas_vocab_ce import (
        fused_vocab_cross_entropy,
    )

    def f(h, w):
        return fused_vocab_cross_entropy(h, w, jnp.asarray(labels), block_n=block_n,
                                         block_v=block_v, interpret=True,
                                         label_smoothing=eps)

    h = jnp.asarray(hidden).astype(getattr(jnp, h_dtype))
    (loss, pred), vjp = jax.vjp(f, h, jnp.asarray(weight))
    out = [np.asarray(loss), np.asarray(pred)]
    if g is not None:
        dh, dw = vjp((jnp.asarray(g), np.zeros(pred.shape, jax.dtypes.float0)))
        out += [np.asarray(dh.astype(jnp.float32)), np.asarray(dw), dh.dtype, dw.dtype]
    return out


def _port(hidden, weight, labels, eps=0.0, g=None, h_dtype=torch.float32):
    h = torch.from_numpy(hidden).to(h_dtype).requires_grad_(g is not None)
    w = torch.from_numpy(weight).requires_grad_(g is not None)
    loss, pred = vc.fused_vocab_cross_entropy(h, w, torch.from_numpy(labels), eps)
    out = [loss.detach().numpy(), pred.numpy()]
    if g is not None:
        loss.backward(torch.from_numpy(g))
        out += [h.grad.float().numpy(), w.grad.numpy(), h.grad.dtype, w.grad.dtype]
    return out


CASES = [  # n_tok, vocab, block_n, block_v
    (64, 512, 16, 128),     # several tiles on both axes
    (48, 300, 16, 128),     # vocab not a multiple of block_v (masked tail)
    (32, 100, 32, 128),     # vocab below one tile
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c[0]}-v{c[1]}")
def test_loss_and_pred_match_pallas(case):
    n_tok, vocab, block_n, block_v = case
    hidden, weight, labels = _inputs(n_tok, vocab, seed=n_tok)
    want_loss, want_pred = _jax(hidden, weight, labels, block_n, block_v)
    loss, pred = _port(hidden, weight, labels)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pred, want_pred)
    assert loss.dtype == np.float32 and pred.dtype == np.int32


@pytest.mark.parametrize("eps", [0.0, 0.1], ids=["eps0", "eps0.1"])
def test_gradients_match_pallas(eps):
    hidden, weight, labels = _inputs(48, 300, seed=3)
    g = (np.random.RandomState(4).rand(48) * (np.arange(48) % 5 != 0)).astype(np.float32)
    want = _jax(hidden, weight, labels, 16, 128, eps=eps, g=g)
    got = _port(hidden, weight, labels, eps=eps, g=g)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])
    for a, b in zip(got[2:4], want[2:4]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_label_smoothing_loss_is_the_smoothed_ce():
    """With eps > 0 the loss is (1 - eps) CE + eps (lse - mean logit), the
    JAX trainer's smoothed seq2seq loss, on the Pallas side too."""
    hidden, weight, labels = _inputs(32, 260, seed=5)
    loss, _ = _port(hidden, weight, labels, eps=0.2)
    want, _ = _jax(hidden, weight, labels, 16, 128, eps=0.2)
    s = torch.from_numpy(hidden) @ torch.from_numpy(weight).t()
    lse = torch.logsumexp(s, -1)
    ce = lse - s.gather(1, torch.from_numpy(labels).long()[:, None])[:, 0]
    smoothed = 0.8 * ce + 0.2 * (lse - s.mean(-1))
    np.testing.assert_allclose(loss, smoothed.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss, want, rtol=1e-5, atol=1e-5)


def test_argmax_ties_pick_the_first_id():
    """Identical rows of W tie every logit across vocab tiles: the first
    id wins, as ``jnp.argmax`` gives it."""
    rng = np.random.RandomState(6)
    hidden = rng.randn(32, H).astype(np.float32)
    weight = np.repeat((rng.randn(1, H) * 0.05).astype(np.float32), 384, axis=0)
    labels = np.zeros(32, np.int32)
    _, want = _jax(hidden, weight, labels, 16, 128)
    _, got = _port(hidden, weight, labels)
    assert (got == 0).all() and (want == 0).all()


def test_bf16_hidden_fp32_weight_contract():
    """The GPT-2 path's mixed types: loss fp32, dH bf16, dW fp32, on both
    sides."""
    hidden, weight, labels = _inputs(48, 300, seed=7)
    hidden = torch.from_numpy(hidden).bfloat16().float().numpy()   # bf16-exact
    g = np.random.RandomState(8).rand(48).astype(np.float32)
    want = _jax(hidden, weight, labels, 16, 128, g=g, h_dtype="bfloat16")
    got = _port(hidden, weight, labels, g=g, h_dtype=torch.bfloat16)
    assert (str(want[4]), str(want[5])) == ("bfloat16", "float32")
    assert (got[4], got[5]) == (torch.bfloat16, torch.float32)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])
    for a, b in zip(got[2:4], want[2:4]):
        assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max()


def test_plain_backward_is_autograd_of_the_plain_loss():
    """dH and dW of the plain versions equal torch.autograd through the
    unfused logits and ``cross_entropy``."""
    hidden, weight, labels = _inputs(20, 70, seed=9, h_dim=24)
    h = torch.from_numpy(hidden).requires_grad_(True)
    w = torch.from_numpy(weight).requires_grad_(True)
    g = torch.rand(20, generator=torch.Generator().manual_seed(0))
    ce = torch.nn.functional.cross_entropy(h @ w.t(), torch.from_numpy(labels).long(),
                                           reduction="none")
    want_dh, want_dw = torch.autograd.grad(ce, (h, w), g)
    _, lse, _ = vc.fused_ce_fwd_reference(h.detach(), w.detach(), torch.from_numpy(labels))
    args = (h.detach(), w.detach(), torch.from_numpy(labels), lse, g)
    torch.testing.assert_close(vc.fused_ce_bwd_dh_reference(*args), want_dh,
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(vc.fused_ce_bwd_dw_reference(*args), want_dw,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad", ["bf16_weight", "fp16_hidden", "shape", "labels",
                                 "smoothing"])
def test_rejects_what_the_kernels_do_not_take(bad):
    h, w, lab = (torch.from_numpy(x) for x in _inputs(8, 16, h_dim=8))
    kw = {}
    if bad == "bf16_weight":
        w = w.bfloat16()
    elif bad == "fp16_hidden":
        h = h.half()
    elif bad == "shape":
        w = w[:, :4]
    elif bad == "labels":
        lab = lab.float()
    else:
        kw["label_smoothing"] = 1.0
    with pytest.raises(ValueError):
        vc.fused_vocab_cross_entropy(h, w, lab, **kw)


def test_no_grad_runs_only_the_forward_and_splits_cover_the_vocab():
    h, w, lab = (torch.from_numpy(x) for x in _inputs(8, 16, h_dim=8))
    loss, pred = vc.fused_vocab_cross_entropy(h, w, lab)
    assert not loss.requires_grad and pred.dtype == torch.int32
    for n_tok, vocab in ((4096, 50257), (2048, 50257), (1, 1), (100, 65), (70000, 64)):
        vtiles = -(-vocab // 64)
        for splits in (vc.fwd_splits(n_tok, vocab), vc.dh_splits(n_tok, vocab)):
            per = -(-vtiles // splits)
            assert 1 <= splits <= vtiles and (splits - 1) * per < vtiles


SPLIT_KINDS = {
    "random": lambda r: r.randn(64, 96) * 0.02,
    "negative": lambda r: -np.abs(r.randn(64, 96)) * 0.02,
    "zero": lambda r: np.zeros((64, 96)),
    "tiny": lambda r: np.sign(r.randn(64, 96)) * r.uniform(1, 2, (64, 96)) * 1e-30,
    "large": lambda r: r.randn(64, 96) * 1e30,
    "mixed": lambda r: r.randn(64, 96) * 10.0 ** r.randint(-20, 20, (64, 96)),
}


@pytest.mark.parametrize("kind", list(SPLIT_KINDS))
def test_split_bf16_pieces_sum_to_the_fp32_value_exactly(kind):
    """``split_bf16``, the split the bf16-hidden dH kernel makes of W:
    three bf16 pieces (the first rounded to nearest, the rest truncations
    of what is left) whose sum in fp64 is the fp32 value, bit for bit."""
    x = torch.from_numpy(SPLIT_KINDS[kind](np.random.RandomState(0)).astype(np.float32))
    pieces = vc.split_bf16(x)
    assert len(pieces) == 3 and all(q.dtype == torch.bfloat16 for q in pieces)
    assert torch.equal(pieces[0], x.to(torch.bfloat16))
    assert torch.equal(sum(q.double() for q in pieces), x.double())
    hi, lo = vc.split_bf16(x, 2)
    assert torch.equal(hi, pieces[0]) and torch.equal(lo, pieces[1])


def _split_route_dh(hidden, weight, labels, lse, g, eps=0.0):
    """The bf16-hidden dH kernel's arithmetic in plain PyTorch: logits as
    three fp32 products of bf16 h with the pieces of W, dS in fp32, then
    dS_hi·W_hi + dS_hi·W_mid + dS_lo·W_hi, dH rounded to h's dtype."""
    w_hi, w_mid, w_lo = (q.float() for q in vc.split_bf16(weight))
    h = hidden.float()
    s = h @ w_hi.t() + h @ w_mid.t() + h @ w_lo.t()
    target = torch.zeros_like(s).scatter_(1, labels.long()[:, None], 1.0)
    if eps > 0:
        target = (1.0 - eps) * target + eps / weight.shape[0]
    ds = (torch.exp(s - lse[:, None]) - target) * g[:, None]
    d_hi, d_lo = (q.float() for q in vc.split_bf16(ds, 2))
    return (d_hi @ w_hi + d_hi @ w_mid + d_lo @ w_hi).to(hidden.dtype)


@pytest.mark.parametrize("h_dim", [128, 768])
def test_split_route_logits_are_fp32_exact(h_dim):
    """bf16 h times the three pieces of W, summed in fp32, is the fp64
    logit to 2^-22 of the sum of the absolute products (the scale of an
    fp32 dot product's rounding): the split loses nothing of W."""
    hidden, weight, _ = _inputs(64, 300, seed=h_dim, h_dim=h_dim)
    h = torch.from_numpy(hidden).to(torch.bfloat16)
    pieces = vc.split_bf16(torch.from_numpy(weight))
    s = sum(h.float() @ q.float().t() for q in pieces)
    want = h.double() @ torch.from_numpy(weight).double().t()
    scale = h.double().abs() @ torch.from_numpy(weight).double().abs().t()
    assert ((s.double() - want).abs() <= 2.0 ** -22 * scale).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_split_route_ds_times_w_within_2_pow_14(seed):
    """The three-term dS·W (dS in two pieces, W in hi and mid) against
    fp64: the dropped terms are about 2^-16 of the product."""
    rng = np.random.RandomState(seed)
    w = torch.from_numpy((rng.randn(300, H) * 0.05).astype(np.float32))
    ds = torch.from_numpy((rng.randn(48, 300) * 0.01).astype(np.float32))
    w_hi, w_mid, _ = (q.float() for q in vc.split_bf16(w))
    d_hi, d_lo = (q.float() for q in vc.split_bf16(ds, 2))
    got = d_hi @ w_hi + d_hi @ w_mid + d_lo @ w_hi
    want = ds.double() @ w.double()
    assert (got.double() - want).abs().max() <= 2.0 ** -14 * want.abs().max()


SPLIT_DH_CASES = [  # n_tok, vocab, h_dim, eps
    (48, 300, 128, 0.0),
    (48, 300, 128, 0.1),
    (20, 70, 24, 0.0),
]


@pytest.mark.parametrize("case", SPLIT_DH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_split_route_dh_matches_the_plain_version(case):
    """The kernel's split route gives the plain dH
    (``fused_ce_bwd_dh_reference``) with bf16 hidden within the bf16
    limit, 2^-6 of the largest entry."""
    n_tok, vocab, h_dim, eps = case
    hidden, weight, labels = (torch.from_numpy(x) for x in _inputs(n_tok, vocab, seed=13,
                                                                   h_dim=h_dim))
    h = hidden.to(torch.bfloat16)
    g = torch.from_numpy(np.random.RandomState(14).rand(n_tok).astype(np.float32))
    _, lse, _ = vc.fused_ce_fwd_reference(h, weight, labels, eps)
    got = _split_route_dh(h, weight, labels, lse, g, eps)
    want = vc.fused_ce_bwd_dh_reference(h, weight, labels, lse, g, eps)
    assert got.dtype == want.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max() <= 2.0 ** -6 * want.float().abs().max()


@pytest.mark.parametrize("eps", [0.0, 0.1], ids=["eps0", "eps0.1"])
def test_split_route_dh_matches_pallas(eps):
    """The split route's dH with bf16 hidden against ``jax.vjp`` through
    the Pallas ``_dh_kernel`` in interpret mode, at H 128, within the bf16
    limit."""
    hidden, weight, labels = _inputs(48, 300, seed=15)
    hidden = torch.from_numpy(hidden).bfloat16().float().numpy()   # bf16-exact
    g = np.random.RandomState(16).rand(48).astype(np.float32)
    want_dh = _jax(hidden, weight, labels, 16, 128, eps=eps, g=g, h_dtype="bfloat16")[2]
    h = torch.from_numpy(hidden).to(torch.bfloat16)
    w, lab = torch.from_numpy(weight), torch.from_numpy(labels)
    _, lse, _ = vc.fused_ce_fwd_reference(h, w, lab, eps)
    got = _split_route_dh(h, w, lab, lse, torch.from_numpy(g), eps).float().numpy()
    assert np.abs(got - want_dh).max() <= 2.0 ** -6 * np.abs(want_dh).max()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


GPU_CASES = [  # n_tok, vocab, h_dim, dtype, eps, ties
    (300, 1001, 768, "float32", 0.0, False),
    (256, 2000, 768, "bfloat16", 0.0, False),
    (130, 777, 200, "float32", 0.1, False),
    (64, 500, 800, "float32", 0.0, False),
    (128, 640, 128, "float32", 0.0, True),
    # the tensor-core dH (bf16 hidden): H not a multiple of 64 or 4, two
    # panels, smoothing, ties
    (256, 2000, 200, "bfloat16", 0.0, False),
    (64, 500, 800, "bfloat16", 0.1, False),
    (100, 3000, 30, "bfloat16", 0.0, False),
    (128, 640, 128, "bfloat16", 0.0, True),
    # bf16 hidden past the tensor-core kernel's H (1216): the CUDA-core dH
    (64, 500, 1280, "bfloat16", 0.0, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernels_match_reference_on_card(cuda_device, case):
    n_tok, vocab, h_dim, dtype, eps, ties = case
    hidden, weight, labels = _inputs(n_tok, vocab, seed=11, h_dim=h_dim)
    if ties:
        weight = np.repeat(weight[:1], vocab, axis=0)
    h = torch.from_numpy(hidden).to(cuda_device, getattr(torch, dtype))
    w = torch.from_numpy(weight).to(cuda_device)
    lab = torch.from_numpy(labels).to(cuda_device)
    g = torch.rand(n_tok, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    before = (vc.fused_ce_fwd.launches, vc.fused_ce_bwd_dh.launches,
              vc.fused_ce_bwd_dw.launches)
    loss, lse, pred = vc.fused_ce_fwd(h, w, lab, eps)
    rloss, rlse, rpred = vc.fused_ce_fwd_reference(h, w, lab, eps)
    dh = vc.fused_ce_bwd_dh(h, w, lab, rlse, g, eps)
    dw = vc.fused_ce_bwd_dw(h, w, lab, rlse, g, eps)
    rdh = vc.fused_ce_bwd_dh_reference(h, w, lab, rlse, g, eps)
    rdw = vc.fused_ce_bwd_dw_reference(h, w, lab, rlse, g, eps)
    torch.cuda.synchronize()
    assert (vc.fused_ce_fwd.launches, vc.fused_ce_bwd_dh.launches,
            vc.fused_ce_bwd_dw.launches) == tuple(n + 1 for n in before)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for got, want, t in ((loss, rloss, 1e-4), (lse, rlse, 1e-4), (dh, rdh, tol), (dw, rdw, tol)):
        got, want = got.float().cpu(), want.float().cpu()
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= t * max(1.0, want.abs().max().item())
    if ties:
        assert (pred == 0).all()
    else:
        s = vc._logits(h, w)
        top2 = s.topk(2, dim=-1).values
        near = (top2[:, 0] - top2[:, 1]) < 1e-5 * s.abs().max()
        assert ((pred == rpred) | near).all()
