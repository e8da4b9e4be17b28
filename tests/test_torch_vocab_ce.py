"""PyTorch port: the fused LM head + cross-entropy (``ops/vocab_ce.py``)
against the JAX package's ``fused_vocab_cross_entropy`` with the Pallas
kernels in interpret mode, on the same numpy inputs: loss and prediction
over multi-tile, ragged and below-one-tile vocabularies, dH and dW through
``torch.autograd`` against ``jax.vjp``, first-max ties, label smoothing,
and the (bfloat16 hidden, float32 weight) contract of the GPT-2 path; the
bf16 split that the ``wgmma`` routes make of W and dS (``split_bf16``) and
their arithmetic (the forward's per-tile statistics merged in vocab
order, the backward's chunked dH and dW), in plain PyTorch, against fp64,
the plain versions and the Pallas kernels; the wrappers' chunk walks over
stand-ins of the library's launches; the kernels' shared-memory sizes.
Plus the CUDA kernels against their plain versions on the card (skipped
without one).

The JAX function takes its Pallas path only when H is a multiple of 128
and N a multiple of an 8-aligned ``block_n`` (else it computes the unfused
loss), so every case here has H 128 and N a multiple of ``block_n``.

Tolerances: fp32 loss 1e-5 and pred exact (the same fp32 arithmetic summed
in another order); fp32 gradients rtol 1e-4 / atol 1e-5; with bf16 hidden
the loss keeps 1e-5 (fp32 products of bf16-exact values) and dH, rounded to
bf16 (8 mantissa bits, 3.9e-3 per rounding), and dW, whose dS is rounded to
bf16, keep 2e-2 of their largest entry."""

import ctypes

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


def _split_logits(hidden, weight):
    """The tensor-core kernels' logits: bf16 h times each of W's three
    bf16 pieces, every product fp32, the three summed in fp32."""
    h = hidden.float()
    w_hi, w_mid, w_lo = (q.float() for q in vc.split_bf16(weight))
    return h @ w_hi.t() + h @ w_mid.t() + h @ w_lo.t()


def _split_ds(hidden, weight, labels, lse, g, eps):
    """dS = g (softmax - target) in fp32 from the split-route logits."""
    s = _split_logits(hidden, weight)
    target = torch.zeros_like(s).scatter_(1, labels.long()[:, None], 1.0)
    if eps > 0:
        target = (1.0 - eps) * target + eps / weight.shape[0]
    return (torch.exp(s - lse[:, None]) - target) * g[:, None]


def _split_route_fwd(hidden, weight, labels, eps=0.0):
    """The bf16-hidden forward's logits in plain PyTorch: split-route
    logits, then the loss, the LSE and the first maximal id over all of
    them at once (``_fwd_tiled_route`` adds the kernel's order)."""
    s = _split_logits(hidden, weight)
    lse = torch.logsumexp(s, dim=-1)
    target = s.gather(1, labels.long()[:, None])[:, 0]
    if eps > 0:
        target = (1.0 - eps) * target + eps * s.sum(-1) / weight.shape[0]
    return lse - target, lse, s.argmax(-1).to(torch.int32)


def _split_route_dh(hidden, weight, labels, lse, g, eps=0.0):
    """The bf16-hidden dH kernel's arithmetic in plain PyTorch: logits as
    three fp32 products of bf16 h with the pieces of W, dS in fp32, then
    dS_hi·W_hi + dS_hi·W_mid + dS_lo·W_hi, dH rounded to h's dtype."""
    w_hi, w_mid, _ = (q.float() for q in vc.split_bf16(weight))
    ds = _split_ds(hidden, weight, labels, lse, g, eps)
    d_hi, d_lo = (q.float() for q in vc.split_bf16(ds, 2))
    return (d_hi @ w_hi + d_hi @ w_mid + d_lo @ w_hi).to(hidden.dtype)


def _split_route_dw(hidden, weight, labels, lse, g, eps=0.0):
    """The bf16-hidden dW kernel's arithmetic in plain PyTorch:
    split-route logits, dS in fp32 rounded to h's dtype (the contract's
    ``ds.astype(h.dtype)``), then dSᵀ·h with fp32 sums."""
    ds = _split_ds(hidden, weight, labels, lse, g, eps).to(hidden.dtype)
    return ds.float().t() @ hidden.float()


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


SPLIT_CASES = [  # n_tok, vocab, h_dim, eps, all-equal W
    (48, 300, 128, 0.0, False),
    (48, 300, 128, 0.1, False),
    (20, 70, 24, 0.0, False),      # ragged: N, V and H off every tile
    (33, 129, 40, 0.1, False),
    (40, 96, 32, 0.0, True),       # every logit of a token bit-equal
    (40, 96, 32, 0.1, True),
]


def _split_case(case, seed):
    n_tok, vocab, h_dim, eps, ties = case
    hidden, weight, labels = _inputs(n_tok, vocab, seed=seed, h_dim=h_dim)
    if ties:
        weight = np.repeat(weight[:1], vocab, axis=0)
    g = torch.from_numpy(np.random.RandomState(seed + 1).rand(n_tok).astype(np.float32))
    return (torch.from_numpy(hidden).to(torch.bfloat16), torch.from_numpy(weight),
            torch.from_numpy(labels), g, eps, ties)


def _near_tie(hidden, weight):
    """Tokens whose top two fp32 logits are closer than 1e-5 of the
    largest logit: there another order of the fp32 sums may pick either."""
    s = vc._logits(hidden, weight)
    top2 = s.topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]) < 1e-5 * s.abs().max()


def _dw_bound(hidden, ds):
    """The most dSᵀ·h may move when dS is rounded to bf16 from logits that
    differ in their last fp32 bits: every rounding one bf16 ulp (2^-8 of
    |dS|) the other way, so 2^-8 |dS|ᵀ·|h| per entry, plus fp32 sums in
    another order (1e-5 of the largest entry)."""
    exact = ds.t() @ hidden.float()
    return 2.0 ** -8 * (ds.abs().t() @ hidden.float().abs()) + 1e-5 * exact.abs().max()


@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_split_route_fwd_matches_the_plain_version(case):
    """The bf16 forward's split-route logits give the plain forward
    (``fused_ce_fwd_reference``) with bf16 hidden: loss and LSE within
    1e-5 (fp32-exact logits summed in another order), pred equal but at
    near-ties, and id 0 where every logit ties."""
    h, w, lab, _, eps, ties = _split_case(case, seed=17)
    loss, lse, pred = _split_route_fwd(h, w, lab, eps)
    rloss, rlse, rpred = vc.fused_ce_fwd_reference(h, w, lab, eps)
    torch.testing.assert_close(loss, rloss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    assert ((pred == rpred) | _near_tie(h, w)).all()
    if ties:
        assert (pred == 0).all() and (rpred == 0).all()


@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_split_route_dw_matches_the_plain_version(case):
    """The tensor-core dW's split route gives the plain dW
    (``fused_ce_bwd_dw_reference``) with bf16 hidden within ``_dw_bound``:
    both round dS to bf16 before dSᵀ·h."""
    h, w, lab, g, eps, _ = _split_case(case, seed=19)
    _, lse, _ = vc.fused_ce_fwd_reference(h, w, lab, eps)
    got = _split_route_dw(h, w, lab, lse, g, eps)
    want = vc.fused_ce_bwd_dw_reference(h, w, lab, lse, g, eps)
    assert got.dtype == want.dtype == torch.float32
    ds = vc._dlogits(h, w, lab, lse, g, eps)
    assert ((got - want).abs() <= _dw_bound(h, ds)).all()


@pytest.mark.parametrize("eps", [0.0, 0.1], ids=["eps0", "eps0.1"])
def test_split_route_fwd_matches_pallas(eps):
    """The split route's loss and pred with bf16 hidden against the
    Pallas ``_fwd_kernel`` in interpret mode, at H 128: loss within 1e-5
    (both fp32 logits of bf16-exact h), pred equal but at near-ties."""
    hidden, weight, labels = _inputs(48, 300, seed=21)
    hidden = torch.from_numpy(hidden).bfloat16().float().numpy()   # bf16-exact
    want_loss, want_pred = _jax(hidden, weight, labels, 16, 128, eps=eps, h_dtype="bfloat16")
    h = torch.from_numpy(hidden).to(torch.bfloat16)
    w, lab = torch.from_numpy(weight), torch.from_numpy(labels)
    loss, _, pred = _split_route_fwd(h, w, lab, eps)
    np.testing.assert_allclose(loss.numpy(), want_loss, rtol=1e-5, atol=1e-5)
    assert ((pred.numpy() == want_pred) | _near_tie(h, w).numpy()).all()


@pytest.mark.parametrize("eps", [0.0, 0.1], ids=["eps0", "eps0.1"])
def test_split_route_dw_matches_pallas(eps):
    """The split route's dW with bf16 hidden against ``jax.vjp`` through
    the Pallas ``_dw_kernel`` in interpret mode, at H 128, within
    ``_dw_bound`` (the Pallas kernel rounds dS to bf16 too)."""
    hidden, weight, labels = _inputs(48, 300, seed=23)
    hidden = torch.from_numpy(hidden).bfloat16().float().numpy()   # bf16-exact
    g = np.random.RandomState(24).rand(48).astype(np.float32)
    want_dw = _jax(hidden, weight, labels, 16, 128, eps=eps, g=g, h_dtype="bfloat16")[3]
    h = torch.from_numpy(hidden).to(torch.bfloat16)
    w, lab, gt = torch.from_numpy(weight), torch.from_numpy(labels), torch.from_numpy(g)
    _, lse, _ = vc.fused_ce_fwd_reference(h, w, lab, eps)
    got = _split_route_dw(h, w, lab, lse, gt, eps)
    ds = vc._dlogits(h, w, lab, lse, gt, eps)
    assert ((got - torch.from_numpy(np.array(want_dw))).abs() <= _dw_bound(h, ds)).all()


@pytest.mark.parametrize("kernel", ["fwd"])
def test_tc_smem_bytes_set_each_kernels_h_cap(kernel):
    """The bf16 forward's shared memory per block (the mirror of the
    library's query) is the ``wgmma`` core's ring, its alignment and its
    barriers at every H: no width is past a cap, every H takes the
    ``wgmma`` forward, within a block's 232,448 bytes."""
    sizes = {vc.tc_smem_bytes(kernel, h) for h in list(range(8, 2049, 8)) + [4096, 16384]}
    assert sizes == {196608 + 1024 + 256} and max(sizes) <= 232448
    with pytest.raises(ValueError):
        vc.tc_smem_bytes("combine", 768)


def test_bwd_smem_bytes_take_every_h():
    """The backward's ``wgmma`` kernels hold their stage ring (192 KB), its
    1024-byte alignment and its barriers whatever H: every width fits a
    block, so H picks no route."""
    for kernel in ("dh", "dw"):
        sizes = {vc.tc_smem_bytes(kernel, h) for h in (8, 30, 776, 1032, 1280, 4096, 16384)}
        assert sizes == {196608 + 1024 + 256} and max(sizes) <= 232448


# -- the chunked bf16 backward (csrc/vocab_ce_bwd.cuh) -------------------------

def _chunked_route(hidden, weight, labels, lse, g, eps, v_chunk):
    """The bf16 backward's arithmetic in plain PyTorch, chunk by chunk of
    ``v_chunk`` ids: the chunk's W split once into hi, mid and lo; one dS
    from the three-pass logits, split into dS_hi (rounded) and dS_lo
    (truncated), shared by both products; dH accumulated in fp32 in chunk
    order from dS_hi·W_hi + dS_hi·W_mid + dS_lo·W_hi and cast at the end;
    dW's rows of the chunk dS_hiᵀ·h, written once."""
    (n_tok, _), vocab = hidden.shape, weight.shape[0]
    h = hidden.float()
    dh = torch.zeros(h.shape)
    dw = torch.empty(weight.shape)
    for v0 in range(0, vocab, v_chunk):
        w_hi, w_mid, w_lo = (q.float() for q in vc.split_bf16(weight[v0:v0 + v_chunk]))
        s = h @ w_hi.t() + h @ w_mid.t() + h @ w_lo.t()
        ids = torch.arange(v0, v0 + w_hi.shape[0])
        target = (ids[None, :] == labels.long()[:, None]).float()
        if eps > 0:
            target = (1.0 - eps) * target + eps / vocab
        ds = (torch.exp(s - lse[:, None]) - target) * g[:, None]
        d_hi, d_lo = (q.float() for q in vc.split_bf16(ds, 2))
        dh = dh + (d_hi @ w_hi + d_hi @ w_mid + d_lo @ w_hi)
        dw[v0:v0 + w_hi.shape[0]] = d_hi.t() @ h
    return dh.to(hidden.dtype), dw


def _chunk_case(n_tok, vocab, h_dim, eps, ties, seed, edges=0):
    """bf16 hidden, fp32 W, labels (the first ``edges`` tokens on the ids
    either side of each 128-id chunk edge), g, and the plain LSE."""
    h, w, lab, g, eps, _ = _split_case((n_tok, vocab, h_dim, eps, ties), seed)
    at_edges = [v for e in range(128, vocab, 128) for v in (e - 1, e)] + [vocab - 1, 0]
    for i, v in enumerate(at_edges[:edges]):
        lab[i] = v
    _, lse, _ = vc.fused_ce_fwd_reference(h, w, lab, eps)
    return h, w, lab, lse, g, eps


def _assert_bf16_backward(h, w, lab, lse, g, eps, dh, dw):
    """dH within the bf16 limit (2^-6 of the largest entry) plus 2^-14 of
    the largest |dS|·|W| (where every logit ties, dH is a cancellation of
    terms that size, and the split's dropped terms, 2^-16 of each, remain)
    and dW within ``_dw_bound`` of the plain versions."""
    want_dh = vc.fused_ce_bwd_dh_reference(h, w, lab, lse, g, eps)
    want_dw = vc.fused_ce_bwd_dw_reference(h, w, lab, lse, g, eps)
    ds = vc._dlogits(h, w, lab, lse, g, eps)
    assert dh.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert dh.shape == h.shape and dw.shape == w.shape
    scale = (ds.abs() @ w.abs()).max()
    assert ((dh.float() - want_dh.float()).abs().max()
            <= 2.0 ** -6 * want_dh.float().abs().max() + 2.0 ** -14 * scale)
    assert ((dw - want_dw).abs() <= _dw_bound(h, ds)).all()


CHUNK_CASES = [  # n_tok, vocab, h_dim, eps, all-equal W, chunk
    (24, 300, 1280, 0.0, False, 128),    # past the old dH cap (1216), three chunks
    (16, 260, 2048, 0.1, False, 128),    # Vc does not divide V, smoothing
    (8, 200, 4096, 0.0, False, 128),     # Mixtral's width
    (40, 300, 776, 0.1, False, 128),     # BERT-base's fold
    (33, 333, 1032, 0.0, False, 256),    # BERT-large's fold, ragged N
    (20, 70, 30, 0.0, False, 128),       # H off every tile, one short chunk
    (40, 384, 32, 0.0, True, 128),       # every logit of a token bit-equal
    (40, 384, 32, 0.1, True, 128),
]


@pytest.mark.parametrize("case", CHUNK_CASES, ids=lambda c: "-".join(map(str, c)))
def test_chunked_route_matches_the_plain_versions(case):
    """The chunked route's arithmetic gives the plain dH and dW past the
    old tensor-core caps, at ragged N, V and H, with a chunk that does not
    divide V, labels on either side of every chunk edge, smoothing and
    ties."""
    n_tok, vocab, h_dim, eps, ties, v_chunk = case
    h, w, lab, lse, g, eps = _chunk_case(n_tok, vocab, h_dim, eps, ties, seed=29, edges=n_tok)
    dh, dw = _chunked_route(h, w, lab, lse, g, eps, v_chunk)
    _assert_bf16_backward(h, w, lab, lse, g, eps, dh, dw)


@pytest.mark.parametrize("eps", [0.0, 0.1], ids=["eps0", "eps0.1"])
def test_chunked_route_matches_pallas(eps):
    """The chunked route at H 128 over three chunks (128, 128 and 44 ids)
    against ``jax.vjp`` through the Pallas ``_dh_kernel`` and ``_dw_kernel``
    in interpret mode: dH within the bf16 limit, dW within ``_dw_bound``."""
    hidden, weight, labels = _inputs(48, 300, seed=31)
    hidden = torch.from_numpy(hidden).bfloat16().float().numpy()   # bf16-exact
    labels[:6] = [127, 128, 255, 256, 299, 0]
    g = np.random.RandomState(32).rand(48).astype(np.float32)
    want = _jax(hidden, weight, labels, 16, 128, eps=eps, g=g, h_dtype="bfloat16")
    h = torch.from_numpy(hidden).to(torch.bfloat16)
    w, lab, gt = torch.from_numpy(weight), torch.from_numpy(labels), torch.from_numpy(g)
    _, lse, _ = vc.fused_ce_fwd_reference(h, w, lab, eps)
    dh, dw = _chunked_route(h, w, lab, lse, gt, eps, 128)
    want_dh, want_dw = (torch.from_numpy(np.array(x)) for x in want[2:4])
    assert (dh.float() - want_dh).abs().max() <= 2.0 ** -6 * want_dh.abs().max()
    assert ((dw - want_dw).abs() <= _dw_bound(h, vc._dlogits(h, w, lab, lse, gt, eps))).all()


@pytest.mark.parametrize("need", [(True, True), (True, False), (False, True), (False, False)],
                         ids=["dh-dw", "dh", "dw", "none"])
def test_fused_ce_bwd_on_cpu_is_the_plain_versions(need):
    """``fused_ce_bwd`` on CPU tensors returns the plain dH and dW, each
    only when asked (None otherwise), and launches nothing."""
    h, w, lab, lse, g, eps = _chunk_case(24, 300, 40, 0.1, False, seed=33)
    before = (vc.fused_ce_bwd_dh.launches, vc.fused_ce_bwd_dw.launches)
    dh, dw = vc.fused_ce_bwd(h, w, lab, lse, g, eps, need_dh=need[0], need_dw=need[1])
    assert (vc.fused_ce_bwd_dh.launches, vc.fused_ce_bwd_dw.launches) == before
    for got, want, asked in ((dh, vc.fused_ce_bwd_dh_reference, need[0]),
                             (dw, vc.fused_ce_bwd_dw_reference, need[1])):
        if asked:
            assert torch.equal(got, want(h, w, lab, lse, g, eps))
        else:
            assert got is None
    assert torch.equal(vc.fused_ce_bwd_dh(h, w, lab, lse, g, eps),
                       vc.fused_ce_bwd_dh_reference(h, w, lab, lse, g, eps))
    assert torch.equal(vc.fused_ce_bwd_dw(h, w, lab, lse, g, eps),
                       vc.fused_ce_bwd_dw_reference(h, w, lab, lse, g, eps))


@pytest.mark.parametrize("frozen_w", [False, True], ids=["both", "frozen_w"])
def test_fused_vocab_ce_gradients_unchanged(frozen_w):
    """``FusedVocabCE``'s gradients through the one ``fused_ce_bwd`` call
    are the plain versions' (with a frozen W, as LoRA's tied embedding,
    none for W), in both dtypes of the contract."""
    for dtype in (torch.float32, torch.bfloat16):
        hidden, weight, labels = (torch.from_numpy(x) for x in _inputs(24, 300, seed=35,
                                                                       h_dim=40))
        h = hidden.to(dtype).requires_grad_(True)
        w = weight.clone().requires_grad_(not frozen_w)
        g = torch.from_numpy(np.random.RandomState(36).rand(24).astype(np.float32))
        loss, _ = vc.fused_vocab_cross_entropy(h, w, labels, 0.1)
        loss.backward(g)
        _, lse, _ = vc.fused_ce_fwd_reference(h.detach(), weight, labels, 0.1)
        args = (h.detach(), weight, labels, lse, g, 0.1)
        assert torch.equal(h.grad, vc.fused_ce_bwd_dh_reference(*args))
        if frozen_w:
            assert w.grad is None
        else:
            assert torch.equal(w.grad, vc.fused_ce_bwd_dw_reference(*args))


# every bf16 K2 shape of chip_smoke.py's VOCAB_CASES, the Llama-3 vocab
# case beside it, and Llama-3's N 4096 at H 4096
PLAN_SHAPES = [(4096, 50257, 768), (2048, 50257, 768), (1024, 30522, 776), (1024, 30522, 1032),
               (512, 30522, 776), (1024, 128100, 776), (512, 128100, 776), (512, 32128, 512),
               (256, 32128, 512), (848, 32128, 512), (424, 32128, 512), (512, 50265, 768),
               (256, 50265, 768), (4096, 32000, 2048), (1024, 32000, 4096),
               (1024, 128256, 4096), (4096, 128256, 4096)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "N{}-V{}-H{}".format(*s))
def test_bwd_plan_keeps_the_scratch_under_its_budget(shape):
    """``bwd_plan``: the scratch of the joint backward (and, less, of dH or
    dW alone, on the same chunks and split-K) stays within
    ``SCRATCH_BYTES`` at every listed shape; Vc is a multiple of 128
    whose chunks cover V with the last one short by less than a chunk; the
    dH split-K keeps at least 4 stages of the vocab a range and fills 85%
    of the card's slots or stops at 16."""
    n_tok, vocab, h_dim = shape
    v_chunk, splits, joint = vc.bwd_plan(n_tok, vocab, h_dim)
    assert joint <= vc.SCRATCH_BYTES
    assert v_chunk % 128 == 0 and 0 <= -(-vocab // v_chunk) * v_chunk - vocab < v_chunk
    for need in ((True, False), (False, True)):
        alone = vc.bwd_plan(n_tok, vocab, h_dim, *need)
        assert alone[:2] == (v_chunk, splits) and alone[2] < joint
    tiles = -(-n_tok // 128) * -(-h_dim // 128) * splits
    assert 1 <= splits <= 16 and -(-vocab // 64) // splits >= 4
    assert splits == 16 or tiles / (-(-tiles // 132) * 132) >= 0.85 or splits == 1


class _CpuLib:
    """The bf16 forward's and backward's launches (``csrc/vocab_ce.cu``) as
    plain PyTorch on the CPU memory the wrapper's pointers name, with the
    launches' own checks: bf16 operands at 16-byte aligned bases with row
    strides a multiple of 8 elements (TMA's rule), the forward's chunks
    starting on a 128-id tile, dH's split-K ranges of whole 64-id stages.
    Each call is logged by name."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _at(ptr, shape, dtype, ld=None):
        ld = shape[1] if ld is None else ld
        size = torch.tensor([], dtype=dtype).element_size()
        buf = (ctypes.c_char * ((shape[0] - 1) * ld + shape[1]) * size).from_address(ptr)
        flat = torch.frombuffer(buf, dtype=dtype)
        return flat.as_strided(shape, (ld, 1))

    def _operand(self, ptr, rows, cols, ld):
        assert ptr % 16 == 0 and ld % 8 == 0 and cols <= ld, (ptr, ld, cols)
        return self._at(ptr, (rows, cols), torch.bfloat16, ld)

    def vocab_ce_transpose_h_launch(self, h, n_tok, h_dim, h_t, ld_t, stream):
        self.calls.append("transpose_h")
        self._at(h_t, (h_dim, n_tok), torch.bfloat16, ld_t).copy_(
            self._operand(h, n_tok, h_dim, h_dim).t())
        return 0

    def vocab_ce_split_w_launch(self, w, h_dim, v0, rows, hi, mid, lo, hi_t, mid_t, ld_t, stream):
        self.calls.append("split_w")
        pieces = vc.split_bf16(self._at(w + v0 * h_dim * 4, (rows, h_dim), torch.float32))
        for ptr, q in zip((hi, mid, lo), pieces):
            self._operand(ptr, rows, h_dim, h_dim).copy_(q)
        if hi_t is not None:
            for ptr, q in zip((hi_t, mid_t), pieces):
                self._operand(ptr, h_dim, rows, ld_t).copy_(q.t())
        return 0

    def vocab_ce_ds_launch(self, h, hi, mid, lo, lse, g, labels, ds_hi, ds_lo, ds_hi_t, n_tok,
                           h_dim, vocab, v0, rows, ld, ld_t, eps, one_minus_eps, eps_over_v,
                           stream):
        self.calls.append("ds")
        x = self._operand(h, n_tok, h_dim, h_dim).float()
        s = sum(x @ self._operand(p, rows, h_dim, h_dim).float().t() for p in (hi, mid, lo))
        lab = self._at(labels, (1, n_tok), torch.int32)[0].long()
        ids = torch.arange(v0, v0 + rows)
        onehot = (ids[None, :] == lab[:, None]).float()
        target = one_minus_eps * onehot + eps_over_v if eps > 0 else onehot
        lse_ = self._at(lse, (1, n_tok), torch.float32)[0]
        g_ = self._at(g, (1, n_tok), torch.float32)[0]
        d_hi, d_lo = vc.split_bf16((torch.exp(s - lse_[:, None]) - target) * g_[:, None], 2)
        if ds_hi is not None:
            self._operand(ds_hi, n_tok, rows, ld).copy_(d_hi)
            self._operand(ds_lo, n_tok, rows, ld).copy_(d_lo)
        if ds_hi_t is not None:
            self._operand(ds_hi_t, rows, n_tok, ld_t).copy_(d_hi.t())
        return 0

    def vocab_ce_dh_product_launch(self, ds_hi, ds_lo, hi_t, mid_t, part, n_tok, h_dim, rows, ld,
                                   ld_t, splits, first, stream):
        self.calls.append("dh")
        a = [self._operand(p, n_tok, rows, ld).float() for p in (ds_hi, ds_lo)]
        b = [self._operand(p, h_dim, rows, ld_t).float() for p in (hi_t, mid_t)]
        per = -(-(-(-rows // 64)) // splits) * 64
        for s in range(splits):
            k = slice(min(rows, s * per), min(rows, (s + 1) * per))
            got = (a[0][:, k] @ b[0][:, k].t() + a[0][:, k] @ b[1][:, k].t()
                   + a[1][:, k] @ b[0][:, k].t())
            out = self._at(part + s * n_tok * h_dim * 4, (n_tok, h_dim), torch.float32)
            out.copy_(got if first else out + got)
        return 0

    def vocab_ce_dw_product_launch(self, ds_hi_t, h_t, out, n_tok, h_dim, rows, ld_t, stream):
        self.calls.append("dw")
        a = self._operand(ds_hi_t, rows, n_tok, ld_t).float()
        b = self._operand(h_t, h_dim, n_tok, ld_t).float()
        self._at(out, (rows, h_dim), torch.float32).copy_(a @ b.t())
        return 0

    def vocab_ce_dh_cast_launch(self, part, dh, n_tok, h_dim, splits, stream):
        self.calls.append("cast")
        x = self._at(part, (n_tok, h_dim), torch.float32).clone()
        for s in range(1, splits):
            x = x + self._at(part + s * n_tok * h_dim * 4, (n_tok, h_dim), torch.float32)
        self._at(dh, (n_tok, h_dim), torch.bfloat16).copy_(x)
        return 0

    def vocab_ce_fwd_split_w_launch(self, w, h_dim, v0, rows, hi, mid, lo, stream):
        self.calls.append("fwd_split_w")
        pieces = vc.split_bf16(self._at(w + v0 * h_dim * 4, (rows, h_dim), torch.float32))
        for ptr, q in zip((hi, mid, lo), pieces):
            self._operand(ptr, rows, h_dim, h_dim).copy_(q)
        return 0

    def vocab_ce_fwd_wgmma_launch(self, h, hi, mid, lo, labels, part, part_ix, n_tok, h_dim,
                                  vocab, v0, rows, stream):
        self.calls.append("fwd_wgmma")
        assert v0 % 128 == 0 and v0 + rows <= vocab
        tiles = -(-vocab // 128)
        x = self._operand(h, n_tok, h_dim, h_dim).float()
        s = sum(x @ self._operand(q, rows, h_dim, h_dim).float().t() for q in (hi, mid, lo))
        lab = self._at(labels, (1, n_tok), torch.int32)[0]
        stats = self._at(part, (4 * tiles, n_tok), torch.float32).view(4, tiles, n_tok)
        ids = self._at(part_ix, (tiles, n_tok), torch.int32)
        for t0 in range(0, rows, 128):
            tile = (v0 + t0) // 128
            *got, ids[tile] = _tile_partials(s[:, t0:t0 + 128], v0 + t0, vocab, lab)
            for k, x_ in enumerate(got):
                stats[k, tile] = x_
        return 0

    def vocab_ce_fwd_combine_launch(self, part, part_ix, loss, lse, pred, n_tok, vocab, splits,
                                    eps, one_minus_eps, eps_over_v, stream):
        self.calls.append("fwd_combine")
        stats = self._at(part, (4 * splits, n_tok), torch.float32).view(4, splits, n_tok)
        ids = self._at(part_ix, (splits, n_tok), torch.int32)
        out = _combine_partials(stats, ids, vocab, eps, one_minus_eps)
        for ptr, x_, dt in zip((loss, lse, pred), out, (torch.float32, torch.float32,
                                                        torch.int32)):
            self._at(ptr, (1, n_tok), dt)[0].copy_(x_)
        return 0


WRAPPER_CASES = [  # n_tok, vocab, h_dim, eps, need dH, need dW, scratch budget
    (20, 300, 30, 0.0, True, True, 1 << 16),      # H 30 padded to 32, three chunks
    (33, 333, 1032, 0.1, True, True, 1 << 20),    # BERT-large's fold, split-K, two chunks
    (16, 260, 2048, 0.0, True, False, 1 << 21),   # dH alone (a frozen W)
    (16, 260, 2048, 0.0, False, True, 1 << 21),   # dW alone
]


@pytest.mark.parametrize("case", WRAPPER_CASES, ids=lambda c: "-".join(map(str, c)))
def test_bwd_wrapper_runs_the_chunked_route(case, monkeypatch):
    """The bf16 wrapper (``_bwd_bf16``) drives the launches chunk by chunk
    over CPU memory (``_CpuLib`` stands in for the library, whose kernels
    run only on the card), with a small scratch budget so that several
    chunks and dH's split-K run: each launch in its order, the pointers and
    strides TMA takes, the padding of an H that is not a multiple of 8
    sliced back, dW's rows at each chunk's offset; the result is the plain
    dH and dW within the bf16 limits."""
    n_tok, vocab, h_dim, eps, need_dh, need_dw, budget = case
    monkeypatch.setattr(vc, "SCRATCH_BYTES", budget)
    monkeypatch.setattr(vc, "_stream", lambda t: None)
    h, w, lab, lse, g, eps = _chunk_case(n_tok, vocab, h_dim, eps, False, seed=37, edges=8)
    lib = _CpuLib()
    dh, dw = vc._bwd_bf16(lib, h, w, lab.to(torch.int32), lse, g, eps, need_dh, need_dw)
    h8 = -(-h_dim // 8) * 8
    v_chunk, splits, _ = vc.bwd_plan(n_tok, vocab, h8, need_dh, need_dw)
    chunks = -(-vocab // v_chunk)
    assert chunks > 1
    per_chunk = ["split_w", "ds"] + ["dh"] * need_dh + ["dw"] * need_dw
    assert lib.calls == ["transpose_h"] * need_dw + per_chunk * chunks + ["cast"] * need_dh
    want_dh, want_dw = _chunked_route(h, w, lab, lse, g, eps, v_chunk)
    if need_dh:
        assert dh.shape == h.shape and dh.dtype == torch.bfloat16
        assert (dh.float() - want_dh.float()).abs().max() <= 2.0 ** -7 * want_dh.float().abs().max()
    else:
        assert dh is None
    if need_dw:
        assert dw.shape == w.shape and dw.dtype == torch.float32
        torch.testing.assert_close(dw, want_dw, rtol=1e-5, atol=1e-6)
    if need_dh and need_dw:
        _assert_bf16_backward(h, w, lab, lse, g, eps, dh, dw)


# -- the chunked bf16 forward (csrc/vocab_ce_fwd.cuh) --------------------------

NEG_INF, NO_ID = -1e30, 0x7FFFFFFF     # the kernels' kNegInf and kNoId


def _merge(a, b):
    """Two partials (max, sum-exp, label logit, logit sum, first maximal
    id) of disjoint ids into one: sum-exps rescaled to the joint max, the
    lower id on a tie (the quad's merge in ``FwdEpilogue``)."""
    m = torch.maximum(a[0], b[0])
    l = a[1] * torch.exp(a[0] - m) + b[1] * torch.exp(b[0] - m)
    take = (b[0] > a[0]) | ((b[0] == a[0]) & (b[4] < a[4]))
    return m, l, torch.maximum(a[2], b[2]), a[3] + b[3], torch.where(take, b[4], a[4])


def _tile_partials(s, v_base, vocab, labels):
    """``FwdEpilogue`` on one logit tile ``s`` [N, <= 128] of global ids
    ``v_base``..: quad lane q holds columns 8 j + 2 q + e (j < 16, e < 2) in
    increasing order and reduces them (max and first argmax under a strict
    ``>``, sum-exp against the max, label logit, logit sum), ids >= V
    masked whatever their logit; then the lanes meet as the shuffles pair
    them (lane ^ 1, then lane ^ 2) and lane 0's result is the tile's."""
    n_tok = s.shape[0]
    lanes = []
    for q in range(4):
        cols = [c for j in range(16) for e in range(2) if (c := 8 * j + 2 * q + e) < s.shape[1]
                and v_base + c < vocab]
        m = torch.full((n_tok,), NEG_INF)
        ix = torch.full((n_tok,), NO_ID, dtype=torch.int32)
        ll, zs = torch.full((n_tok,), NEG_INF), torch.zeros(n_tok)
        for c in cols:
            x = s[:, c]
            ix = torch.where(x > m, v_base + c, ix).to(torch.int32)
            m = torch.maximum(m, x)
            ll = torch.where(labels == v_base + c, x, ll)
            zs = zs + x
        l = torch.zeros(n_tok)
        for c in cols:
            l = l + torch.exp(s[:, c] - m)
        lanes.append((m, l, ll, zs, ix))
    pairs = [_merge(lanes[0], lanes[1]), _merge(lanes[2], lanes[3])]
    return _merge(pairs[0], pairs[1])


def _combine_partials(stats, ids, vocab, eps, one_minus_eps):
    """``vocab_ce_combine_kernel``: the partials [4, T, N] and ids [T, N]
    merged tile by tile in vocab order (a strict ``>`` keeps the first
    maximal id), then the loss, the LSE and pred."""
    n_tok = stats.shape[2]
    m, l = torch.full((n_tok,), NEG_INF), torch.zeros(n_tok)
    ll, zs = torch.full((n_tok,), NEG_INF), torch.zeros(n_tok)
    ix = torch.zeros(n_tok, dtype=torch.int32)
    for t in range(stats.shape[1]):
        ms = stats[0, t]
        ix = torch.where(ms > m, ids[t], ix)
        mn = torch.maximum(m, ms)
        l = l * torch.exp(m - mn) + stats[1, t] * torch.exp(ms - mn)
        m, ll, zs = mn, torch.maximum(ll, stats[2, t]), zs + stats[3, t]
    lse = m + torch.log(l)
    target = one_minus_eps * ll + eps * zs / vocab if eps > 0 else ll
    return lse - target, lse, ix


def _fwd_tiled_route(hidden, weight, labels, eps, v_chunk):
    """The bf16 forward's arithmetic in plain PyTorch, chunk by chunk of
    ``v_chunk`` ids: the chunk's W split into hi, mid and lo; the three-pass
    logits; each 128-id tile reduced to one partial a token
    (``_tile_partials``), the chunk's columns past V filled with stale
    values that only the id mask keeps out; then the in-order combine."""
    (n_tok, _), vocab = hidden.shape, weight.shape[0]
    tiles = -(-vocab // 128)
    h = hidden.float()
    stats, ids = torch.empty(4, tiles, n_tok), torch.empty(tiles, n_tok, dtype=torch.int32)
    for v0 in range(0, vocab, v_chunk):
        s = sum(h @ q.float().t() for q in vc.split_bf16(weight[v0:v0 + v_chunk]))
        stale = torch.full((n_tok, -(-s.shape[1] // 128) * 128 - s.shape[1]), 50.0)
        s = torch.cat([s, stale], 1)
        for t0 in range(0, s.shape[1], 128):
            *got, ids[(v0 + t0) // 128] = _tile_partials(s[:, t0:t0 + 128], v0 + t0, vocab,
                                                         labels)
            stats[:, (v0 + t0) // 128] = torch.stack(got)
    one_minus_eps = torch.tensor(1.0 - eps, dtype=torch.float32).item()
    return _combine_partials(stats, ids, vocab, eps, one_minus_eps)


FWD_TILE_CASES = [  # n_tok, vocab, h_dim, eps, all-equal W, chunk
    (24, 300, 30, 0.0, False, 128),      # H off every tile, a short last tile
    (40, 300, 776, 0.1, False, 256),     # BERT-base's fold, Vc does not divide V, smoothing
    (33, 333, 1032, 0.0, False, 128),    # BERT-large's fold, ragged N
    (16, 260, 2048, 0.1, False, 128),    # TinyLlama's width
    (8, 200, 4096, 0.0, False, 128),     # Mixtral's width
    (40, 384, 32, 0.0, True, 128),       # every logit of a token bit-equal: pred 0
    (40, 384, 32, 0.1, True, 256),
]


@pytest.mark.parametrize("case", FWD_TILE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_fwd_tiled_route_matches_the_plain_version(case):
    """The bf16 forward's per-tile arithmetic gives the plain forward
    (``fused_ce_fwd_reference``): loss and LSE within 1e-5, pred equal but
    at near-ties and id 0 where every logit ties, with labels on either
    side of every tile and chunk edge, ragged N, V and H, and a chunk that
    does not divide V."""
    n_tok, vocab, h_dim, eps, ties, v_chunk = case
    h, w, lab, _, _, eps = _chunk_case(n_tok, vocab, h_dim, eps, ties, seed=43, edges=n_tok)
    loss, lse, pred = _fwd_tiled_route(h, w, lab, eps, v_chunk)
    rloss, rlse, rpred = vc.fused_ce_fwd_reference(h, w, lab, eps)
    torch.testing.assert_close(loss, rloss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    assert pred.dtype == torch.int32 and ((pred == rpred) | _near_tie(h, w)).all()
    if ties:
        assert (pred == 0).all() and (rpred == 0).all()


def test_tile_partials_tie_goes_to_the_lower_id():
    """Within a tile the quad's lanes interleave: an equal maximum at id 9
    (lane 0) and id 2 (lane 1) must give 2, and at ids 2 and 0 of one tile
    with a larger one in the next tile the later tile wins the combine."""
    s = torch.zeros(1, 128)
    s[0, 9] = s[0, 2] = 5.0
    assert int(_tile_partials(s, 0, 128, torch.tensor([0]))[4]) == 2
    s2 = torch.zeros(1, 256)
    s2[0, 130] = s2[0, 3] = 5.0
    parts = [_tile_partials(s2[:, t:t + 128], t, 256, torch.tensor([0])) for t in (0, 128)]
    stats = torch.stack([torch.stack(p[:4]) for p in parts], 1)
    ids = torch.stack([p[4] for p in parts])
    assert int(_combine_partials(stats, ids, 256, 0.0, 1.0)[2]) == 3


@pytest.mark.parametrize("eps", [0.0, 0.1], ids=["eps0", "eps0.1"])
def test_fwd_tiled_route_matches_pallas(eps):
    """The bf16 forward's per-tile arithmetic at H 128 over three chunks
    (128, 128 and 44 ids) against the Pallas ``_fwd_kernel`` in interpret
    mode: loss within 1e-5, pred equal but at near-ties."""
    hidden, weight, labels = _inputs(48, 300, seed=45)
    hidden = torch.from_numpy(hidden).bfloat16().float().numpy()   # bf16-exact
    labels[:6] = [127, 128, 255, 256, 299, 0]
    want_loss, want_pred = _jax(hidden, weight, labels, 16, 128, eps=eps, h_dtype="bfloat16")
    h = torch.from_numpy(hidden).to(torch.bfloat16)
    w, lab = torch.from_numpy(weight), torch.from_numpy(labels)
    loss, _, pred = _fwd_tiled_route(h, w, lab, eps, 128)
    np.testing.assert_allclose(loss.numpy(), want_loss, rtol=1e-5, atol=1e-5)
    assert ((pred.numpy() == want_pred) | _near_tie(h, w).numpy()).all()


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "N{}-V{}-H{}".format(*s))
def test_fwd_plan_keeps_the_scratch_under_its_budget(shape):
    """``fwd_plan``: the forward's scratch (W's three pieces of a chunk and
    the 20 bytes of statistics a 128-id tile and token) stays within
    ``SCRATCH_BYTES`` at every listed shape, the budget the backward
    shares; Vc is a multiple of 128 whose chunks cover V with the last one
    short by less than a chunk."""
    n_tok, vocab, h_dim = shape
    v_chunk, scratch = vc.fwd_plan(n_tok, vocab, h_dim)
    assert scratch <= vc.SCRATCH_BYTES
    assert scratch == 3 * v_chunk * h_dim * 2 + 20 * -(-vocab // 128) * n_tok
    assert v_chunk % 128 == 0 and 0 <= -(-vocab // v_chunk) * v_chunk - vocab < v_chunk


FWD_WRAPPER_CASES = [  # n_tok, vocab, h_dim, eps, all-equal W, scratch budget
    (20, 300, 30, 0.0, False, 1 << 16),      # H 30 padded to 32, two chunks
    (33, 333, 1032, 0.1, False, 1 << 20),    # BERT-large's fold, three chunks
    (16, 700, 2048, 0.0, False, 1 << 21),    # six chunks
    (40, 384, 32, 0.1, True, 1 << 14),       # ties across chunks
]


@pytest.mark.parametrize("case", FWD_WRAPPER_CASES, ids=lambda c: "-".join(map(str, c)))
def test_fwd_wrapper_runs_the_chunked_route(case, monkeypatch):
    """The bf16 forward wrapper (``_fwd_bf16``) drives the launches chunk
    by chunk over CPU memory (``_CpuLib`` stands in for the library), with
    a small scratch budget so that several chunks run: the split and the
    ``wgmma`` launch a chunk, then the combine once, each with the pointers
    and strides TMA takes and each chunk's tiles at their offset in the
    statistics; the result is ``_fwd_tiled_route``'s bit for bit and the
    plain forward's within 1e-5."""
    n_tok, vocab, h_dim, eps, ties, budget = case
    monkeypatch.setattr(vc, "SCRATCH_BYTES", budget)
    monkeypatch.setattr(vc, "_stream", lambda t: None)
    h, w, lab, _, _, eps = _chunk_case(n_tok, vocab, h_dim, eps, ties, seed=47, edges=8)
    lib = _CpuLib()
    loss, lse, pred = vc._fwd_bf16(lib, h, w, lab.to(torch.int32), eps)
    v_chunk, _ = vc.fwd_plan(n_tok, vocab, -(-h_dim // 8) * 8)
    chunks = -(-vocab // v_chunk)
    assert chunks > 1
    assert lib.calls == ["fwd_split_w", "fwd_wgmma"] * chunks + ["fwd_combine"]
    want = _fwd_tiled_route(torch.nn.functional.pad(h, (0, -h_dim % 8)),
                            torch.nn.functional.pad(w, (0, -h_dim % 8)), lab, eps, v_chunk)
    for got, w_ in zip((loss, lse, pred), want):
        assert got.shape == (n_tok,) and torch.equal(got, w_)
    rloss, rlse, rpred = vc.fused_ce_fwd_reference(h, w, lab, eps)
    torch.testing.assert_close(loss, rloss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    assert ((pred == rpred) | _near_tie(h, w)).all()
    if ties:
        assert (pred == 0).all()


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
    # bf16 hidden: the forward and the backward on the wgmma routes: H not
    # a multiple of 64 or 4 (30 padded to 32), smoothing, ties
    (256, 2000, 200, "bfloat16", 0.0, False),
    (64, 500, 800, "bfloat16", 0.1, False),
    (100, 3000, 30, "bfloat16", 0.0, False),
    (128, 640, 128, "bfloat16", 0.0, True),
    # past the old tensor-core forward's H cap (1216)
    (64, 500, 1280, "bfloat16", 0.0, False),
    # many token tiles with ragged N and V, ties across vocab tiles and
    # token tiles, H past the old dW cap (800)
    (1000, 1001, 768, "bfloat16", 0.0, False),
    (300, 1280, 64, "bfloat16", 0.0, True),
    (64, 500, 816, "bfloat16", 0.1, False),
    # TinyLlama's and Mixtral's widths
    (200, 3000, 2048, "bfloat16", 0.0, False),
    (72, 1500, 4096, "bfloat16", 0.1, False),
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


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(4096, 32000, 2048), (300, 3000, 776), (1000, 1001, 30)],
                         ids=lambda c: "N{}-V{}-H{}".format(*c))
def test_forward_repeats_bit_for_bit_on_card(cuda_device, case):
    """Two bf16 forward calls on the same inputs give identical loss, LSE
    and pred (each partial one quad's merge in a fixed order, the combine
    in vocab order, no atomics), at several chunks, ragged N and V and an
    H that is padded."""
    n_tok, vocab, h_dim = case
    hidden, weight, labels = _inputs(n_tok, vocab, seed=43, h_dim=h_dim)
    h = torch.from_numpy(hidden).to(cuda_device, torch.bfloat16)
    w = torch.from_numpy(weight * 0.4).to(cuda_device)
    lab = torch.from_numpy(labels).to(cuda_device)
    first = vc.fused_ce_fwd(h, w, lab, 0.1)
    second = vc.fused_ce_fwd(h, w, lab, 0.1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_tc_smem_bytes_mirror_the_library(cuda_device):
    """The Python mirror of the ``wgmma`` kernels' shared-memory size (the
    ring whatever H) gives the library's own number."""
    lib = vc._kernel_lib()
    for h_dim in (16, 24, 30, 64, 200, 768, 784, 800, 808, 816, 1216, 1280, 4096):
        for kernel in ("fwd", "dh", "dw"):
            assert lib.vocab_ce_wgmma_smem_bytes() == vc.tc_smem_bytes(kernel, h_dim), h_dim


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(4096, 32000, 2048), (300, 3000, 776)],
                         ids=lambda c: "N{}-V{}-H{}".format(*c))
def test_joint_backward_repeats_bit_for_bit_on_card(cuda_device, case):
    """Two joint backward calls on the same inputs give identical bits (no
    atomics, every sum in a fixed order), and equal the lone dH and dW."""
    n_tok, vocab, h_dim = case
    hidden, weight, labels = _inputs(n_tok, vocab, seed=41, h_dim=h_dim)
    h = torch.from_numpy(hidden).to(cuda_device, torch.bfloat16)
    w = torch.from_numpy(weight * 0.4).to(cuda_device)
    lab = torch.from_numpy(labels).to(cuda_device)
    g = torch.rand(n_tok, generator=torch.Generator().manual_seed(3)).to(cuda_device)
    _, lse, _ = vc.fused_ce_fwd(h, w, lab)
    first = vc.fused_ce_bwd(h, w, lab, lse, g)
    second = vc.fused_ce_bwd(h, w, lab, lse, g)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert torch.equal(first[0], vc.fused_ce_bwd_dh(h, w, lab, lse, g))
    assert torch.equal(first[1], vc.fused_ce_bwd_dw(h, w, lab, lse, g))


# the fused MLM loss's shapes: K = 1024 gathered rows (B 8 x S 512 x the
# 0.25 cap), BERT's vocab, the hidden width with the decoder bias folded in
# (train/trainer.py:bias_fold_width): BERT-base 768 -> 776, BERT-large
# 1024 -> 1032; DeBERTa-v3-base's vocab of 128100 at 776, train (K 1024)
# and eval (K 512)
MLM_CASES = [(1024, 30522, 776), (1024, 30522, 1032), (1024, 128100, 776),
             (512, 128100, 776)]


@pytest.mark.parametrize("h_dim,routes,dw_at_128_lanes", [
    (768, ("wgmma", "wgmma", "wgmma"), "wgmma"), (1024, ("wgmma", "wgmma", "wgmma"), "wgmma"),
    (128, ("wgmma", "wgmma", "wgmma"), "wgmma")])
def test_bias_fold_width_keeps_the_mlm_routes(h_dim, routes, dw_at_128_lanes):
    """The fused MLM loss widens H to the next multiple of 8 (16-byte bf16
    rows): BERT-base's 776 and BERT-large's 1032, like every width, take
    the ``wgmma`` forward, dH and dW, the reference's 128-lane fold
    included; a width that is a multiple of 8 is what TMA takes without
    padding."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import (
        bias_fold_width,
    )

    width = bias_fold_width(h_dim)
    assert width % 8 == 0 and h_dim < width <= h_dim + 8
    wgmma = vc.tc_smem_bytes("dh", 8)
    got = tuple("wgmma" if vc.tc_smem_bytes(k, width) == wgmma else "other"
                for k in ("fwd", "dh", "dw"))
    assert got == routes
    ref_dw = "wgmma" if vc.tc_smem_bytes("dw", h_dim + 128) == wgmma else "other"
    assert ref_dw == dw_at_128_lanes


@pytest.mark.gpu
@pytest.mark.parametrize("case", MLM_CASES, ids=lambda c: f"H{c[2]}" if c[1] == 30522
                         else f"N{c[0]}-V{c[1]}-H{c[2]}")
def test_mlm_shapes_match_reference_on_card(cuda_device, case):
    """K2 at the fused MLM loss's shapes, bf16 hidden with the folded bias
    column ``[h | 1 | 0...]`` and ``[W | b | 0...]``: each kernel against
    its plain version at the file's limits (loss and LSE 1e-4, dH and dW
    2e-2 relative to max(1, max|want|))."""
    n_tok, vocab, h_dim = case
    hidden, weight, labels = _inputs(n_tok, vocab, seed=12, h_dim=h_dim)
    hidden[:, -8:] = 0.0
    hidden[:, -8] = 1.0
    weight[:, -7:] = 0.0
    h = torch.from_numpy(hidden).to(cuda_device, torch.bfloat16)
    w = torch.from_numpy(weight).to(cuda_device)
    lab = torch.from_numpy(labels).to(cuda_device)
    g = (torch.rand(n_tok, generator=torch.Generator().manual_seed(2)) < 0.9).float()
    g = g.to(cuda_device)
    loss, lse, _ = vc.fused_ce_fwd(h, w, lab)
    rloss, rlse, _ = vc.fused_ce_fwd_reference(h, w, lab)
    dh = vc.fused_ce_bwd_dh(h, w, lab, rlse, g)
    dw = vc.fused_ce_bwd_dw(h, w, lab, rlse, g)
    rdh = vc.fused_ce_bwd_dh_reference(h, w, lab, rlse, g)
    rdw = vc.fused_ce_bwd_dw_reference(h, w, lab, rlse, g)
    torch.cuda.synchronize()
    for got, want, t in ((loss, rloss, 1e-4), (lse, rlse, 1e-4), (dh, rdh, 2e-2),
                         (dw, rdw, 2e-2)):
        got, want = got.float().cpu(), want.float().cpu()
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= t * max(1.0, want.abs().max().item())


# the fused seq2seq loss's shapes: B·T rows (batch 8 x target 64, eval
# batch 4 x 64), T5-small's vocab and d_model, BART-base's; label
# smoothing 0.1 on the training steps' kernels
SEQ2SEQ_CASES = [(512, 32128, 512, 0.1), (256, 32128, 512, 0.0),
                 (512, 50265, 768, 0.1), (256, 50265, 768, 0.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", SEQ2SEQ_CASES, ids=lambda c: f"N{c[0]}-V{c[1]}-eps{c[3]}")
def test_seq2seq_shapes_match_reference_on_card(cuda_device, case):
    """K2 at the fused seq2seq loss's shapes, bf16 hidden and fp32 W (the
    tensor-core kernels, smoothing on the training shapes; a tenth of the
    rows are padding with label 0 and g 0, as the loss masks them): each
    kernel against its plain version at the file's limits (loss and LSE
    1e-4, dH and dW 2e-2 relative to max(1, max|want|))."""
    n_tok, vocab, h_dim, eps = case
    hidden, weight, labels = _inputs(n_tok, vocab, seed=13, h_dim=h_dim)
    labels[::10] = 0
    h = torch.from_numpy(hidden).to(cuda_device, torch.bfloat16)
    w = torch.from_numpy(weight).to(cuda_device)
    lab = torch.from_numpy(labels).to(cuda_device)
    g = torch.ones(n_tok)
    g[::10] = 0.0
    g = g.to(cuda_device)
    loss, lse, _ = vc.fused_ce_fwd(h, w, lab, eps)
    rloss, rlse, _ = vc.fused_ce_fwd_reference(h, w, lab, eps)
    dh = vc.fused_ce_bwd_dh(h, w, lab, rlse, g, eps)
    dw = vc.fused_ce_bwd_dw(h, w, lab, rlse, g, eps)
    rdh = vc.fused_ce_bwd_dh_reference(h, w, lab, rlse, g, eps)
    rdw = vc.fused_ce_bwd_dw_reference(h, w, lab, rlse, g, eps)
    torch.cuda.synchronize()
    for got, want, t in ((loss, rloss, 1e-4), (lse, rlse, 1e-4), (dh, rdh, 2e-2),
                         (dw, rdw, 2e-2)):
        got, want = got.float().cpu(), want.float().cpu()
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= t * max(1.0, want.abs().max().item())
