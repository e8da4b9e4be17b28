"""PyTorch port: paged decode attention (``ops/paged_attention.py``) and
the paged addressing helpers (``ops/attention.py``) against the JAX
package — the Pallas kernel in interpret mode and the XLA gather path —
on the same numpy inputs; the split kernel's arithmetic (its chunks,
per-warp stages and combine, emulated in plain PyTorch) and its chunk
plan. Plus the CUDA kernels against their plain version on the card
(skipped without one)."""

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import attention as t_attn
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.flash_attention import (
    kernel_head_dim,
    pad_head_dim,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.paged_attention import (
    STAGE_KEYS,
    TILE,
    WARPS,
    paged_decode_attention,
    paged_decode_attention_reference,
    split_plan,
)

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread per test worker runs
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


def _case(seed, S=4, G=2, Hkv=2, D=8, bs=4, nb=5, int8=False):
    """numpy inputs: pools with a null block 0, scrambled tables, ragged
    contexts including 0 and a full table."""
    rng = np.random.RandomState(seed)
    N = 1 + S * nb
    k = rng.randn(N, bs, Hkv, D).astype(np.float32)
    v = rng.randn(N, bs, Hkv, D).astype(np.float32)
    tables = rng.permutation(np.arange(1, N)).reshape(S, nb).astype(np.int32)
    ctx = np.array([0, 7, 13, nb * bs][:S], np.int32)
    q = rng.randn(S, G * Hkv, D).astype(np.float32)
    scales = None
    if int8:
        ks = (0.05 + np.abs(rng.randn(N, bs, Hkv, 1))).astype(np.float32)
        vs = (0.05 + np.abs(rng.randn(N, bs, Hkv, 1))).astype(np.float32)
        k = np.clip(np.round(k / ks), -127, 127).astype(np.int8)
        v = np.clip(np.round(v / vs), -127, 127).astype(np.int8)
        scales = (ks, vs)
    return q, k, v, tables, ctx, scales


def _torch_call(fn, q, k, v, tables, ctx, scales, **kw):
    s = {} if scales is None else dict(k_scale_pool=torch.from_numpy(scales[0]),
                                        v_scale_pool=torch.from_numpy(scales[1]))
    out = fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
             torch.from_numpy(tables), torch.from_numpy(ctx), **s, **kw)
    return out.numpy()


def _jax_call(fn, q, k, v, tables, ctx, scales, **kw):
    import jax.numpy as jnp

    s = {} if scales is None else dict(k_scale_pool=jnp.asarray(scales[0]),
                                        v_scale_pool=jnp.asarray(scales[1]))
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(tables), jnp.asarray(ctx), **s, **kw))


def split_emulation(q, k_pool, v_pool, block_tables, context_lens, chunk,
                    scale=None, width=None, window=None, k_scale_pool=None,
                    v_scale_pool=None):
    """The split kernel's arithmetic (``csrc/paged_attention.cu``) in plain
    fp32 PyTorch: for each (slot, kv head, chunk of ``chunk`` positions
    from the band's start) each of the WARPS warps runs an online softmax
    over its stages, the STAGE_KEYS positions ``chunk_start + (WARPS * i
    + warp) * STAGE_KEYS``; the block merges its warps' states into the
    chunk's partial (m, l, acc), and the combine merges the partials of the
    chunks that hold keys, in chunk order, and divides (zeros where the sum
    is 0). Each merge rescales to the common max and gives an empty state
    (m = -1e30, l = 0) weight 0."""
    S, Hq, D = q.shape
    _, bs, Hkv, _ = k_pool.shape
    G = Hq // Hkv
    nb = block_tables.shape[1] if width is None else width // bs
    scale = D ** -0.5 if scale is None else scale
    span = nb * bs if window is None else min(nb * bs, window)
    chunks = max(1, -(-span // chunk))
    k_rows, v_rows = (p.reshape(-1, Hkv, D) for p in (k_pool, v_pool))

    def merge(states):
        m, l, acc = (torch.stack(t) for t in zip(*states))     # [n, G(, D)]
        big = torch.where(l > 0, m, torch.full_like(m, -1e30)).amax(0)
        wt = torch.where(l > 0, torch.exp(m - big), torch.zeros_like(m))
        return big, (wt * l).sum(0), (wt[..., None] * acc).sum(0)

    out = torch.zeros(S, Hq, D)
    for s in range(S):
        ctx = int(context_lens[s])
        hi = min(ctx, nb * bs)
        lo = max(0, ctx - window) if window else 0
        for h in range(Hkv):
            qg = q[s, h * G:(h + 1) * G].float()
            parts = []
            for c in range(chunks):
                cs = lo + c * chunk
                if cs >= hi:                    # the block exits at once
                    break
                ce = min(hi, cs + chunk)
                warps = []
                for w in range(WARPS):
                    m, l, acc = torch.full((G,), -1e30), torch.zeros(G), torch.zeros(G, D)
                    for p0 in range(cs + w * STAGE_KEYS, ce, TILE):
                        pos = torch.arange(p0, min(ce, p0 + STAGE_KEYS))
                        rows = block_tables[s, pos // bs].long() * bs + pos % bs
                        kk, vv = k_rows[rows, h].float(), v_rows[rows, h].float()
                        x = qg @ kk.T * scale
                        pv_scale = torch.ones(len(pos))
                        if k_scale_pool is not None:
                            x = x * k_scale_pool.reshape(-1, Hkv)[rows, h]
                            pv_scale = v_scale_pool.reshape(-1, Hkv)[rows, h]
                        m_new = torch.maximum(m, x.amax(-1))
                        alpha = torch.exp(m - m_new)
                        p = torch.exp(x - m_new[:, None])
                        l = l * alpha + p.sum(-1)
                        acc = acc * alpha[:, None] + (p * pv_scale) @ vv
                        m = m_new
                    warps.append((m, l, acc))
                parts.append(merge(warps))
            if not parts:
                continue
            _, L, o = merge(parts)
            out[s, h * G:(h + 1) * G] = torch.where(
                L[:, None] > 0, o / torch.where(L > 0, L, 1.0)[:, None], 0.0)
    return out.to(q.dtype)


@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("width", [None, 16])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_reference_matches_pallas_and_xla(groups, width, window, kind):
    from huggingface_sagemaker_tensorflow_distributed_tpu.ops.attention import (
        paged_attention as jax_paged_attention,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.ops.pallas_paged_attention import (
        paged_decode_attention as jax_pallas,
    )

    args = _case(groups * 10 + (width or 0) + (window or 0), G=groups,
                 int8=kind == "int8")
    ctx = args[4].copy()
    if width is not None:
        ctx = np.minimum(ctx, width)        # callers keep contexts in the bucket
    args = args[:4] + (ctx,) + args[5:]
    kw = dict(width=width, window=window)
    got = _torch_call(paged_decode_attention_reference, *args, **kw)
    want_pallas = _jax_call(jax_pallas, *args, interpret=True, **kw)
    want_xla = _jax_call(jax_paged_attention, *args, impl="xla", **kw)
    act = ctx > 0
    np.testing.assert_allclose(got[act], want_pallas[act], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[act], want_xla[act], rtol=TOL, atol=TOL)
    assert np.all(got[~act] == 0.0) and np.all(want_pallas[~act] == 0.0)
    # the split arithmetic with one chunk longer than the width
    split = _torch_call(split_emulation, *args, chunk=TILE, **kw)
    np.testing.assert_allclose(split[act], want_pallas[act], rtol=TOL, atol=TOL)
    assert np.all(split[~act] == 0.0)
    # the wrapper takes the plain version for CPU tensors: no launch
    launches = paged_decode_attention.launches
    np.testing.assert_array_equal(
        _torch_call(paged_decode_attention, *args, **kw), got)
    assert paged_decode_attention.launches == launches


@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("groups", [1, 8])
def test_wide_head_reference_matches_pallas(groups, window, kind):
    """Gemma's head_dim 256 at Gemma-7B's group width (1) and Gemma-2B's
    (8, MQA): the plain version and the split kernel's arithmetic against
    the Pallas kernel in interpret mode (1e-5)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.ops.pallas_paged_attention import (
        paged_decode_attention as jax_pallas,
    )

    args = _case(40 + groups + (window or 0), S=4, G=groups, Hkv=1 if groups == 8 else 2,
                 D=256, int8=kind == "int8")
    kw = dict(window=window)
    got = _torch_call(paged_decode_attention_reference, *args, **kw)
    want = _jax_call(jax_pallas, *args, interpret=True, **kw)
    act = args[4] > 0
    np.testing.assert_allclose(got[act], want[act], rtol=TOL, atol=TOL)
    assert np.all(got[~act] == 0.0) and np.all(want[~act] == 0.0)
    split = _torch_call(split_emulation, *args, chunk=TILE, **kw)
    np.testing.assert_allclose(split[act], want[act], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_padded_head_dim_equals_the_unpadded_call(kind):
    """The wrapper's padding of a head_dim without a kernel instance: q and
    the pools zero-padded from 96 to 128 with 96's scale, the output sliced
    back, give the unpadded plain call's output (1e-6)."""
    q, k, v, tables, ctx, scales = _case(44, G=4, D=96, int8=kind == "int8")
    s = {} if scales is None else dict(k_scale_pool=torch.from_numpy(scales[0]),
                                        v_scale_pool=torch.from_numpy(scales[1]))
    q, k, v = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    tables, ctx = torch.from_numpy(tables), torch.from_numpy(ctx)
    want = paged_decode_attention_reference(q, k, v, tables, ctx, window=6, **s)
    qp, kp, vp = pad_head_dim(kernel_head_dim(96), q, k, v)
    got = paged_decode_attention_reference(qp, kp, vp, tables, ctx, scale=96 ** -0.5,
                                           window=6, **s)
    np.testing.assert_allclose(got[..., :96].numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert bool((got[..., 96:] == 0).all())


def _chunk_edge_case(seed, chunk, groups, int8, window):
    """Pools of four 32-position blocks a slot; contexts 0, 1 and on and
    beside the chunk edges (chunk - 1, chunk, chunk + 1, 2 chunk). With
    ``window`` the band of the longer contexts spans two chunks and the
    short ones leave their later chunks empty."""
    q, k, v, tables, _, scales = _case(seed, S=6, G=groups, Hkv=2, D=8, bs=32,
                                       nb=4, int8=int8)
    ctx = np.array([0, 1, chunk - 1, chunk, chunk + 1, 2 * chunk], np.int32)
    return (q, k, v, tables, ctx, scales), dict(window=window)


@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("band", [False, True])
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("chunk", [32, 64], ids=["one_block", "two_blocks"])
def test_split_emulation_matches_reference_and_pallas(chunk, groups, band, kind):
    """The split kernel's chunks, stages and combine give the plain
    version's and the Pallas kernel's output: the same fp32 sums merged
    in another order (1e-5); context-0 rows exactly 0."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.ops.pallas_paged_attention import (
        paged_decode_attention as jax_pallas,
    )

    window = chunk + 8 if band else None
    args, kw = _chunk_edge_case(chunk + groups, chunk, groups, kind == "int8", window)
    got = _torch_call(split_emulation, *args, chunk=chunk, **kw)
    want = _torch_call(paged_decode_attention_reference, *args, **kw)
    want_pallas = _jax_call(jax_pallas, *args, interpret=True, **kw)
    act = args[4] > 0
    np.testing.assert_allclose(got[act], want[act], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[act], want_pallas[act], rtol=TOL, atol=TOL)
    assert np.all(got[~act] == 0.0) and np.all(want[~act] == 0.0)


@pytest.mark.parametrize("slots,kv_heads,span,block_size", [
    (8, 12, 1024, 16), (1, 12, 1024, 16), (8, 8, 1024, 16), (8, 12, 64, 16),
    (4, 2, 200, 4), (4, 12, 304, 8), (2, 1, 96, 12), (3, 4, 1, 16), (8, 12, 0, 16)])
def test_split_plan_chunks_cover_the_span(slots, kv_heads, span, block_size):
    """A chunk is a multiple of the tile and of the block size, the chunks
    cover the span, and none lies wholly past it."""
    chunk, chunks = split_plan(slots, kv_heads, span, block_size)
    assert chunk > 0 and chunk % TILE == 0 and chunk % block_size == 0
    assert chunk * chunks >= span and chunks >= 1
    assert (chunks - 1) * chunk < max(span, 1)


def test_split_plan_fills_the_card():
    """The serve shape (8 slots, 12 kv heads, width 1024) gets at least two
    blocks per SM of the H100's 132, and one request alone (1 slot) at
    least 132 blocks that hold keys at its full context."""
    chunk, chunks = split_plan(8, 12, 1024, 16)
    assert 8 * 12 * chunks >= 2 * 132
    chunk, chunks = split_plan(1, 12, 1024, 16)
    assert 12 * chunks >= 132 and (chunks - 1) * chunk < 1024


def test_workspace_is_reused_per_stream(monkeypatch):
    """The partials' buffer: one per (device, stream), reused by the next
    call on that stream, grown when a call needs more."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import paged_attention as pa

    monkeypatch.setattr(pa, "_WORKSPACE", {})
    cpu = torch.device("cpu")
    first = pa._workspace(100, cpu, 1)
    assert first.dtype == torch.float32 and first.numel() == 100
    assert pa._workspace(60, cpu, 1) is first
    other = pa._workspace(60, cpu, 2)
    assert other is not first and other.numel() == 60
    grown = pa._workspace(300, cpu, 1)
    assert grown.numel() == 300 and pa._workspace(100, cpu, 1) is grown


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_paged_attention_cpu_path_matches_jax_xla(kind):
    """``ops.attention.paged_attention`` on CPU tensors is the plain
    gather-then-attend path, context-0 rows included."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.ops.attention import (
        paged_attention as jax_paged_attention,
    )

    args = _case(3, G=2, int8=kind == "int8")
    got = _torch_call(t_attn.paged_attention, *args, window=6)
    want = _jax_call(jax_paged_attention, *args, impl="xla", window=6)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_gather_scatter_roundtrip_matches_jax():
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.ops.attention import (
        gather_paged_kv as jax_gather,
        scatter_paged_kv as jax_scatter,
    )

    rng = np.random.RandomState(0)
    N, bs, H, D = 9, 4, 2, 3
    pool = rng.randn(N, bs, H, D).astype(np.float32)
    tables = rng.permutation(np.arange(1, N)).reshape(2, 4).astype(np.int32)
    # writes of an inactive slot go to the null block 0
    rows = np.stack([tables[0], tables[1], np.zeros(4, np.int32)])
    pos = np.array([5, 15, 0], np.int32)
    vals = rng.randn(3, H, D).astype(np.float32)
    got = t_attn.scatter_paged_kv(torch.from_numpy(pool.copy()),
                                  torch.from_numpy(rows), torch.from_numpy(pos),
                                  torch.from_numpy(vals))
    want = jax_scatter(jnp.asarray(pool), jnp.asarray(rows), jnp.asarray(pos),
                       jnp.asarray(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy()[0, 0], vals[2])
    for width in (None, 8):
        g = t_attn.gather_paged_kv(got, torch.from_numpy(tables), width=width)
        w = jax_gather(want, jnp.asarray(tables), width=width)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("bad", ["gqa", "width_multiple", "width_span",
                                 "scales", "window", "chunk"])
def test_argument_checks_raise(bad):
    q, k, v, tables, ctx, scales = _case(5, int8=True)
    kw = {"k_scale_pool": torch.from_numpy(scales[0]),
          "v_scale_pool": torch.from_numpy(scales[1])}
    q = torch.from_numpy(q)
    if bad == "gqa":
        q = q[:, :3]
    elif bad == "width_multiple":
        kw["width"] = 6
    elif bad == "width_span":
        kw["width"] = 4 * (tables.shape[1] + 1)
    elif bad == "scales":
        del kw["v_scale_pool"]
    elif bad == "chunk":
        kw["chunk"] = TILE + 4              # not a multiple of the tile
    else:
        kw["window"] = 0
    with pytest.raises(ValueError):
        paged_decode_attention(q, torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(tables), torch.from_numpy(ctx),
                               **kw)


def test_masks_match_jax():
    from huggingface_sagemaker_tensorflow_distributed_tpu.ops import attention as j

    np.testing.assert_array_equal(t_attn.make_causal_mask(5, 7).numpy(),
                                  np.asarray(j.make_causal_mask(5, 7)))
    np.testing.assert_array_equal(
        t_attn.make_banded_causal_mask(6, 3, 8).numpy(),
        np.asarray(j.make_banded_causal_mask(6, 3, 8)))


def test_xla_attention_matches_jax():
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.ops.attention import (
        xla_attention,
    )

    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(2, 3, 5, 8).astype(np.float32) for _ in range(3))
    mask = np.where(rng.rand(2, 1, 5, 5) > 0.3, 0.0, -1e9).astype(np.float32)
    got = t_attn.xla_attention(*(torch.from_numpy(x) for x in (q, k, v, mask)))
    want = xla_attention(*(jnp.asarray(x) for x in (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["ragged", "chunk_edges", "single"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("groups", [1, 4])
def test_kernel_matches_reference_on_card(cuda_device, groups, window, kind, dtype, layout):
    """``ragged``: the chunk plan's split of a width below the table span,
    one context (48) past that width, whose band under window 6 lies
    wholly beyond it.
    ``chunk_edges``: a forced chunk of 32 positions, contexts 0, 1, 31, 32,
    33 and 64, a window of 40 that spans two chunks. ``single``: one slot
    at a full context of 1024 split over many blocks."""
    chunk, width = None, 40
    if layout == "single":
        q, k, v, tables, ctx, scales = _case(7, S=1, G=groups, Hkv=2, D=64, bs=16,
                                             nb=64, int8=kind == "int8")
        ctx, width = np.array([1024], np.int32), 1024
    else:
        q, k, v, tables, ctx, scales = _case(7, S=6, G=groups, Hkv=2, D=64, bs=8,
                                             nb=10, int8=kind == "int8")
        ctx = np.array([0, 7, 13, 48, 3, 22], np.int32)
    if layout == "chunk_edges":
        chunk, width = 32, 80
        ctx = np.array([0, 1, 31, 32, 33, 64], np.int32)
        window = 40 if window else None
    dt = getattr(torch, dtype)
    t = dict(q=torch.from_numpy(q).to(cuda_device, dt),
             k_pool=torch.from_numpy(k).to(cuda_device),
             v_pool=torch.from_numpy(v).to(cuda_device),
             block_tables=torch.from_numpy(tables).to(cuda_device),
             context_lens=torch.from_numpy(ctx).to(cuda_device), window=window,
             width=width)
    if scales is None:
        t["k_pool"], t["v_pool"] = t["k_pool"].to(dt), t["v_pool"].to(dt)
    else:
        t["k_scale_pool"] = torch.from_numpy(scales[0]).to(cuda_device)
        t["v_scale_pool"] = torch.from_numpy(scales[1]).to(cuda_device)
    launches = paged_decode_attention.launches
    got = paged_decode_attention(**t, chunk=chunk).float().cpu()
    want = paged_decode_attention_reference(**t).float().cpu()
    assert paged_decode_attention.launches == launches + 1
    act = torch.from_numpy(ctx) > 0
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got[act], want[act], atol=tol, rtol=tol)
    assert bool((got[~act] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("D,groups", [(256, 1), (256, 8), (256, 2), (96, 4)])
def test_wide_head_kernel_matches_reference_on_card(cuda_device, D, groups, window, kind,
                                                    dtype):
    """Gemma's head_dim 256 at the group widths of Gemma-7B (G 1) and
    Gemma-2B (G 8, MQA), and G 2; a head_dim without an instance (96)
    padded to the next one. Ragged contexts over 10 blocks of 16, one of
    them 0."""
    q, k, v, tables, _, scales = _case(11, S=5, G=groups, Hkv=2, D=D, bs=16, nb=10,
                                       int8=kind == "int8")
    ctx = np.array([0, 7, 150, 160, 64], np.int32)
    dt = getattr(torch, dtype)
    t = dict(q=torch.from_numpy(q).to(cuda_device, dt),
             k_pool=torch.from_numpy(k).to(cuda_device),
             v_pool=torch.from_numpy(v).to(cuda_device),
             block_tables=torch.from_numpy(tables).to(cuda_device),
             context_lens=torch.from_numpy(ctx).to(cuda_device), window=window)
    if scales is None:
        t["k_pool"], t["v_pool"] = t["k_pool"].to(dt), t["v_pool"].to(dt)
    else:
        t["k_scale_pool"] = torch.from_numpy(scales[0]).to(cuda_device)
        t["v_scale_pool"] = torch.from_numpy(scales[1]).to(cuda_device)
    launches = paged_decode_attention.launches
    got = paged_decode_attention(**t).float().cpu()
    want = paged_decode_attention_reference(**t).float().cpu()
    assert paged_decode_attention.launches == launches + 1
    act = torch.from_numpy(ctx) > 0
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got[act], want[act], atol=tol, rtol=tol)
    assert bool((got[~act] == 0).all())


@pytest.mark.parametrize("D", [256, 96, 288])
def test_head_dim_256_names_its_roadmap_entry(D):
    """Every head_dim up to 256 passes K3's head-dim checks on the card's
    side: meta tensors stand in for the card's, and the call gets as far as
    the device check (96 after its padding to the 128 instance). Above 256
    it raises ``ValueError`` naming ROADMAP queue 2's entry. The CPU path
    takes every width."""
    q = torch.empty(2, 4, D, device="meta")
    pool = torch.empty(5, 4, 2, D, device="meta")
    tables = torch.zeros(2, 2, dtype=torch.int32, device="meta")
    ctx = torch.zeros(2, dtype=torch.int32, device="meta")
    match = "no kernel for device meta" if D <= 256 else "ROADMAP queue 2"
    with pytest.raises(ValueError, match=match):
        paged_decode_attention(q, pool, pool, tables, ctx)
    cpu = paged_decode_attention(torch.randn(2, 4, D), torch.randn(5, 4, 2, D),
                                 torch.randn(5, 4, 2, D), torch.tensor([[1, 2], [3, 4]],
                                                                      dtype=torch.int32),
                                 torch.tensor([3, 5], dtype=torch.int32))
    assert cpu.shape == (2, 4, D)
