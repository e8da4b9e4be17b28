"""PyTorch port: paged decode attention (``ops/paged_attention.py``) and
the paged addressing helpers (``ops/attention.py``) against the JAX
package — the Pallas kernel in interpret mode and the XLA gather path —
on the same numpy inputs. Plus the CUDA kernel against its plain version
on the card (skipped without one)."""

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import attention as t_attn
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_reference,
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
    # the wrapper takes the plain version for CPU tensors: no launch
    launches = paged_decode_attention.launches
    np.testing.assert_array_equal(
        _torch_call(paged_decode_attention, *args, **kw), got)
    assert paged_decode_attention.launches == launches


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
                                 "scales", "window"])
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("groups", [1, 4])
def test_kernel_matches_reference_on_card(cuda_device, groups, window, kind, dtype):
    q, k, v, tables, ctx, scales = _case(7, S=4, G=groups, Hkv=2, D=64, bs=8,
                                         nb=6, int8=kind == "int8")
    dt = getattr(torch, dtype)
    t = dict(q=torch.from_numpy(q).to(cuda_device, dt),
             k_pool=torch.from_numpy(k).to(cuda_device),
             v_pool=torch.from_numpy(v).to(cuda_device),
             block_tables=torch.from_numpy(tables).to(cuda_device),
             context_lens=torch.from_numpy(ctx).to(cuda_device), window=window,
             width=40)
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
