"""PyTorch port: GPT-2 (``models/``) against the JAX package on the same
weights — carried across with ``params_from_jax`` — and the same numpy
inputs: the full causal forward, the cached chunk forward, the paged
decode step and greedy ``generate_causal``. Plus the port's weight
init, config checks, activations, int8 KV quantization, and the rule
that the port imports nothing of JAX or of the JAX package."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import gpt2 as t_gpt2
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
    init_gpt2,
    params_from_jax,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.kv_cache import (
    PagedCache,
    kv_quantize,
)

TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=128,
            hidden_dropout=0.0, embd_dropout=0.0, attention_dropout=0.0,
            eos_token_id=127, pad_token_id=0)
ROOT = Path(__file__).resolve().parents[1]
PORT = "huggingface_sagemaker_tensorflow_distributed_tpu_torch"


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


def _pair(kv_cache_dtype="fp"):
    """(jax model, jax params, port model) on the same weights."""
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.auto import (
        init_params,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.gpt2 import (
        Gpt2Config,
        Gpt2LMHeadModel,
    )

    jcfg = Gpt2Config(dtype=jnp.float32, kv_cache_dtype=kv_cache_dtype, **TINY)
    jmodel = Gpt2LMHeadModel(jcfg)
    params = init_params(jmodel, jcfg, seed=0)
    model = t_gpt2.Gpt2LMHeadModel(
        t_gpt2.Gpt2Config(kv_cache_dtype=kv_cache_dtype, **TINY))
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    model.load_state_dict(params_from_jax(flat), strict=True)
    return jmodel, params, model.eval()


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_full_forward_logits_match_jax(pair):
    import jax
    import jax.numpy as jnp

    jmodel, params, model = pair
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 127, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[1, :3] = 0                                   # left padding
    for m in (None, mask):
        want = np.asarray(jax.jit(jmodel.apply)(
            {"params": params}, jnp.asarray(ids),
            None if m is None else jnp.asarray(m)))
        with torch.no_grad():
            got = model(torch.from_numpy(ids).long(),
                        None if m is None else torch.from_numpy(m)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_cached_chunk_forward_matches_jax(pair, kv):
    """Two chunks of a prompt through the dense per-row cache, rows at
    different write positions: same logits, same cache contents (int8
    values and their scales with ``kv_cache_dtype='int8'``)."""
    import jax
    import jax.numpy as jnp

    jmodel, params, model = pair if kv == "fp" else _pair(kv)
    rng = np.random.RandomState(1)
    B, L, C = 2, 24, 5
    _, var = jmodel.apply({"params": params}, jnp.ones((B, L), jnp.int32),
                          decode=True, mutable=["cache"])
    jcache = var["cache"]
    start = np.array([0, 3], np.int32)
    # row 1 starts at position 3: its first 3 slots hold earlier context
    jcache = jax.tree_util.tree_map(
        lambda x: x.at[:].set(start) if x.shape == (B,) else x, jcache)
    cache = model.new_dense_cache(B, L, index=torch.from_numpy(start))
    step = jax.jit(lambda p, c, ids, valid, pos: jmodel.apply(
        {"params": p, "cache": c}, ids, valid, position_ids=pos, decode=True,
        mutable=["cache"]))
    for chunk in range(2):
        ids = rng.randint(1, 127, (B, C)).astype(np.int32)
        cur = np.asarray(start) + chunk * C
        valid = (np.arange(L)[None, :] < cur[:, None] + C).astype(np.int32)
        pos = cur[:, None] + np.arange(C)[None, :]
        want, mut = step(params, jcache, jnp.asarray(ids), jnp.asarray(valid),
                         jnp.asarray(pos))
        jcache = mut["cache"]
        with torch.no_grad():
            got = model(torch.from_numpy(ids).long(), torch.from_numpy(valid),
                        torch.from_numpy(pos).long(), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    for i in range(TINY["num_layers"]):
        jattn = jcache["backbone"][f"h_{i}"]["attention"]
        jk = np.asarray(jattn["cached_key"])
        if kv == "int8":
            # a last-ulp difference in K may round one int8 step apart
            assert np.abs(cache.keys[i].numpy().astype(int) - jk).max() <= 1
            np.testing.assert_allclose(cache.key_scales[i].numpy(),
                                       np.asarray(jattn["cached_key_scale"]),
                                       rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_allclose(cache.keys[i].numpy(), jk,
                                       rtol=1e-5, atol=1e-5)
    assert cache.index.tolist() == (start + 2 * C).tolist()


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_paged_decode_step_matches_jax(kv):
    """One single-token step through the paged branch (JAX: the Pallas
    kernel in interpret mode) with an inactive slot on the null block:
    same logits on the active rows, same pools after the scatter."""
    import jax
    import jax.numpy as jnp

    jmodel, params, model = _pair(kv)
    rng = np.random.RandomState(2)
    S, bs, nb, H, D = 3, 4, 4, 2, 16
    N = 1 + S * nb
    L = TINY["num_layers"]
    tables = rng.permutation(np.arange(1, N)).reshape(S, nb).astype(np.int32)
    tables[2] = 0                                      # inactive slot
    ctx = np.array([5, 11, 0], np.int32)
    tokens = rng.randint(1, 127, (S,)).astype(np.int32)
    if kv == "int8":
        pools = [rng.randint(-127, 128, (N, bs, H, D)).astype(np.int8)
                 for _ in range(2 * L)]
        scales = [(0.01 + 0.02 * rng.rand(N, bs, H, 1)).astype(np.float32)
                  for _ in range(2 * L)]
    else:
        pools = [rng.randn(N, bs, H, D).astype(np.float32) for _ in range(2 * L)]
        scales = None
    jcache = {"backbone": {}}
    for i in range(L):
        attn = {"cached_key": jnp.asarray(pools[2 * i]),
                "cached_value": jnp.asarray(pools[2 * i + 1]),
                "cache_index": jnp.asarray(ctx), "block_tables": jnp.asarray(tables)}
        if scales is not None:
            attn["cached_key_scale"] = jnp.asarray(scales[2 * i])
            attn["cached_value_scale"] = jnp.asarray(scales[2 * i + 1])
        jcache["backbone"][f"h_{i}"] = {"attention": attn}
    want, mut = jax.jit(lambda p, c, tok, pos: jmodel.apply(
        {"params": p, "cache": c}, tok, None, position_ids=pos, decode=True,
        mutable=["cache"]))(params, jcache, jnp.asarray(tokens)[:, None],
                            jnp.asarray(ctx)[:, None])

    def t(xs):
        return None if xs is None else [torch.from_numpy(x.copy()) for x in xs]

    tp, ts = t(pools), t(scales)
    cache = PagedCache(tp[0::2], tp[1::2], None if ts is None else ts[0::2],
                       None if ts is None else ts[1::2],
                       torch.from_numpy(tables), torch.from_numpy(ctx))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long()[:, None], None,
                    torch.from_numpy(ctx).long()[:, None], cache).numpy()
    act = ctx > 0
    np.testing.assert_allclose(got[act], np.asarray(want)[act],
                               rtol=1e-4, atol=1e-4)
    for i in range(L):
        jattn = mut["cache"]["backbone"][f"h_{i}"]["attention"]
        np.testing.assert_allclose(cache.key_pools[i][1:].numpy(),
                                   np.asarray(jattn["cached_key"])[1:],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("left_pad", [False, True])
def test_generate_causal_matches_jax(pair, left_pad):
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.generate import (
        generate_causal as jax_generate,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.generate import (
        generate_causal,
    )

    jmodel, params, model = pair
    rng = np.random.RandomState(3)
    ids = rng.randint(1, 120, (2, 7)).astype(np.int32)
    mask = np.ones_like(ids)
    if left_pad:
        mask[0, :2] = 0
    want = np.asarray(jax_generate(jmodel, params, jnp.asarray(ids),
                                   jnp.asarray(mask), max_new_tokens=9))
    got, scores = generate_causal(model, torch.from_numpy(ids),
                                  torch.from_numpy(mask), max_new_tokens=9,
                                  output_scores=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert scores.shape == (2, 9, TINY["vocab_size"])


def test_init_gpt2_scheme_and_seed():
    cfg = t_gpt2.Gpt2Config(vocab_size=512, hidden_size=64, num_layers=8,
                            num_heads=2, intermediate_size=256,
                            max_position_embeddings=256)
    a = init_gpt2(cfg, seed=3, device="cpu")
    b = init_gpt2(cfg, seed=3, device="cpu")
    c = init_gpt2(cfg, seed=4, device="cpu")
    sd = a.state_dict()
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in sd.items())
    assert not torch.equal(sd["backbone.wte.weight"], c.state_dict()["backbone.wte.weight"])
    resid = 0.02 / (2 * cfg.num_layers) ** 0.5
    for name, std in (("backbone.wte.weight", 0.02),
                      ("backbone.h.0.attention.qkv.weight", 0.02),
                      ("backbone.h.3.mlp.fc_in.weight", 0.02),
                      ("backbone.h.0.attention.attn_out.weight", resid),
                      ("backbone.h.7.mlp.fc_out.weight", resid)):
        assert abs(sd[name].std().item() - std) < 0.1 * std, name
    assert torch.all(sd["backbone.h.2.mlp.fc_in.bias"] == 0)
    assert torch.all(sd["backbone.h.2.ln_1.weight"] == 1)
    assert torch.all(sd["backbone.ln_f.weight"] == 1)
    assert not a.training and not any(p.requires_grad for p in a.parameters())


def test_params_from_jax_layouts():
    flat = {"params/backbone/h_3/mlp/fc_in/kernel": np.ones((4, 6), np.float32),
            "backbone/ln_f/scale": np.ones(4, np.float32),
            "backbone/wte/embedding": np.zeros((10, 4), np.float32)}
    sd = params_from_jax(flat)
    assert sd["backbone.h.3.mlp.fc_in.weight"].shape == (6, 4)
    assert set(sd) == {"backbone.h.3.mlp.fc_in.weight", "backbone.ln_f.weight",
                       "backbone.wte.weight"}
    # an int8 kernel (models/quant.py) carries as [out, in], its scales as they are
    sd = params_from_jax({"backbone/h_0/mlp/fc_in/kernel_q": np.ones((4, 6), np.int8),
                          "backbone/h_0/mlp/fc_in/kernel_scale": np.ones(6, np.float32)})
    assert sd["backbone.h.0.mlp.fc_in.weight_q"].shape == (6, 4)
    assert sd["backbone.h.0.mlp.fc_in.weight_q"].dtype == torch.int8
    assert sd["backbone.h.0.mlp.fc_in.weight_scale"].shape == (6,)
    with pytest.raises(ValueError):
        params_from_jax({"backbone/h_0/mlp/fc_in/kernel_z": np.ones(2)})


@pytest.mark.parametrize("field,value", [
    ("num_experts", 4), ("pipeline_stages", 2), ("remat", True),
    ("weight_quant", "int8"), ("attention_impl", "ring"),
    ("kv_cache_dtype", "fp8"), ("param_dtype", "bfloat16")])
def test_config_rejects_unported_features(field, value):
    if field == "remat":
        # remat is ported under every policy (ROADMAP item 4)
        assert dataclasses.replace(t_gpt2.Gpt2Config(), remat=True).remat
        for policy in ("dots", "dots_no_batch"):
            cfg = dataclasses.replace(t_gpt2.Gpt2Config(), remat=True, remat_policy=policy)
            assert cfg.remat_policy == policy
        return
    if field == "num_experts":
        # MoE is ported (models/moe.py): every moe_every-th block's MLP is
        # the expert bank with the residual-flow wo init
        cfg = dataclasses.replace(t_gpt2.Gpt2Config(**TINY), **{field: value})
        model = t_gpt2.Gpt2LMHeadModel(cfg)
        assert hasattr(model.backbone.h[1], "moe") and hasattr(model.backbone.h[0], "mlp")
        return
    if field == "weight_quant":
        # int8 weight-only quantization is ported (models/quant.py): the
        # block's denses become Int8Linear; a mode no package takes raises
        from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.quant import (
            Int8Linear,
        )

        cfg = dataclasses.replace(t_gpt2.Gpt2Config(**TINY), **{field: value})
        block = t_gpt2.Gpt2LMHeadModel(cfg).backbone.h[0]
        assert all(isinstance(m, Int8Linear) for m in (
            block.attention.qkv, block.attention.attn_out, block.mlp.fc_in, block.mlp.fc_out))
        with pytest.raises(ValueError, match="weight_quant"):
            dataclasses.replace(t_gpt2.Gpt2Config(), weight_quant="int4")
        return
    if field == "attention_impl":
        # ring attention is ported (ROADMAP item 11, step 1); as in the JAX
        # package a training forward refuses attention_dropout > 0 with it
        cfg = dataclasses.replace(t_gpt2.Gpt2Config(**TINY), **{field: value},
                                  attention_dropout=0.1)
        model = t_gpt2.Gpt2LMHeadModel(cfg).train()
        with pytest.raises(ValueError, match="attention_dropout > 0 cannot combine"):
            model(torch.ones(1, 4, dtype=torch.long))
        return
    # what is not ported yet names its ROADMAP item; a value no package
    # takes is a ValueError
    unported = field == "pipeline_stages"
    with pytest.raises(NotImplementedError if unported else ValueError,
                       match="ROADMAP queue 1, item" if unported else None):
        dataclasses.replace(t_gpt2.Gpt2Config(), **{field: value})


def test_config_from_hf_matches_jax():
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.gpt2 import (
        gpt2_config_from_hf,
    )

    hf = {"vocab_size": 50257, "n_positions": 1024, "n_embd": 768,
          "n_layer": 12, "n_head": 12, "resid_pdrop": 0.0, "pad_token_id": 0}
    want = gpt2_config_from_hf(hf)
    got = t_gpt2.gpt2_config_from_hf(hf)
    for f in dataclasses.fields(got):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert t_gpt2.Gpt2Config() == t_gpt2.gpt2_config_from_hf(
        {"vocab_size": 50257, "n_embd": 768, "n_layer": 12, "n_head": 12})


@pytest.mark.parametrize("name", ["gelu", "gelu_new", "gelu_pytorch_tanh",
                                  "relu", "silu", "tanh"])
def test_activations_match_jax(name):
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.layers import (
        ACT2FN as JAX_ACT2FN,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.layers import (
        ACT2FN,
    )

    x = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(ACT2FN[name](torch.from_numpy(x)).numpy(),
                               np.asarray(JAX_ACT2FN[name](jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_kv_quantize_matches_jax():
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.llama import (
        kv_quantize as jax_kv_quantize,
    )

    x = np.random.RandomState(4).randn(2, 3, 5, 8).astype(np.float32)
    x[0, 1, 2] = 0.0                                  # zero row: scale 0
    q, s = kv_quantize(torch.from_numpy(x))
    jq, js = jax_kv_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    assert s[0, 1, 2].item() == 0.0


def _port_files():
    return sorted((ROOT / PORT).rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    """No module of the port, and not chip_smoke.py, imports jax, flax,
    optax or the JAX package (the exact name or a dotted child)."""
    banned = ("jax", "flax", "optax", "huggingface_sagemaker_tensorflow_distributed_tpu")
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert not any(n == b or n.startswith(b + ".") for b in banned), \
                f"{path.name}:{node.lineno} imports {n}"
