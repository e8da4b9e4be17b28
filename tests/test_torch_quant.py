"""PyTorch port: int8 weight-only quantization (``models/quant.py``)
against the JAX package's ``models/quant.py``.

``quantize_kernel`` and the port's quantized tensors equal the JAX ones
exactly (the same numpy arithmetic on the JAX layout); a JAX-quantized
GPT-2, T5 and BART carried across (``params_from_jax`` with
``kernel_q``/``kernel_scale``) give logits within 1e-5 of the largest
JAX int8 logit; the quality contract of the JAX tests holds (logits
correlation > 0.999 and max relative error < 0.05 against full
precision); quantized cached decoding equals the argmax of quantized
full forwards."""

import dataclasses

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import generate as t_gen
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import quant as t_quant
from torch_decode_pairs import (  # noqa: F401  (autouse fixtures)
    detached_compile_trackers,
    gpt2_pair,
    one_torch_thread,
    port_of,
    seq2seq_pair,
)


def _jq():
    from huggingface_sagemaker_tensorflow_distributed_tpu.models import quant as j_quant

    return j_quant


def test_quantize_kernel_roundtrip_bound_and_jax_exact():
    rng = np.random.RandomState(0)
    w = (rng.randn(64, 48) * rng.uniform(0.01, 2.0, 48)[None, :]).astype(np.float32)
    q, scale = t_quant.quantize_kernel(w)
    jq, js = _jq().quantize_kernel(w)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(scale.view(np.int32), js.view(np.int32))
    assert q.dtype == np.int8 and scale.shape == (48,)
    err = np.abs(w - q.astype(np.float32) * scale[None, :])
    assert np.all(err <= scale[None, :] / 2 + 1e-7)
    w[:, 0] = 0.0
    q0, s0 = t_quant.quantize_kernel(w)
    assert np.all(q0[:, 0] == 0) and np.isfinite(s0).all()


def test_int8_linear_matches_manual_dequant_and_jax():
    import jax.numpy as jnp

    rng = np.random.RandomState(1)
    w = rng.randn(16, 8).astype(np.float32)
    q, scale = t_quant.quantize_kernel(w)
    bias = rng.randn(8).astype(np.float32)
    x = rng.randn(4, 16).astype(np.float32)
    cfg = SimpleCfg()
    layer = t_quant.Int8Linear(cfg, 16, 8)
    with torch.no_grad():
        layer.weight_q.copy_(torch.from_numpy(q.T.copy()))
        layer.weight_scale.copy_(torch.from_numpy(scale))
        layer.bias.copy_(torch.from_numpy(bias))
    got = layer(torch.from_numpy(x)).detach().numpy()
    want = x @ (q.astype(np.float32) * scale[None, :]) + bias
    np.testing.assert_allclose(got, want, atol=1e-5)
    jax_out = _jq().Int8Dense(8, dtype=jnp.float32).apply(
        {"params": {"kernel_q": jnp.asarray(q), "kernel_scale": jnp.asarray(scale),
                    "bias": jnp.asarray(bias)}}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(jax_out), atol=1e-5)


@dataclasses.dataclass(frozen=True)
class SimpleCfg:
    dtype: object = torch.float32
    param_dtype: object = torch.float32


def _gpt2():
    return gpt2_pair(num_layers=3, seed=0)


def test_quantized_gpt2_logits_close_and_equal_to_jax():
    """Quality contract against full precision; the port's own
    quantization equals the JAX-quantized tree carried across; logits
    within 1e-5 of the JAX int8 model's."""
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    jmodel, params, model = _gpt2()
    qmodel, stats = t_quant.quantize_for_generation(model)
    assert stats["kernels_quantized"] == 3 * 4
    for block in qmodel.backbone.h:
        assert all(isinstance(m, t_quant.Int8Linear) for m in (
            block.attention.qkv, block.attention.attn_out, block.mlp.fc_in, block.mlp.fc_out))
    jqmodel, jqparams, jstats = _jq().quantize_for_generation(jmodel, params)
    assert stats == jstats
    carried = port_of(jqmodel, jqparams)
    for key, value in carried.state_dict().items():
        assert torch.equal(qmodel.state_dict()[key], value), key
    ids = np.random.RandomState(0).randint(3, 128, (2, 12))
    with torch.no_grad():
        fp = model(torch.from_numpy(ids)).double().numpy()
        q8 = qmodel(torch.from_numpy(ids)).double().numpy()
    want = np.asarray(jqmodel.apply({"params": jqparams}, jnp.asarray(ids), deterministic=True))
    np.testing.assert_allclose(q8, want, rtol=0, atol=1e-5 * np.abs(want).max())
    corr = np.corrcoef(fp.ravel(), q8.ravel())[0, 1]
    assert corr > 0.999, corr
    assert np.abs(q8 - fp).max() / (np.abs(fp).max() + 1e-9) < 0.05
    assert len(flatten_dict(jqparams)) == len(qmodel.state_dict())


def test_quantized_decode_self_consistent():
    _, _, model = _gpt2()
    qmodel, _ = t_quant.quantize_for_generation(model)
    ids = np.random.RandomState(2).randint(3, 128, (2, 6))
    new = 5
    got = t_gen.generate_causal(qmodel, ids, max_new_tokens=new).numpy()
    cur = torch.from_numpy(ids)
    with torch.no_grad():
        for _ in range(new):
            nxt = qmodel(cur)[:, -1].argmax(-1)
            cur = torch.cat([cur, nxt[:, None]], 1)
    want = cur[:, ids.shape[1]:].numpy()
    eos = qmodel.config.eos_token_id
    for b in range(ids.shape[0]):
        stops = np.where(want[b] == eos)[0]
        upto = stops[0] + 1 if len(stops) else new
        np.testing.assert_array_equal(got[b, :upto], want[b, :upto])


def test_quantize_stats_bytes():
    """fp32 dense kernels -> about 4x smaller (int8 plus a scale row)."""
    _, stats = t_quant.quantize_for_generation(_gpt2()[2])
    ratio = stats["bytes_before"] / stats["bytes_after"]
    assert 3.5 < ratio <= 4.0, ratio


def test_quantize_rejects_non_generating_families():
    """A BERT raises the JAX ``ValueError`` word for word."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.auto import init_params
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.bert import (
        BertForSequenceClassification,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.layers import EncoderConfig

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import layers as t_layers
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import init_bert

    jcfg = EncoderConfig(vocab_size=64, hidden_size=32, num_layers=1, num_heads=4,
                         intermediate_size=64, max_position_embeddings=16)
    jmodel = BertForSequenceClassification(jcfg, num_labels=2)
    with pytest.raises(ValueError) as want:
        _jq().quantize_for_generation(jmodel, init_params(jmodel, jcfg, seed=0))
    bert = init_bert(t_layers.EncoderConfig(vocab_size=64, hidden_size=32, num_layers=1,
                                            num_heads=4, intermediate_size=64,
                                            max_position_embeddings=16), device="cpu")
    with pytest.raises(ValueError, match="GPT-2") as got:
        t_quant.quantize_for_generation(bert)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="matched no kernels"):
        t_quant.quantize_params({"a/kernel": np.ones((2, 2))}, t_quant.T5_QUANT_TARGETS)


@pytest.mark.parametrize("variant,kernels", [("t5", 2 * (4 + 2) + 2 * (8 + 2)),
                                             ("bart", 2 * (4 + 2) + 2 * (8 + 2)),
                                             ("mbart", 2 * (4 + 2) + 2 * (8 + 2))])
def test_quantized_seq2seq_logits_and_generate(variant, kernels):
    """T5, BART and mBART quantize (encoder: attention 4 + FFN 2 per layer;
    the decoder adds cross-attention), keep the quality contract, equal
    the JAX int8 models' logits within 1e-5 of the largest, and decode
    greedily as the JAX int8 models do."""
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.generate import generate

    jmodel, params, model = seq2seq_pair(variant, seed=3)
    qmodel, stats = t_quant.quantize_for_generation(model)
    assert stats["kernels_quantized"] == kernels
    jqmodel, jqparams, _ = _jq().quantize_for_generation(jmodel, params)
    carried = port_of(jqmodel, jqparams)
    assert all(torch.equal(v, qmodel.state_dict()[k]) for k, v in carried.state_dict().items())
    rng = np.random.RandomState(0)
    src = rng.randint(3, 96, (2, 10))
    dec = rng.randint(3, 96, (2, 6))
    with torch.no_grad():
        fp = model(torch.from_numpy(src), None, torch.from_numpy(dec)).double().numpy()
        q8 = qmodel(torch.from_numpy(src), None, torch.from_numpy(dec)).double().numpy()
    want = np.asarray(jqmodel.apply({"params": jqparams}, jnp.asarray(src), None,
                                    jnp.asarray(dec), deterministic=True))
    np.testing.assert_allclose(q8, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert np.corrcoef(fp.ravel(), q8.ravel())[0, 1] > 0.999
    out = t_gen.generate(qmodel, src, max_new_tokens=4)
    assert tuple(out.shape) == (2, 4)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(generate(jqmodel, jqparams, jnp.asarray(src), max_new_tokens=4)))
