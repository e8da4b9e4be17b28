"""PyTorch port: BERT for sequence classification (``models/layers.py``,
``models/bert.py``, ``models/convert.py``, ``models/auto.py``) against the
JAX package on the same weights — carried across with ``params_from_jax``
— and the same numpy inputs: logits, seq-cls loss gradients, flash against
plain attention inside the port, HF-layout checkpoints that load across
the two packages, and the port's own safetensors reader and writer against
the ``safetensors`` package.

Tolerances: logits 1e-4 and gradients 1e-5 + 1e-4 relative (fp32 through a
2-layer encoder; the two frameworks sum in other orders)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto as t_auto
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import layers as t_layers
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.bert import (
    BertForSequenceClassification,
    bert_config_from_hf,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
    bert_from_hf,
    bert_to_hf,
    init_bert,
    params_from_jax,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.safetensors_io import (
    load_file,
    save_file,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import seq_cls_loss

TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=64,
            hidden_dropout=0.0, attention_dropout=0.0)
SEQ = 16


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


def _jax_pair(attention_impl="xla", port_impl="xla"):
    """(jax model, jax params, port model) on the same weights."""
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.auto import init_params
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.bert import (
        BertForSequenceClassification as JaxBert,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.layers import (
        EncoderConfig as JaxConfig,
    )

    jmodel = JaxBert(JaxConfig(dtype=jnp.float32, attention_impl=attention_impl, **TINY),
                     num_labels=2)
    params = init_params(jmodel, seed=0)
    model = BertForSequenceClassification(
        t_layers.EncoderConfig(attention_impl=port_impl, **TINY), num_labels=2)
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    model.load_state_dict(params_from_jax(flat), strict=True)
    return jmodel, params, model.eval()


@pytest.fixture(scope="module")
def pair():
    return _jax_pair()


def _batch(seed=0, b=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, TINY["vocab_size"], (b, SEQ)).astype(np.int32)
    mask = np.ones((b, SEQ), np.int32)
    mask[1, 11:] = 0
    mask[2, 5:] = 0
    ids[mask == 0] = 0
    labels = rng.randint(0, 2, (b,)).astype(np.int32)
    return ids, mask, labels


def _port_logits(model, ids, mask):
    with torch.no_grad():
        return model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()).numpy()


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_logits_match_jax(pair, impl):
    import jax.numpy as jnp

    jmodel, params, _ = pair
    _, _, model = _jax_pair(port_impl=impl)
    ids, mask, _ = _batch()
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    got = _port_logits(model, ids, mask)
    assert got.dtype == np.float32 and got.shape == (3, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_logits_match_jax_flash_interpret():
    """The JAX model on its Pallas flash kernel (interpret mode) against the
    port on its flash path (the plain versions on the CPU)."""
    import jax.numpy as jnp

    jmodel, params, model = _jax_pair(attention_impl="flash", port_impl="flash")
    ids, mask, _ = _batch(1)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(_port_logits(model, ids, mask), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_seq_cls_loss_and_gradients_match_jax(pair, impl):
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.train.trainer import (
        seq_cls_loss as jax_seq_cls_loss,
    )

    jmodel, params, _ = pair
    _, _, model = _jax_pair(port_impl=impl)
    ids, mask, labels = _batch(2)
    jbatch = {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask),
              "labels": jnp.asarray(labels)}
    (jloss, jsums), jgrads = jax.value_and_grad(
        lambda p: jax_seq_cls_loss(jmodel.apply, p, jbatch, {}, False), has_aux=True)(params)
    model.train()
    tbatch = {"input_ids": torch.from_numpy(ids).long(),
              "attention_mask": torch.from_numpy(mask).long(),
              "labels": torch.from_numpy(labels).long()}
    loss, sums = seq_cls_loss(model, tbatch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for key in ("loss_sum", "correct", "count"):
        np.testing.assert_allclose(sums[key].item(), float(jsums[key]), rtol=1e-5)
    want = params_from_jax({k: np.asarray(v)
                            for k, v in flatten_dict(jgrads, sep="/").items()})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_flash_and_plain_paths_agree_in_the_port():
    _, _, flash = _jax_pair(port_impl="flash")
    _, _, plain = _jax_pair(port_impl="xla")
    ids, mask, labels = _batch(3)
    batch = {"input_ids": torch.from_numpy(ids).long(),
             "attention_mask": torch.from_numpy(mask).long(),
             "labels": torch.from_numpy(labels).long()}
    losses = []
    for model in (flash, plain):
        model.train()
        loss, _ = seq_cls_loss(model, batch)
        loss.backward()
        losses.append(loss.item())
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
    for (name, a), b in zip(flash.named_parameters(), plain.parameters()):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def _hf_config(tmp_path):
    cfg = {"model_type": "bert", "vocab_size": TINY["vocab_size"],
           "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
           "intermediate_size": 64, "max_position_embeddings": 64,
           "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    return cfg


def test_port_checkpoint_loads_into_jax(tmp_path):
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto

    _hf_config(tmp_path)
    model, family, cfg = t_auto.from_pretrained(str(tmp_path), from_scratch=True, seed=3,
                                                device="cpu")
    out = tmp_path / "export"
    t_auto.save_pretrained(str(out), model, family, cfg)
    assert sorted(p.name for p in out.iterdir()) == ["config.json", "model.safetensors"]
    jmodel, params, jfamily, _ = j_auto.from_pretrained(str(out), task="seq-cls",
                                                        dtype=jnp.float32)
    assert jfamily == "bert"
    ids, mask, _ = _batch(4)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(_port_logits(model, ids, mask), want, rtol=1e-4, atol=1e-4)
    # and back into the port: the same weights, bit for bit
    again, _, _ = t_auto.from_pretrained(str(out), device="cpu")
    for (name, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name


def test_jax_checkpoint_loads_into_port(pair, tmp_path):
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.layers import (
        EncoderConfig as JaxConfig,
    )

    jmodel, params, _ = pair
    j_auto.save_pretrained(str(tmp_path), params, "bert",
                           JaxConfig(dtype=jnp.float32, **TINY))
    model, family, cfg = t_auto.from_pretrained(str(tmp_path), device="cpu")
    assert family == "bert" and cfg.num_layers == 2
    ids, mask, _ = _batch(5)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(_port_logits(model, ids, mask), want, rtol=1e-4, atol=1e-4)


def test_checkpoint_missing_backbone_weight_raises(tmp_path):
    _hf_config(tmp_path)
    model, family, cfg = t_auto.from_pretrained(str(tmp_path), from_scratch=True,
                                                device="cpu")
    state = bert_to_hf(model.state_dict())
    head_free = {k: v for k, v in state.items() if not k.startswith("classifier")}
    save_file(head_free, str(tmp_path / "model.safetensors"))
    fresh, _, _ = t_auto.from_pretrained(str(tmp_path), device="cpu", seed=7)
    assert torch.equal(fresh.state_dict()["backbone.pooler.pooler.weight"],
                       model.state_dict()["backbone.pooler.pooler.weight"])
    del head_free["bert.encoder.layer.1.output.dense.weight"]
    save_file(head_free, str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="backbone params missing"):
        t_auto.from_pretrained(str(tmp_path), device="cpu")


def test_hf_names_match_jax_export(pair):
    """``bert_to_hf`` gives the JAX package's ``params_to_hf`` names and
    layouts, and ``bert_from_hf`` inverts it (also without the ``bert.``
    prefix)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.convert import (
        params_to_hf,
    )

    _, params, model = pair
    want = params_to_hf(params, "bert")
    got = bert_to_hf(model.state_dict())
    assert sorted(got) == sorted(want)
    for key, value in got.items():
        np.testing.assert_array_equal(value.numpy(), want[key], err_msg=key)
    back = bert_from_hf({k.replace("bert.", "", 1): v for k, v in got.items()})
    assert sorted(back) == sorted(model.state_dict())
    # the MLM head's bias is BERT's; the tied decoder and RoBERTa's head
    # are dropped
    assert list(bert_from_hf({"cls.predictions.bias": torch.zeros(3)})) == ["mlm_head.bias"]
    assert bert_from_hf({"cls.predictions.decoder.weight": torch.zeros(3),
                         "lm_head.bias": torch.zeros(3)}) == {}


def test_safetensors_interchange_with_the_package(tmp_path):
    from safetensors import safe_open
    from safetensors.numpy import load_file as np_load
    from safetensors.numpy import save_file as np_save

    rng = np.random.RandomState(6)
    tensors = {"a.weight": torch.from_numpy(rng.randn(3, 5).astype(np.float32)),
               "b": torch.arange(7, dtype=torch.int64),
               "c": torch.from_numpy(rng.randn(4).astype(np.float32)).to(torch.bfloat16),
               "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 3)}
    path = str(tmp_path / "port.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    with safe_open(path, framework="numpy") as f:      # numpy has no bf16: skip "c"
        assert f.metadata() == {"format": "pt"}
        for key in ("a.weight", "b", "scalar", "empty"):
            np.testing.assert_array_equal(f.get_tensor(key), tensors[key].numpy())
    back = load_file(path)
    for key, value in tensors.items():
        assert back[key].dtype == value.dtype and torch.equal(back[key], value), key
    other = str(tmp_path / "package.safetensors")
    np_save({k: v.numpy() for k, v in tensors.items() if v.dtype != torch.bfloat16}, other)
    for key, value in load_file(other).items():
        assert torch.equal(value, tensors[key]), key
    assert set(np_load(other)) == {"a.weight", "b", "scalar", "empty"}


def test_config_from_hf_matches_jax():
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.bert import (
        bert_config_from_hf as jax_config_from_hf,
    )

    hf = {"vocab_size": 30522, "hidden_size": 768, "num_hidden_layers": 12,
          "num_attention_heads": 12, "intermediate_size": 3072,
          "max_position_embeddings": 512, "hidden_dropout_prob": 0.0}
    want, got = jax_config_from_hf(hf), bert_config_from_hf(hf)
    for f in dataclasses.fields(got):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_init_bert_scheme_and_seed():
    cfg = t_layers.EncoderConfig(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
                                 intermediate_size=256, max_position_embeddings=128)
    a, b, c = (init_bert(cfg, seed=s, device="cpu") for s in (3, 3, 4))
    sd = a.state_dict()
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in sd.items())
    assert not torch.equal(sd["classifier.weight"], c.state_dict()["classifier.weight"])
    for name in ("backbone.embeddings.word_embeddings.weight",
                 "backbone.encoder.layer.1.ffn.intermediate.weight"):
        assert abs(sd[name].std().item() - 0.02) < 0.002, name
    assert torch.all(sd["backbone.encoder.layer.0.attention.query.bias"] == 0)
    assert torch.all(sd["backbone.encoder.layer.1.ffn_ln.weight"] == 1)
    assert torch.all(sd["backbone.embeddings.embeddings_ln.bias"] == 0)
    assert not a.training and all(p.requires_grad for p in a.parameters())


def test_bf16_compute_keeps_fp32_params():
    cfg = t_layers.EncoderConfig(dtype=torch.bfloat16, attention_impl="flash", **TINY)
    model = init_bert(cfg, seed=0, device="cpu")
    ids, mask, _ = _batch(7)
    with torch.no_grad():
        logits = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    assert logits.dtype == torch.bfloat16 and torch.isfinite(logits.float()).all()
    assert all(p.dtype == torch.float32 for p in model.parameters())


# a factorized embedding_size (ELECTRA, ALBERT), position_offset
# (RoBERTa), MoE layers and ring attention are ported: they build, the rest
# still raises
@pytest.mark.parametrize("field,value", [
    ("num_experts", 4), ("pipeline_stages", 2), ("embedding_size", 16),
    ("position_offset", 2), ("attention_impl", "ring")])
def test_encoder_config_rejects_unported(field, value):
    if field in ("embedding_size", "position_offset", "num_experts", "attention_impl"):
        assert getattr(t_layers.EncoderConfig(**{**TINY, field: value}), field) == value
        return
    with pytest.raises(NotImplementedError):
        t_layers.EncoderConfig(**{**TINY, field: value})


def test_detect_family_and_missing_dir(tmp_path):
    assert t_auto.detect_family({"model_type": "bert"}) == "bert"
    assert t_auto.detect_family({"model_type": "roberta"}) == "roberta"
    assert t_auto.detect_family({"model_type": "deberta-v2"}) == "deberta-v2"
    assert t_auto.detect_family({"model_type": "llama"}) == "llama"
    with pytest.raises(ValueError):
        t_auto.detect_family({"model_type": "mystery"})
    with pytest.raises(FileNotFoundError):
        t_auto.from_pretrained(str(tmp_path / "nope"), device="cpu")
    _hf_config(tmp_path)
    with pytest.raises(ValueError, match="no model for family='bert' task='seq2seq'"):
        t_auto.from_pretrained(str(tmp_path), task="seq2seq", device="cpu")
