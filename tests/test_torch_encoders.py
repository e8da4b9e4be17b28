"""PyTorch port: the encoder families (``models/{bert,roberta,distilbert,
electra,albert}.py``, ``models/layers.py``, ``models/convert.py``,
``models/auto.py``) against the JAX package on the same weights, carried
across with ``params_from_jax``, and the same numpy inputs: every (family,
task) of the registry's logits, on the plain and the flash path; the
gradients of the factorized-embedding families (ELECTRA's projection,
ALBERT's one shared layer, whose gradient is the sum over its
applications); RoBERTa's mask-counted position ids; HF-layout exports
that each package reads from the other, with the JAX package's keys and
``config.json``; the config builders; and the FLOPs accounting.

Tolerances: logits 1e-4 (fp32 through 2-3 layers; the two frameworks sum
in other orders), gradients 1e-4 relative plus 1e-6."""

import json

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto as t_auto
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import layers as t_layers
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
    encoder_from_hf,
    encoder_to_hf,
    init_encoder,
    params_from_jax,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import flops as t_flops

SEQ = 16
NUM_LABELS = 5
# tiny configs in each family's own HF dialect, dropout 0; ELECTRA and
# ALBERT embed at half the hidden width, ALBERT applies its layer 3 times
HF_CONFIGS = {
    "bert": {"model_type": "bert", "vocab_size": 128, "hidden_size": 64,
             "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 128,
             "max_position_embeddings": 64, "hidden_dropout_prob": 0.0,
             "attention_probs_dropout_prob": 0.0},
    "roberta": {"model_type": "roberta", "vocab_size": 128, "hidden_size": 64,
                "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 128,
                "max_position_embeddings": 66, "type_vocab_size": 1, "pad_token_id": 1,
                "layer_norm_eps": 1e-5, "hidden_dropout_prob": 0.0,
                "attention_probs_dropout_prob": 0.0},
    "distilbert": {"model_type": "distilbert", "vocab_size": 128, "dim": 64, "n_layers": 2,
                   "n_heads": 2, "hidden_dim": 128, "max_position_embeddings": 64,
                   "dropout": 0.0, "attention_dropout": 0.0},
    "electra": {"model_type": "electra", "vocab_size": 128, "hidden_size": 64,
                "embedding_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
                "intermediate_size": 128, "max_position_embeddings": 64,
                "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0},
    "albert": {"model_type": "albert", "vocab_size": 128, "hidden_size": 64,
               "embedding_size": 32, "num_hidden_layers": 3, "num_attention_heads": 2,
               "intermediate_size": 128, "max_position_embeddings": 64,
               "hidden_act": "gelu_new", "hidden_dropout_prob": 0.0,
               "attention_probs_dropout_prob": 0.0, "classifier_dropout_prob": 0.0},
}
FAMILIES = list(HF_CONFIGS)
TASKS = ["seq-cls", "token-cls", "qa"]
CASES = [(f, t) for f in FAMILIES for t in TASKS]


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


def _config_dir(path, family):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(HF_CONFIGS[family]))
    return str(path)


def _jax_model(path, family, task):
    """The JAX package's model, params and config for ``family``/``task``
    from the config in ``path`` (fresh weights unless ``path`` holds a
    ``model.safetensors``)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto

    model, params, fam, cfg = j_auto.from_pretrained(path, task=task,
                                                     num_labels=NUM_LABELS, seed=3)
    assert fam == family
    return model, params, cfg


def _flat(params):
    from flax.traverse_util import flatten_dict

    return {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}


def _port_from_jax(path, family, task, params, attention_impl="xla"):
    """The port's model for ``family``/``task`` with the JAX params."""
    hf = HF_CONFIGS[family]
    overrides = {"use_pooler": False} if family in ("bert", "albert") and task != "seq-cls" \
        else {}
    cfg = t_auto.CONFIG_BUILDERS[family](hf, attention_impl=attention_impl, **overrides)
    model = t_auto.build_model(family, task, cfg, num_labels=NUM_LABELS)
    model.load_state_dict(params_from_jax(_flat(params)), strict=True)
    return model.eval()


def _inputs(seed=0, b=3, pad_id=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, 128, (b, SEQ)).astype(np.int32)
    mask = np.ones((b, SEQ), np.int32)
    mask[1, 11:] = 0
    mask[2, 5:] = 0
    ids[mask == 0] = pad_id
    types = np.zeros((b, SEQ), np.int32)
    types[0, 8:] = 1
    return ids, mask, types


def _jax_out(model, params, ids, mask, types):
    import jax.numpy as jnp

    out = model.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                      token_type_ids=None if types is None else jnp.asarray(types))
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


def _port_out(model, ids, mask, types):
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                    token_type_ids=None if types is None else torch.from_numpy(types).long())
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("family,task", CASES, ids=[f"{f}-{t}" for f, t in CASES])
def test_logits_match_jax(tmp_path, family, task, impl):
    """Every (family, task) of the registry gives the JAX model's logits
    (QA: start and end) on its weights, through the plain attention and
    the flash path (its plain versions on the CPU)."""
    path = _config_dir(tmp_path, family)
    jmodel, params, _ = _jax_model(path, family, task)
    model = _port_from_jax(path, family, task, params, attention_impl=impl)
    # token type 1 in every family: RoBERTa has one type (the JAX lookup
    # clamps to it), DistilBERT none (both packages ignore them)
    ids, mask, types = _inputs(pad_id=HF_CONFIGS[family].get("pad_token_id", 0))
    want = _jax_out(jmodel, params, ids, mask, types)
    got = _port_out(model, ids, mask, types)
    shape = {"seq-cls": (3, NUM_LABELS), "token-cls": (3, SEQ, NUM_LABELS), "qa": (3, SEQ)}
    assert len(got) == len(want) == (2 if task == "qa" else 1)
    for g, w in zip(got, want):
        assert g.shape == w.shape == shape[task] and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", ["electra", "albert", "roberta"])
def test_token_cls_gradients_match_jax(tmp_path, family):
    """The token-cls loss's gradient of every parameter equals JAX's:
    ELECTRA's ``embeddings_project``, ALBERT's ``shared_layer`` (one set
    of weights, the gradient summed over its 3 applications) and
    RoBERTa's mask-counted positions."""
    import jax
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.train.trainer import (
        token_cls_loss as j_loss,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import (
        token_cls_loss,
    )

    path = _config_dir(tmp_path, family)
    jmodel, params, _ = _jax_model(path, family, "token-cls")
    model = _port_from_jax(path, family, "token-cls", params)
    ids, mask, types = _inputs(seed=2, pad_id=HF_CONFIGS[family].get("pad_token_id", 0))
    labels = np.random.RandomState(5).randint(0, NUM_LABELS, (3, SEQ)).astype(np.int32)
    labels[:, 0] = -100
    batch = {"input_ids": ids, "attention_mask": mask, "labels": labels,
             "token_type_ids": types}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.grad(lambda p: j_loss(jmodel.apply, p, jbatch, None, False)[0])(params)
    model.train()
    loss, _ = token_cls_loss(model, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    loss.backward()
    want = params_from_jax(_flat(want))
    grads = dict(model.named_parameters())
    assert set(want) == set(grads)
    for name, w in want.items():
        np.testing.assert_allclose(grads[name].grad.numpy(), w.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    if family == "albert":
        assert not any(".layer." in n for n in grads)
        assert sum(n.startswith("backbone.shared_layer.") for n in grads) == 16


def test_roberta_position_ids_count_the_mask():
    """Positions run from pad + 1 over the mask's ones; pads take the pad
    id, whatever the token there (the JAX rule, not HF's ``ids != pad``)."""
    cfg = t_auto.CONFIG_BUILDERS["roberta"](HF_CONFIGS["roberta"])
    emb = t_layers.Embeddings(cfg)
    seen = {}
    emb.position_embeddings.register_forward_hook(
        lambda mod, args, out: seen.update(ids=args[0]))
    mask = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]])
    ids = torch.tensor([[5, 6, 1, 7, 8], [5, 6, 7, 8, 9]])   # a pad id inside the mask
    emb(ids, attention_mask=mask)
    assert seen["ids"].tolist() == [[2, 3, 4, 1, 1], [2, 3, 4, 5, 6]]
    seen.clear()
    emb(ids)
    assert seen["ids"].tolist() == [[2, 3, 4, 5, 6]]


@pytest.mark.parametrize("family,task", CASES, ids=[f"{f}-{t}" for f, t in CASES])
def test_hf_exports_read_across_packages(tmp_path, family, task):
    """The port's export carries the JAX package's keys, shapes and
    ``config.json`` and loads into the JAX ``from_pretrained`` with the
    same logits; the JAX export loads into the port's with them too."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.convert import (
        params_to_hf,
    )

    path = _config_dir(tmp_path / "cfg", family)
    jmodel, params, jcfg = _jax_model(path, family, task)
    port, fam, cfg = t_auto.from_pretrained(path, task=task, num_labels=NUM_LABELS, seed=7,
                                            device="cpu")
    assert fam == family
    ids, mask, types = _inputs(seed=4, pad_id=HF_CONFIGS[family].get("pad_token_id", 0))

    out = tmp_path / "port_export"
    t_auto.save_pretrained(str(out), port, family, cfg)
    want_keys = params_to_hf(params, family)
    from safetensors.numpy import load_file

    written = load_file(str(out / "model.safetensors"))
    assert {k: v.shape for k, v in written.items()} == \
        {k: v.shape for k, v in want_keys.items()}
    assert json.loads((out / "config.json").read_text()) == \
        j_auto._HF_CONFIG_EXPORTERS[family](jcfg)
    jm, jp, _, _ = j_auto.from_pretrained(str(out), task=task, num_labels=NUM_LABELS)
    for g, w in zip(_port_out(port, ids, mask, types), _jax_out(jm, jp, ids, mask, types)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)

    jout = tmp_path / "jax_export"
    j_auto.save_pretrained(str(jout), params, family, jcfg)
    reloaded, _, _ = t_auto.from_pretrained(str(jout), task=task, num_labels=NUM_LABELS,
                                            device="cpu")
    for g, w in zip(_port_out(reloaded, ids, mask, types),
                    _jax_out(jmodel, params, ids, mask, types)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", FAMILIES)
def test_hf_key_rules_match_jax(family):
    """``encoder_to_hf`` names every parameter of every head (MLM and RTD
    too) as the JAX ``params_to_hf`` does, ``encoder_from_hf`` inverts it
    with or without the family's prefix, and other families' heads' keys
    and the tied decoder weights are dropped."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.convert import (
        translate_key,
    )

    cfg = t_auto.CONFIG_BUILDERS[family](HF_CONFIGS[family])
    tasks = TASKS + ["mlm"] + (["rtd"] if family == "electra" else [])
    for task in tasks:
        model = t_auto.build_model(family, task, cfg, num_labels=NUM_LABELS)
        state = model.state_dict()
        hf = encoder_to_hf(state, family)
        assert len(hf) == len(state), sorted(set(state) - set(encoder_from_hf(hf, family)))
        back = encoder_from_hf({k.split(".", 1)[1] if k.startswith(family + ".") else k: v
                                for k, v in hf.items()}, family)
        assert set(back) == set(state)
        for key in hf:
            jax_path = translate_key(key, family)
            assert jax_path is not None, key
    # another family's MLM and RTD heads, and the tied decoders, are dropped
    own = {"bert": "cls.predictions.bias", "roberta": "lm_head.bias",
           "distilbert": "vocab_projector.bias", "albert": "predictions.bias",
           "electra": "generator_lm_head.bias"}
    others = [k for f, k in own.items() if f != family]
    if family != "electra":
        others.append("discriminator_predictions.dense.bias")
    tied = ["cls.predictions.decoder.weight", "lm_head.decoder.weight",
            "predictions.decoder.weight", "generator_lm_head.weight"]
    assert encoder_from_hf({k: torch.zeros(3) for k in others + tied}, family) == {}


def test_detect_family_and_config_builders():
    """The port's registry covers the JAX package's five encoder families
    times {seq-cls, token-cls, qa}; aliases map (the Llama family's
    variants to ``llama``), DeBERTa-v2 is known; each builder gives the JAX
    config's fields."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto

    for family, task in CASES:
        assert (family, task) in t_auto.MODEL_REGISTRY
    assert t_auto.detect_family({"model_type": "xlm-roberta"}) == "roberta"
    assert t_auto.detect_family({"model_type": "camembert"}) == "roberta"
    assert t_auto.detect_family({"model_type": "deberta-v2"}) == "deberta-v2"
    for mt in ("llama", "mistral", "qwen2", "gemma", "mixtral"):
        assert t_auto.detect_family({"model_type": mt}) == "llama"
    with pytest.raises(ValueError):
        t_auto.detect_family({"model_type": "mystery"})
    skip = {"dtype", "param_dtype"}
    for family, hf in HF_CONFIGS.items():
        want = j_auto.CONFIG_BUILDERS[family](hf)
        got = t_auto.CONFIG_BUILDERS[family](hf)
        for field in type(got).__dataclass_fields__:
            if field not in skip:
                assert getattr(got, field) == getattr(want, field), (family, field)
    for bad in ({"num_hidden_groups": 2}, {"inner_group_num": 2}):
        with pytest.raises(ValueError, match="num_hidden_groups"):
            t_auto.CONFIG_BUILDERS["albert"]({**HF_CONFIGS["albert"], **bad})
    # an encoder family has no seq2seq model: the JAX package's ValueError
    with pytest.raises(ValueError, match="no model for family='bert' task='seq2seq'"):
        t_auto.build_model("bert", "seq2seq", t_auto.CONFIG_BUILDERS["bert"](HF_CONFIGS["bert"]))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("task", TASKS)
def test_flops_accounting_matches_jax(family, task):
    """MFU's FLOPs per token: ALBERT's shared layer counted once per
    application, ELECTRA's projection left out, as the JAX package does."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import flops as j_flops

    hf = HF_CONFIGS[family]
    got = t_flops.trainer_flops_per_token(t_auto.CONFIG_BUILDERS[family](hf), task, 384)
    want = j_flops.trainer_flops_per_token(j_auto.CONFIG_BUILDERS[family](hf), task, 384)
    assert got == pytest.approx(want, rel=1e-12)
    layers = hf.get("num_hidden_layers", hf.get("n_layers"))
    h = hf.get("hidden_size", hf.get("dim"))
    ffn = hf.get("intermediate_size", hf.get("hidden_dim"))
    assert got[0] == 3 * layers * (8 * h * h + 4 * 384 * h + 4 * h * ffn)


def test_init_encoder_scheme_and_seed():
    """Fresh weights: normal(initializer_range) kernels and embeddings,
    zero biases, unit LayerNorm scales; the same seed, the same model."""
    cfg = t_auto.CONFIG_BUILDERS["albert"](HF_CONFIGS["albert"])
    a, b, c = (init_encoder(t_auto.build_model("albert", "qa", cfg), seed=s, device="cpu")
               for s in (3, 3, 4))
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith("bias"):
            assert not pa.any(), name
        elif name.endswith("_ln.weight"):
            assert (pa == 1).all(), name
        else:
            assert not torch.equal(pa, pc), name
            assert 0.01 < float(pa.detach().std()) < 0.03, name
