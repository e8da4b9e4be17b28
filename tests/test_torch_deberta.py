"""PyTorch port: DeBERTa-v2/v3 (``models/deberta.py``; its registry,
config and HF layout in ``models/auto.py`` and ``models/convert.py``; its
FLOPs in ``obs/flops.py``) against the JAX package's models on the same
weights (carried across with ``params_from_jax``) and the same numpy
inputs. Mirrors the JAX ``tests/test_deberta.py``, held against the JAX
models instead of HF's: v3-style (shared key, log buckets, the
rel-embedding layer norm), v2-style with separate position projections and
the conv layer, c2p only, ``embedding_size`` below ``hidden_size`` with
token types, the four heads, the hub's string ``pos_att_type``, the log
buckets, exports read across both packages, the non-legacy MLM refusal,
the fused MLM loss against the JAX fused loss (Pallas in interpret mode,
hidden 128), and a 5-step fit against the JAX ``Trainer``.

Tolerances: logits within 1e-4 of the largest JAX logit (fp32 through two
layers and two gathers a layer in two frameworks); buckets and reloaded
logits exact; loss curves and fused loss sums 1e-5 relative; FLOPs per
token 1e-12 relative."""

import json

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import config as t_config
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import pipeline as t_pipe
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import sources as t_src
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import tokenization as t_tok
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto as t_auto
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import deberta as t_deb
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
    params_from_jax,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import flops as t_flops
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import trainer as t_trainer

VOCAB = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _detached_compile_trackers():
    """Remove any JAX compile tracker an earlier telemetry test left in
    this worker (it fails every later jax compile; ROADMAP queue 3)."""
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


def _hf(**kw) -> dict:
    """A tiny DeBERTa config.json in the hub's dialect (the JAX test's
    ``_hf_cfg``), dropout 0."""
    base = dict(model_type="deberta-v2", vocab_size=VOCAB, hidden_size=32,
                num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=64, type_vocab_size=0, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0, pooler_dropout=0.0,
                relative_attention=True, position_buckets=16, norm_rel_ebd="layer_norm",
                share_att_key=True, pos_att_type=["c2p", "p2c"], pad_token_id=0,
                position_biased_input=False)
    base.update(kw)
    return base


CONFIGS = {
    "v3": _hf(),
    "v2-separate-pos-proj": _hf(share_att_key=False, position_buckets=-1,
                                max_relative_positions=16, norm_rel_ebd="none",
                                position_biased_input=True),
    "v2-conv": _hf(conv_kernel_size=3, conv_act="tanh", share_att_key=False,
                   position_biased_input=True),
    "c2p-only": _hf(pos_att_type=["c2p"]),
    "embedding-size-token-types": _hf(embedding_size=16, type_vocab_size=2),
    "hub-string-pos-att-type": _hf(pos_att_type="p2c|c2p"),
}


def _dir(tmp_path, name, hf):
    path = tmp_path / name
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(hf))
    return str(path)


def _flat(tree):
    import jax
    from flax.traverse_util import flatten_dict

    return {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(tree), sep="/").items()}


def _pair(tmp_path, hf, task="seq-cls", seed=0, name="m", perturb=True):
    """(JAX model, JAX params, port model) on the same weights: the JAX
    model freshly initialized from ``hf`` (every tensor perturbed, so a
    dropped parameter, a zero bias or a unit norm scale cannot hide), the
    port's loaded with them."""
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict, unflatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto

    path = _dir(tmp_path, name, hf)
    jmodel, params, family, _ = j_auto.from_pretrained(path, task=task, seed=seed)
    assert family == "deberta-v2"
    if perturb:
        rng = np.random.RandomState(seed + 11)
        params = unflatten_dict({k: jnp.asarray(np.asarray(v) + rng.randn(*v.shape) * 0.02,
                                                jnp.float32)
                                 for k, v in flatten_dict(params).items()})
    model, fam, _ = t_auto.from_pretrained(path, task=task, device="cpu")
    assert fam == "deberta-v2"
    model.load_state_dict(params_from_jax(_flat(params)), strict=True)
    return jmodel, params, model


def _inputs(batch=3, seq=12, seed=0, token_types=False):
    r = np.random.RandomState(seed)
    ids = r.randint(4, VOCAB, (batch, seq))
    mask = np.ones((batch, seq), np.int64)
    mask[1, 8:] = 0
    ids[1, 8:] = 0
    tt = (r.rand(batch, seq) < 0.5).astype(np.int64) if token_types else None
    return ids, mask, tt


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def _run_both(jmodel, params, model, ids, mask, tt=None):
    import jax.numpy as jnp

    j_out = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                         token_type_ids=None if tt is None else jnp.asarray(tt),
                         deterministic=True)
    with torch.no_grad():
        t_out = model.eval()(torch.from_numpy(ids), torch.from_numpy(mask),
                             token_type_ids=None if tt is None else torch.from_numpy(tt))
    return j_out, t_out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_seq_cls_logits_match_jax(tmp_path, name):
    hf = CONFIGS[name]
    jmodel, params, model = _pair(tmp_path, hf)
    ids, mask, tt = _inputs(token_types=hf.get("type_vocab_size", 0) > 0)
    j_out, t_out = _run_both(jmodel, params, model, ids, mask, tt)
    _close(t_out.numpy(), j_out)
    if name == "hub-string-pos-att-type":
        assert model.config.pos_att_type == ("p2c", "c2p")
    if name == "v2-conv":
        # flax's Conv kernel [K, in, out] through params_from_jax's .T is
        # Conv1d's [out, in, K]
        k = _flat(params)["backbone/conv/conv/kernel"]
        np.testing.assert_array_equal(model.backbone.conv.conv.weight.detach().numpy(),
                                      k.transpose(2, 1, 0))


@pytest.mark.parametrize("task", ["token-cls", "qa", "mlm"])
def test_task_heads_match_jax(tmp_path, task):
    """The token-cls, QA and legacy MLM heads (the decoder tied to the word
    embeddings, the bias drawn away from zero) on the v3 config."""
    jmodel, params, model = _pair(tmp_path, CONFIGS["v3"], task=task)
    ids, mask, _ = _inputs()
    j_out, t_out = _run_both(jmodel, params, model, ids, mask)
    if task == "qa":
        for j, t in zip(j_out, t_out):
            _close(t.numpy(), j)
    else:
        _close(t_out.numpy(), j_out)


def test_padded_query_rows_are_uniform():
    """The mask is a ``where`` over query and key validity: a padded
    query's attention row is uniform over all keys, as the JAX code gives."""
    cfg = t_deb.DebertaV2Config(vocab_size=VOCAB, hidden_size=32, num_layers=1, num_heads=4,
                                intermediate_size=64, max_position_embeddings=64,
                                position_buckets=16, hidden_dropout=0.0,
                                attention_dropout=0.0)
    attn = t_deb.DisentangledSelfAttention(cfg).eval()
    seen = {}
    orig = torch.softmax

    def spy(x, dim):
        out = orig(x, dim=dim)
        seen["probs"] = out
        return out

    h = torch.randn(1, 6, 32)
    m = torch.tensor([[1, 1, 1, 1, 0, 0]]).bool()
    qk = m[:, None, None, :] & m[:, None, :, None]
    rel = torch.randn(32, 32)
    rel_pos = t_deb.build_relative_position(6, 6, 16, 64)
    torch.softmax = spy
    try:
        attn(h, qk, rel, rel_pos)
    finally:
        torch.softmax = orig
    probs = seen["probs"][0]
    torch.testing.assert_close(probs[:, 4:], torch.full_like(probs[:, 4:], 1 / 6))
    assert float(probs[:, :4, 4:].abs().max()) == 0.0


@pytest.mark.parametrize("bucket,max_pos", [(256, 512), (16, 64), (8, 16)])
def test_log_buckets_exact(bucket, max_pos):
    """``make_log_bucket_position`` equals the JAX fp32 ``ceil`` formula on
    every distance in [-1024, 1024], and ``build_relative_position`` its
    grid."""
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import deberta as j_deb

    rel = np.arange(-1024, 1025, dtype=np.int32)
    got = t_deb.make_log_bucket_position(torch.from_numpy(rel), bucket, max_pos).numpy()
    want = np.asarray(j_deb.make_log_bucket_position(jnp.asarray(rel), bucket, max_pos))
    np.testing.assert_array_equal(got, want)
    grid = t_deb.build_relative_position(40, 40, bucket, max_pos).numpy()
    np.testing.assert_array_equal(grid, np.asarray(
        j_deb.build_relative_position(40, 40, bucket, max_pos)))


def test_config_builders_match_jax():
    """Every field of the port's config equals the JAX builder's, the
    hub's string ``pos_att_type`` split the same way; an even conv kernel
    raises (SAME padding has no symmetric ``Conv1d`` form); the exported
    config.json is the JAX package's."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto

    for hf in CONFIGS.values():
        want = j_auto.CONFIG_BUILDERS["deberta-v2"](hf)
        got = t_auto.CONFIG_BUILDERS["deberta-v2"](hf)
        for field in type(got).__dataclass_fields__:
            if field not in ("dtype", "param_dtype"):
                assert getattr(got, field) == getattr(want, field), field
        assert t_auto.HF_CONFIG_EXPORTERS["deberta-v2"](got) == \
            j_auto._HF_CONFIG_EXPORTERS["deberta-v2"](want)
    assert t_auto.detect_family({"model_type": "deberta-v2"}) == "deberta-v2"
    with pytest.raises(ValueError, match="odd kernel"):
        t_auto.CONFIG_BUILDERS["deberta-v2"](_hf(conv_kernel_size=4))


@pytest.mark.parametrize("task", ["seq-cls", "mlm"])
def test_exports_read_across_packages(tmp_path, task):
    """The port's export loads in the JAX ``from_pretrained`` to the port's
    logits, the JAX package's export loads in the port's to the JAX logits,
    and the port's own reload is bit for bit."""
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto

    hf = CONFIGS["v2-conv"]
    jmodel, params, model = _pair(tmp_path, hf, task=task)
    ids, mask, _ = _inputs()
    t_auto.save_pretrained(str(tmp_path / "port"), model, "deberta-v2", model.config)
    jm2, jp2, fam, _ = j_auto.from_pretrained(str(tmp_path / "port"), task=task)
    assert fam == "deberta-v2"
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    _close(ours, jm2.apply({"params": jp2}, jnp.asarray(ids), jnp.asarray(mask)))
    reloaded, _, _ = t_auto.from_pretrained(str(tmp_path / "port"), task=task, device="cpu")
    with torch.no_grad():
        assert np.array_equal(reloaded.eval()(torch.from_numpy(ids),
                                              torch.from_numpy(mask)).numpy(), ours)
    _, jcfg = j_auto.from_pretrained(_dir(tmp_path, "j", hf), task=task)[2:]
    j_auto.save_pretrained(str(tmp_path / "jax"), params, "deberta-v2", jcfg)
    back, _, _ = t_auto.from_pretrained(str(tmp_path / "jax"), task=task, device="cpu")
    with torch.no_grad():
        got = back.eval()(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    _close(got, jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))


def test_non_legacy_mlm_rejected(tmp_path):
    path = _dir(tmp_path, "nl", _hf(legacy=False))
    with pytest.raises(ValueError, match="non-legacy"):
        t_auto.from_pretrained(path, task="mlm", device="cpu")
    # the seq-cls head of the same checkpoint loads
    t_auto.from_pretrained(path, task="seq-cls", device="cpu")


def test_fused_mlm_loss_matches_jax_fused_loss(tmp_path):
    """The port's sparse-gather fused MLM loss (K2's plain versions here)
    against the JAX fused loss with its Pallas kernels in interpret mode, at
    hidden 128: the same sums and the same gradient of every parameter, and
    the port's unfused loss within 1e-5 of its fused one."""
    import jax
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.train.trainer import (
        make_fused_mlm_loss as jax_fused_mlm,
    )

    hf = _hf(hidden_size=128, intermediate_size=256, vocab_size=300)
    jmodel, params, model = _pair(tmp_path, hf, task="mlm")
    texts, _ = t_src.synthetic_text_classification(8, seed=4)
    ds = t_pipe.ArrayDataset.from_mlm_texts(t_tok.WordHashTokenizer(300), texts, 32, seed=3)
    batch = ds[np.arange(8)]

    def f(p):
        return jax_fused_mlm(jmodel, interpret=True)(
            jmodel.apply, p, {k: jnp.asarray(v) for k, v in batch.items()}, {}, True)

    (want, jsums), jgrads = jax.value_and_grad(f, has_aux=True)(params)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, sums = t_trainer.make_fused_mlm_loss(0.25)(model.train(), tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for key in ("loss_sum", "correct", "count", "ce_dropped"):
        np.testing.assert_allclose(float(sums[key]), float(jsums[key]), rtol=1e-5)
    grads = params_from_jax(_flat(jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    with torch.no_grad():
        plain, _ = t_trainer.TASK_LOSSES["mlm"](model, tb)
    np.testing.assert_allclose(plain.item(), loss.item(), rtol=1e-5)


@pytest.mark.parametrize("task", ["seq-cls", "mlm"])
def test_five_fp32_steps_match_jax_trainer(tmp_path, task):
    """Same weights, same batches, AdamW with decay and clipping: the
    port's DeBERTa loss curve (v2 conv config; MLM through the fused loss
    against the JAX fused loss in interpret mode at hidden 128) is the JAX
    Trainer's within 1e-5."""
    import jax
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.train import Trainer as JaxTrainer
    from huggingface_sagemaker_tensorflow_distributed_tpu.train.trainer import (
        make_fused_mlm_loss as jax_fused_mlm,
    )

    fused = task == "mlm"
    hf = dict(CONFIGS["v2-conv"], hidden_size=128, intermediate_size=256, vocab_size=300)
    kw = dict(task=task, fused_vocab_ce=fused, epochs=1, dtype="float32",
              learning_rate=1e-3, scale_lr_by_world_size=False, weight_decay=0.01,
              max_grad_norm=1.0, log_every_steps=0)
    jmodel, params, model = _pair(tmp_path, hf, task=task, perturb=False)
    texts, labels = t_src.synthetic_text_classification(48, seed=5)
    tok = t_tok.WordHashTokenizer(300)
    ds = (t_pipe.ArrayDataset.from_mlm_texts(tok, texts, 32, seed=1) if fused
          else t_pipe.ArrayDataset.from_texts(tok, texts, labels, max_length=32))
    batches = list(t_pipe.ShardedBatcher(ds, 8, seed=0, native=False).local_batches(0))[:5]
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jtrainer = JaxTrainer(TrainConfig(**kw), jmodel, params, mesh, total_steps=5)
    if fused:
        jtrainer.loss_fn = jax_fused_mlm(jmodel, interpret=True)
    trainer = t_trainer.Trainer(t_config.TrainConfig(**kw), model, total_steps=5)
    want, got = [], []
    for b in batches:
        jtrainer.state, m = jtrainer._train_step(jtrainer.state,
                                                 {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(jax.device_get(m["loss"])))
        got.append(trainer.train_step({k: torch.from_numpy(v).long() if k != "valid"
                                       else torch.from_numpy(v)
                                       for k, v in b.items()})["loss"].item())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert len(set(np.round(want, 6))) == 5


@pytest.mark.parametrize("task", ["seq-cls", "mlm"])
def test_flops_per_token_match_jax(task):
    """DeBERTa-v3-base widths: the port's model FLOPs per token are the JAX
    accounting's within 1e-12, for a LoRA run too (adapters add none)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import flops as j_flops

    hf = _hf(vocab_size=128100, hidden_size=768, num_hidden_layers=12,
             num_attention_heads=12, intermediate_size=3072, max_position_embeddings=512,
             position_buckets=256)
    got = t_flops.trainer_flops_per_token(t_auto.CONFIG_BUILDERS["deberta-v2"](hf), task, 512)
    want = j_flops.trainer_flops_per_token(j_auto.CONFIG_BUILDERS["deberta-v2"](hf), task, 512)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert got[0] > 0


def test_cli_trains_deberta_and_its_export_reloads(tmp_path):
    """The training CLI on a tiny DeBERTa (seq-cls, then fused MLM): finite
    losses, the export reloads through ``from_pretrained`` to the trained
    model's logits bit for bit."""
    path = _dir(tmp_path, "cfg", _hf(position_buckets=8, max_position_embeddings=64))
    for task, extra in (("seq-cls", []), ("mlm", ["--fused_vocab_ce", "true"])):
        out = tmp_path / task
        results, trainer = cli.run([
            "--model_name_or_path", path, "--from_scratch", "true", "--task", task,
            "--dataset", "vendored_reviews", "--max_seq_length", "64", "--epochs", "1",
            "--steps_per_epoch", "3", "--max_eval_samples", "8", "--dtype", "float32",
            "--device", "cpu", "--output_data_dir", str(out / "o"), "--model_dir",
            str(out / "m"), "--log_every_steps", "0", *extra])
        assert np.isfinite(results["eval"]["eval_loss"])
        reloaded, fam, _ = t_auto.from_pretrained(str(out / "m"), task=task, device="cpu")
        ids = torch.from_numpy(np.random.RandomState(0).randint(4, VOCAB, (2, 64)))
        with torch.no_grad():
            assert fam == "deberta-v2"
            assert torch.equal(reloaded.eval()(ids), trainer.model.eval()(ids))
