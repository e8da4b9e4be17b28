"""PyTorch port: LoRA (``models/lora.py``, the trainer's frozen base and
adapter-only optimizer, keep-best, resume, the merged export and the
adapter sidecar of ``train/cli.py``) against the JAX package on the same
weights (carried across with ``params_from_jax``) and the same adapters
(``lora_from_jax``). Mirrors the JAX ``tests/test_lora.py`` but its TP-mesh
test (ROADMAP queue 1, item 11).

Tolerances: the zero-init merge and a frozen base bit for bit; the merged
kernels 1e-6 of the JAX merge (one fp32 product of small factors); logits
1e-5 (fp32 through two layers in two frameworks); 5-step fp32 loss curves
1e-5 relative of the JAX ``Trainer``'s; accumulation against the big batch
1e-5 absolute / 1e-4 relative (the JAX test's); the fused and unfused
first losses 2e-5 relative (the JAX test's); resumed losses and weights
exact."""

import json
import re

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import config as t_config
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import pipeline as t_pipe
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import sources as t_src
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import tokenization as t_tok
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto as t_auto
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import bert as t_bert
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import gpt2 as t_gpt2
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import layers as t_layers
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import lora as t_lora
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
    lora_from_jax,
    params_from_jax,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import trainer as t_trainer
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.checkpoint import (
    Checkpointer,
)

SEQ = 16
BERT = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=SEQ, hidden_dropout=0.0,
            attention_dropout=0.0)
GPT2 = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4,
            intermediate_size=256, max_position_embeddings=SEQ, hidden_dropout=0.0,
            embd_dropout=0.0, attention_dropout=0.0)


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


def _bert_pair(seed=0, **kw):
    """(JAX model, JAX params, port model): a tiny BERT seq-cls on the same
    weights."""
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.auto import init_params
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.bert import (
        BertForSequenceClassification,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.layers import (
        EncoderConfig,
    )

    cfg = {**BERT, **kw}
    jmodel = BertForSequenceClassification(EncoderConfig(**cfg), num_labels=2)
    params = init_params(jmodel, EncoderConfig(**cfg), seed=seed)
    model = t_bert.BertForSequenceClassification(t_layers.EncoderConfig(**cfg))
    model.load_state_dict(params_from_jax(_flat(params)), strict=True)
    return jmodel, params, model


def _gpt2_pair(seed=0):
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.auto import init_params
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.gpt2 import (
        Gpt2Config,
        Gpt2LMHeadModel,
    )

    jmodel = Gpt2LMHeadModel(Gpt2Config(dtype=jnp.float32, **GPT2))
    params = init_params(jmodel, seed=seed)
    model = t_gpt2.Gpt2LMHeadModel(t_gpt2.Gpt2Config(**GPT2))
    model.load_state_dict(params_from_jax(_flat(params)), strict=True)
    return jmodel, params, model


def _flat(tree):
    import jax
    from flax.traverse_util import flatten_dict

    return {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(tree), sep="/").items()}


def _cls_dataset(n=64, seed=0):
    texts, labels = t_src.synthetic_text_classification(n, seed=seed)
    return t_pipe.ArrayDataset.from_texts(t_tok.WordHashTokenizer(vocab_size=256), texts,
                                          labels, max_length=SEQ)


def _torch(batch):
    return {k: torch.from_numpy(v).long() if k != "valid" else torch.from_numpy(v)
            for k, v in batch.items()}


def _config(**kw):
    base = dict(task="seq-cls", dtype="float32", learning_rate=2e-2,
                scale_lr_by_world_size=False, log_every_steps=0, lora_rank=4)
    return t_config.TrainConfig(**{**base, **kw})


# -- the adapter module ------------------------------------------------------------

def test_zero_init_delta_is_identity():
    """B starts at zero: the merge of fresh adapters is the base bit for
    bit, and so is the attached model's forward."""
    _, _, model = _bert_pair()
    ids = torch.from_numpy(np.random.RandomState(0).randint(4, 256, (3, SEQ)))
    with torch.no_grad():
        base = model.eval()(ids)
    lora = t_lora.init_lora_params(model, rank=4, targets="attention", seed=0)
    merged = t_lora.merge_lora(model, lora, scaling=2.0)
    for name, value in model.state_dict().items():
        assert torch.equal(merged[name], value), name
    t_lora.attach_lora(model, lora, 2.0)
    with torch.no_grad():
        assert torch.equal(model(ids), base)
    a = lora["backbone/encoder/layer_0/attention/query/kernel"]["a"]
    assert a.shape == (32, 4) and a.dtype == torch.float32
    assert 0.5 < float(a.std() * np.sqrt(32)) < 1.5


@pytest.mark.parametrize("targets", ["attention", "mlp", "all",
                                     r"layer_1/attention/(query|value)/kernel$"])
@pytest.mark.parametrize("family", ["bert", "gpt2", "deberta"])
def test_targeting_selects_the_jax_kernels(family, targets):
    """A preset or a custom regex picks the same kernels by JAX path in both
    packages, with the JAX factor shapes; a regex matching nothing raises the
    JAX ``ValueError``."""
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import lora as j_lora

    if family == "bert":
        _, params, model = _bert_pair()
    elif family == "gpt2":
        _, params, model = _gpt2_pair()
    else:
        params, model = _deberta_pair()
    if family == "gpt2" and "query" in targets:
        targets = r"h_1/attention/qkv/kernel$"
    want = flatten_dict(j_lora.init_lora_params(params, 4, targets))
    got = t_lora.init_lora_params(model, 4, targets)
    assert sorted(got) == sorted({"/".join(k[:-1]) for k in want})
    for path, ab in got.items():
        for part in ("a", "b"):
            assert tuple(ab[part].shape) == tuple(want[tuple(path.split("/")) + (part,)].shape)
    with pytest.raises(ValueError, match="matched no kernels"):
        t_lora.init_lora_params(model, 4, r"nonexistent_module_xyz")


def _deberta_pair():
    from flax.traverse_util import flatten_dict  # noqa: F401

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.auto import init_params
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.deberta import (
        DebertaV2Config,
        DebertaV2ForSequenceClassification,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import deberta as t_deb

    kw = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position_embeddings=SEQ, position_buckets=8,
              share_att_key=False, conv_kernel_size=3, hidden_dropout=0.0,
              attention_dropout=0.0)
    cfg = DebertaV2Config(**kw)
    params = init_params(DebertaV2ForSequenceClassification(cfg, num_labels=2), cfg)
    model = t_deb.DebertaV2ForSequenceClassification(t_deb.DebertaV2Config(**kw))
    model.load_state_dict(params_from_jax(_flat(params)), strict=True)
    return params, model


def test_merge_matches_jax_and_changes_only_targets():
    """With nonzero adapters carried across (``lora_from_jax``), the port's
    merged kernels are the JAX ``merge_lora``'s within 1e-6, the rest are
    untouched, and the attached model's logits are the JAX merged model's."""
    import jax
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import lora as j_lora

    jmodel, params, model = _bert_pair()
    lora = jax.tree.map(lambda x: x + 0.01, j_lora.init_lora_params(params, 4, "attention"))
    ours = lora_from_jax(jax.device_get(lora))
    merged = t_lora.merge_lora(model, ours, 2.0)
    want = params_from_jax(_flat(j_lora.merge_lora(params, lora, 2.0)))
    base = model.state_dict()
    targets = {n for n, p in t_lora.jax_param_paths(model).items() if p in ours}
    assert len(targets) == 8
    for name, value in want.items():
        torch.testing.assert_close(merged[name], value, rtol=0, atol=1e-6)
        assert torch.equal(merged[name], base[name]) == (name not in targets), name
    t_lora.attach_lora(model, ours, 2.0)
    ids = np.random.RandomState(1).randint(4, 256, (3, SEQ))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(ids))
    ref = jmodel.apply({"params": j_lora.merge_lora(params, lora, 2.0)}, jnp.asarray(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    t_lora.attach_lora(model, None)
    with torch.no_grad():
        assert not torch.equal(model(torch.from_numpy(ids)), got)


def test_sidecar_reads_across_packages(tmp_path):
    """The port's ``adapter.safetensors`` + ``adapter_config.json`` is what
    the JAX ``load_adapters`` reads (names, layouts, values, config), and the
    port reads the JAX package's sidecar."""
    import jax

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import lora as j_lora

    _, params, model = _bert_pair()
    ours = t_lora.init_lora_params(model, 4, "attention", seed=3)
    ours = {p: {k: v + 0.5 for k, v in ab.items()} for p, ab in ours.items()}
    t_lora.save_adapters(str(tmp_path / "port"), ours, rank=4, alpha=16.0,
                         targets="attention")
    tree, meta = j_lora.load_adapters(str(tmp_path / "port"))
    assert meta == {"lora_rank": 4, "lora_alpha": 16.0, "lora_targets": "attention"}
    got = lora_from_jax(jax.device_get(tree))
    assert sorted(got) == sorted(ours)
    for p, ab in ours.items():
        for k, v in ab.items():
            assert torch.equal(got[p][k], v), (p, k)
    jlora = j_lora.init_lora_params(params, 4, "attention", seed=1)
    j_lora.save_adapters(str(tmp_path / "jax"), jax.device_get(jlora), rank=4, alpha=8.0,
                         targets="attention")
    back, meta = t_lora.load_adapters(str(tmp_path / "jax"))
    assert meta == {"lora_rank": 4, "lora_alpha": 8.0, "lora_targets": "attention"}
    want = lora_from_jax(jax.device_get(jlora))
    assert sorted(back) == sorted(want)
    for p, ab in want.items():
        for k, v in ab.items():
            assert torch.equal(back[p][k], v), (p, k)


# -- the trainer ---------------------------------------------------------------------

def _fit(epochs=3, seed=0, **kw):
    _, _, model = _bert_pair(seed=seed)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = t_trainer.Trainer(_config(epochs=epochs, **kw), model)
    hist = trainer.fit(t_pipe.ShardedBatcher(_cls_dataset(), 16, shuffle=True, seed=0,
                                             native=False))
    return trainer, before, hist


def test_lora_trains_and_base_stays_frozen():
    """Only the adapters and the heads ``lora_train_heads`` matches move:
    every other base tensor is bit-identical to its initial value and never
    holds a gradient; the merged export differs from the base on targeted
    kernels only."""
    trainer, before, hist = _fit(epochs=8)
    assert min(hist["loss"]) < hist["loss"][0] - 0.02
    rx = re.compile(t_lora.HEAD_REGEX_DEFAULT)
    paths = t_lora.jax_param_paths(trainer.model)
    head_moved = False
    for name, p in trainer.model.named_parameters():
        if rx.search(paths[name]):
            assert p.requires_grad
            head_moved = head_moved or not torch.equal(p.detach(), before[name])
        else:
            assert not p.requires_grad and p.grad is None, name
            assert torch.equal(p.detach(), before[name]), name
    assert head_moved
    assert any(float(ab["b"].detach().abs().max()) > 0 for ab in trainer.lora.values())
    merged = trainer.export_params
    targets = {n for n, p in paths.items() if p in trainer.lora}
    for name in before:
        if name in targets:
            assert not torch.equal(merged[name], before[name]), name
        elif not rx.search(paths[name]):
            assert torch.equal(merged[name], before[name]), name


def test_lora_optimizer_state_is_adapter_sized():
    """Adam's m and v exist for the adapters and heads only."""
    trainer, before, _ = _fit(epochs=1)
    n_base = sum(v.numel() for v in before.values())
    n_lora = t_lora.count_params(trainer.lora)
    n_head = sum(p.numel() for p in trainer.model.parameters() if p.requires_grad)
    n_opt = sum(v.numel() for s in trainer.optimizer.state.values() for v in s.values()
                if torch.is_tensor(v) and v.dim() > 0)
    assert n_lora + n_head < n_base // 5
    assert n_opt == 2 * (n_lora + n_head)
    assert t_lora.count_params(trainer.params) == n_lora + n_head


def test_lora_grad_accumulation_matches_big_batch():
    """accum 2 at batch 8 gives the state of one update at batch 16."""
    final = {}
    for accum, gb in ((1, 16), (2, 8)):
        _, _, model = _bert_pair()
        trainer = t_trainer.Trainer(_config(learning_rate=1e-2,
                                            gradient_accumulation_steps=accum), model)
        for b in t_pipe.ShardedBatcher(_cls_dataset(seed=7), gb, shuffle=False,
                                       native=False).local_batches(0):
            trainer.train_step(_torch(b))
        final[accum] = ({k: v.clone() for k, v in model.state_dict().items()},
                        {p: {k: v.detach().clone() for k, v in ab.items()}
                         for p, ab in trainer.lora.items()})
    for name, v in final[1][0].items():
        np.testing.assert_allclose(final[2][0][name].numpy(), v.numpy(), atol=1e-5, rtol=1e-4)
    for p, ab in final[1][1].items():
        for k, v in ab.items():
            np.testing.assert_allclose(final[2][1][p][k].numpy(), v.numpy(), atol=1e-5,
                                       rtol=1e-4)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_five_fp32_steps_match_jax_trainer(fused):
    """The JAX ``Trainer``'s own adapters carried across (``lora_from_jax``),
    the same batches, AdamW with decay and clipping: BERT seq-cls (heads
    trained) and GPT-2 causal-LM through the fused vocab CE (heads frozen,
    the JAX fused loss with its Pallas kernels in interpret mode): the
    port's loss curve is the JAX Trainer's within 1e-5."""
    import jax
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.lora import merge_lora
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.train import Trainer as JaxTrainer
    from huggingface_sagemaker_tensorflow_distributed_tpu.train.trainer import (
        make_fused_causal_lm_loss,
    )

    kw = dict(epochs=1, dtype="float32", learning_rate=1e-2, scale_lr_by_world_size=False,
              weight_decay=0.01, max_grad_norm=1.0, log_every_steps=0, lora_rank=4,
              lora_alpha=8.0)
    if fused:
        kw.update(task="causal-lm", fused_vocab_ce=True, lora_train_heads="",
                  lora_targets="all")
        jmodel, params, model = _gpt2_pair(seed=2)
        texts, _ = t_src.synthetic_text_classification(40, seed=2)
        ds = t_pipe.ArrayDataset.from_lm_texts(t_tok.WordHashTokenizer(256), texts, SEQ)
    else:
        kw.update(task="seq-cls")
        jmodel, params, model = _bert_pair(seed=2)
        ds = _cls_dataset(seed=3)
    batches = list(t_pipe.ShardedBatcher(ds, 8, seed=0, native=False).local_batches(0))[:5]
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jtrainer = JaxTrainer(TrainConfig(**kw), jmodel, params, mesh, total_steps=5)
    if fused:
        inner, scaling = make_fused_causal_lm_loss(jmodel, interpret=True), \
            jtrainer._lora_scaling

        def lora_fused(apply_fn, split, batch, rngs, train):
            merged = merge_lora(jax.lax.stop_gradient(split["model"]), split["lora"],
                                scaling)
            return inner(apply_fn, merged, batch, rngs, train)

        jtrainer.loss_fn = lora_fused
    trainer = t_trainer.Trainer(t_config.TrainConfig(**kw), model, total_steps=5)
    trainer._load_lora(lora_from_jax(jax.device_get(jtrainer.state.params["lora"])))
    want, got = [], []
    for b in batches:
        jtrainer.state, m = jtrainer._train_step(jtrainer.state,
                                                 {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(jax.device_get(m["loss"])))
        got.append(trainer.train_step(_torch(b))["loss"].item())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert len(set(np.round(want, 6))) == 5
    final = lora_from_jax(jax.device_get(jtrainer.state.params["lora"]))
    for p, ab in final.items():
        for k, v in ab.items():
            np.testing.assert_allclose(trainer.lora[p][k].detach().numpy(), v.numpy(),
                                       rtol=1e-3, atol=1e-6)


def test_lora_composes_with_fused_vocab_ce():
    """The merge happens before ``hidden_and_embedding`` sees the weights:
    GPT-2's fused and unfused first-step losses match on the same adapters."""
    texts, _ = t_src.synthetic_text_classification(16, seed=2)
    ds = t_pipe.ArrayDataset.from_lm_texts(t_tok.WordHashTokenizer(256), texts, SEQ)
    batch = _torch(next(t_pipe.ShardedBatcher(ds, 16, shuffle=False, native=False)
                        .local_batches(0)))
    losses = []
    for fused in (True, False):
        _, _, model = _gpt2_pair()
        trainer = t_trainer.Trainer(_config(task="causal-lm", learning_rate=1e-3,
                                            lora_train_heads="", fused_vocab_ce=fused),
                                    model)
        with torch.no_grad():
            for ab in trainer.lora.values():
                ab["b"].normal_(0, 0.02, generator=torch.Generator().manual_seed(5))
        losses.append(trainer.train_step(batch)["loss"].item())
    np.testing.assert_allclose(losses[0], losses[1], rtol=2e-5)


def test_lora_resume_equals_the_uninterrupted_fit_bit_for_bit(tmp_path):
    """A LoRA fit stopped after its step 3 (checkpoint at step 2) and
    resumed in a trainer built from another seed: losses, adapters and
    weights equal the uninterrupted fit's bit for bit."""
    def run(ckpt_dir, stop_after=None, seed=0, resume=False):
        _, _, model = _bert_pair(seed=seed)
        cfg = _config(epochs=2, checkpoint_dir=str(ckpt_dir), checkpoint_every_steps=2,
                      async_checkpointing=False)
        trainer = t_trainer.Trainer(cfg, model)
        ckpt = Checkpointer(str(ckpt_dir), async_save=False)
        start = (0, 0)
        if resume:
            state, epoch, step = ckpt.restore()
            trainer.load_state_dict(state)
            start = (epoch, step)
        losses = []
        orig = trainer.train_step

        def step_fn(batch):
            if stop_after is not None and len(losses) == stop_after:
                raise KeyboardInterrupt
            out = orig(batch)
            losses.append(out["loss"].item())
            return out

        trainer.train_step = step_fn
        batcher = t_pipe.ShardedBatcher(_cls_dataset(), 16, shuffle=True, seed=0,
                                        native=False)
        try:
            trainer.fit(batcher, checkpointer=ckpt, start_epoch=start[0],
                        start_step_in_epoch=start[1])
        except KeyboardInterrupt:
            pass
        ckpt.close()
        return trainer, losses

    full, want = run(tmp_path / "a")
    _, first = run(tmp_path / "b", stop_after=3)
    resumed, rest = run(tmp_path / "b", seed=9, resume=True)
    assert first == want[:3]
    assert rest == want[2:]
    for name, v in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], v), name
    for p, ab in full.lora.items():
        for k, v in ab.items():
            assert torch.equal(resumed.lora[p][k], v), (p, k)


def test_lora_keep_best_restores_adapters_and_heads(monkeypatch):
    """keep_best under LoRA snapshots the adapters and the trainable heads
    only (not the frozen base) and restores the best epoch's into the live
    model at the end; the snapshot is then released."""
    _, _, model = _bert_pair()
    trainer = t_trainer.Trainer(_config(epochs=3, keep_best=True), model)
    scripted = iter([0.5, 0.2, 0.9])
    captured = {}
    snapshots = []
    orig_snapshot = trainer._best_snapshot

    def snapshot():
        snap = orig_snapshot()
        snapshots.append(snap)
        return snap

    def fake_evaluate(batcher):
        loss = next(scripted)
        captured[loss] = ({p: {k: v.detach().clone() for k, v in ab.items()}
                           for p, ab in trainer.lora.items()},
                          {n: p.detach().clone() for n, p in model.named_parameters()})
        return {"eval_loss": loss, "eval_accuracy": 1.0 - loss}

    monkeypatch.setattr(trainer, "evaluate", fake_evaluate)
    monkeypatch.setattr(trainer, "_best_snapshot", snapshot)
    trainer.fit(t_pipe.ShardedBatcher(_cls_dataset(), 16, shuffle=True, seed=0,
                                      native=False), eval_batcher=object())
    assert trainer.best_epoch == 1
    assert set(snapshots[0]) == {"lora", "heads"}
    assert set(snapshots[0]["heads"]) == {n for n, p in model.named_parameters()
                                          if p.requires_grad}
    assert len(snapshots[0]["heads"]) == 4          # pooler and classifier
    best_lora, best_params = captured[0.2]
    for p, ab in best_lora.items():
        for k, v in ab.items():
            assert torch.equal(trainer.lora[p][k].detach(), v), (p, k)
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), best_params[n]), n
    assert trainer._best_params is None


def test_lora_config_validation_matches_jax():
    """``TrainConfig(lora_rank=8)`` builds; the invalid values raise the JAX
    ``ValueError``."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig

    assert t_config.TrainConfig(lora_rank=8).lora_rank == 8
    for kw in (dict(lora_rank=-1), dict(lora_rank=4, lora_alpha=0.0)):
        with pytest.raises(ValueError) as want:
            TrainConfig(**kw)
        with pytest.raises(ValueError) as got:
            t_config.TrainConfig(**kw)
        assert str(got.value) == str(want.value)


def test_cli_writes_the_merged_export_and_the_sidecar(tmp_path):
    """``--lora_rank`` through the CLI: the export is the merged model (it
    reloads to the live model's logits bit for bit), the sidecar sits in
    ``model_dir/adapter`` and the JAX ``load_adapters`` reads it."""
    import jax

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import lora as j_lora

    model_dir = tmp_path / "m"
    model_dir.mkdir()
    (model_dir / "config.json").write_text(json.dumps({
        "model_type": "bert", "vocab_size": 256, "hidden_size": 32,
        "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 64,
        "max_position_embeddings": 64}))
    argv = ["--model_name_or_path", str(model_dir), "--from_scratch", "true",
            "--dataset", "vendored_reviews", "--max_seq_length", "64", "--epochs", "1",
            "--steps_per_epoch", "3", "--max_eval_samples", "8", "--dtype", "float32",
            "--device", "cpu", "--lora_rank", "4", "--lora_alpha", "8",
            "--output_data_dir", str(tmp_path / "out"), "--model_dir", str(tmp_path / "x"),
            "--log_every_steps", "0"]
    results, trainer = cli.run(argv)
    assert np.isfinite(results["eval"]["eval_loss"])
    reloaded, _, _ = t_auto.from_pretrained(str(tmp_path / "x"), device="cpu")
    ids = torch.from_numpy(np.random.RandomState(0).randint(4, 256, (2, 64)))
    with torch.no_grad():
        assert torch.equal(reloaded(ids), trainer.model.eval()(ids))
    tree, meta = j_lora.load_adapters(str(tmp_path / "x" / "adapter"))
    assert meta == {"lora_rank": 4, "lora_alpha": 8.0, "lora_targets": "attention"}
    got = lora_from_jax(jax.device_get(tree))
    assert sorted(got) == sorted(trainer.lora)
    for p, ab in trainer.lora.items():
        for k, v in ab.items():
            assert torch.equal(got[p][k], v.detach()), (p, k)
