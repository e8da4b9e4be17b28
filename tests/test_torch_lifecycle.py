"""PyTorch port: ``Trainer.fit``'s lifecycle against the JAX ``Trainer``.

- Interrupted and resumed runs of both trainers (the JAX one with its
  orbax ``Checkpointer``), from the same weights (carried across by
  ``models/convert.py``) on the same batches: their per-step losses agree
  within 1e-5 relative (fp32; the two frameworks sum in other orders).
  Dropout is 0: random streams cannot match across frameworks.
- ``keep_best`` and ``early_stopping_patience`` on the scripted eval
  losses of the JAX package's own tests: the same ``eval_loss`` history,
  best epoch and stop epoch as the JAX trainer; the live model and the
  export equal the best epoch's weights bit for bit.
- The CLI: a rerun of an interrupted command resumes ("resuming from
  epoch N")."""

import json

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import config as t_config
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import pipeline as t_pipe
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import sources as t_src
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import tokenization as t_tok
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import layers as t_layers
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.bert import (
    BertForSequenceClassification,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
    params_from_jax,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.checkpoint import (
    Checkpointer,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer

TINY = dict(vocab_size=512, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=32,
            hidden_dropout=0.0, attention_dropout=0.0)
SEQ = 32


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


@pytest.fixture
def _jax_telemetry_off():
    """The JAX trainer runs with its telemetry off (an earlier test in the
    worker may have left it configured): it then installs no compile
    tracker."""
    from huggingface_sagemaker_tensorflow_distributed_tpu import obs as jax_obs

    jax_obs.reset(enabled=False)
    yield
    jax_obs.reset()


def _jax_model_and_port(seed=0):
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.auto import init_params
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.bert import (
        BertForSequenceClassification as JaxBert,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.layers import (
        EncoderConfig as JaxConfig,
    )

    jmodel = JaxBert(JaxConfig(dtype=jnp.float32, **TINY), num_labels=2)
    params = init_params(jmodel, seed=seed)
    model = BertForSequenceClassification(t_layers.EncoderConfig(**TINY), num_labels=2)
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    model.load_state_dict(params_from_jax(flat), strict=True)
    return jmodel, params, model


def _texts(n=40, seed=1):
    return t_src.synthetic_text_classification(n, seed=seed)


def _mesh():
    import jax

    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )

    return build_mesh(MeshConfig(), devices=jax.devices()[:1])


class _Stop(Exception):
    """The injected interruption."""


# -- interrupted and resumed, against the JAX trainer and orbax -----------------

RESUME_KW = dict(epochs=2, dtype="float32", learning_rate=1e-3, scale_lr_by_world_size=False,
                 weight_decay=0.01, max_grad_norm=1.0, warmup_ratio=0.2, lr_schedule="cosine",
                 log_every_steps=0, checkpoint_every_steps=3)
STOP_AFTER = 4          # micro-steps before the interruption; the last save is at 3


def _jax_resumed_losses(tmp_path):
    import jax

    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import (
        ArrayDataset,
        ShardedBatcher,
        WordHashTokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.train import Trainer as JaxTrainer
    from huggingface_sagemaker_tensorflow_distributed_tpu.train.checkpoint import (
        Checkpointer as JaxCheckpointer,
    )

    jmodel, params, _ = _jax_model_and_port(seed=5)
    texts, labels = _texts()
    mesh = _mesh()
    ds = ArrayDataset.from_texts(WordHashTokenizer(512), texts, labels, SEQ)
    cfg = TrainConfig(**RESUME_KW)
    losses = []

    def recorded(trainer, stop_after=None):
        step = trainer._train_step

        def run(state, batch):
            if stop_after is not None and len(losses) == stop_after:
                raise _Stop
            state, m = step(state, batch)
            losses.append(float(jax.device_get(m["loss"])))
            return state, m
        trainer._train_step = run

    first = JaxTrainer(cfg, jmodel, params, mesh, total_steps=10)
    recorded(first, STOP_AFTER)
    ckpt = JaxCheckpointer(str(tmp_path / "jax"), async_save=False)
    with pytest.raises(_Stop):
        first.fit(ShardedBatcher(ds, 8, mesh, shuffle=True, seed=2), checkpointer=ckpt)
    ckpt.close()
    _, params, _ = _jax_model_and_port(seed=5)      # the first fit donated its buffers
    resumed = JaxTrainer(cfg, jmodel, params, mesh, total_steps=10)
    ckpt = JaxCheckpointer(str(tmp_path / "jax"), async_save=False)
    resumed.state, epoch, step_in_epoch = ckpt.restore(resumed.state)
    recorded(resumed)
    resumed.fit(ShardedBatcher(ds, 8, mesh, shuffle=True, seed=2), checkpointer=ckpt,
                start_epoch=epoch, start_step_in_epoch=step_in_epoch)
    ckpt.close()
    return losses, (epoch, step_in_epoch)


def _port_resumed_losses(tmp_path):
    _, _, model = _jax_model_and_port(seed=5)
    texts, labels = _texts()
    ds = t_pipe.ArrayDataset.from_texts(t_tok.WordHashTokenizer(512), texts, labels, SEQ)
    cfg = t_config.TrainConfig(**RESUME_KW)
    losses = []

    def recorded(trainer, stop_after=None):
        step = trainer.train_step

        def run(batch):
            if stop_after is not None and len(losses) == stop_after:
                raise _Stop
            out = step(batch)
            losses.append(out["loss"].item())
            return out
        trainer.train_step = run

    initial = {k: v.clone() for k, v in model.state_dict().items()}
    first = Trainer(cfg, model, total_steps=10)
    recorded(first, STOP_AFTER)
    ckpt = Checkpointer(str(tmp_path / "port"))
    with pytest.raises(_Stop):
        first.fit(t_pipe.ShardedBatcher(ds, 8, seed=2), checkpointer=ckpt)
    ckpt.close()
    fresh = BertForSequenceClassification(t_layers.EncoderConfig(**TINY), num_labels=2)
    fresh.load_state_dict(initial)
    resumed = Trainer(cfg, fresh, total_steps=10)
    ckpt = Checkpointer(str(tmp_path / "port"))
    state, epoch, step_in_epoch = ckpt.restore()
    resumed.load_state_dict(state)
    recorded(resumed)
    resumed.fit(t_pipe.ShardedBatcher(ds, 8, seed=2), checkpointer=ckpt,
                start_epoch=epoch, start_step_in_epoch=step_in_epoch)
    ckpt.close()
    return losses, (epoch, step_in_epoch)


def test_resumed_loss_curve_matches_jax_trainer(tmp_path, _jax_telemetry_off):
    """Both trainers stop after micro-step 4 (the last save at 3), restore
    and finish two epochs of 5 steps: 4 + 7 losses each."""
    want, want_pos = _jax_resumed_losses(tmp_path)
    got, got_pos = _port_resumed_losses(tmp_path)
    assert got_pos == want_pos == (0, 3)
    assert len(got) == len(want) == STOP_AFTER + 7
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[3] == got[4]      # the replayed step 3 repeats bit for bit


# -- keep-best and early stopping (JAX tests/test_trainer.py's scripts) --------

def _scripted_fits(cfg_kw, script, tmp_path):
    """The JAX and the port trainer on the same data with ``evaluate``
    replaced by ``script``; the port's fit also captures its weights at
    every eval."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import (
        ArrayDataset,
        ShardedBatcher,
        WordHashTokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.train import Trainer as JaxTrainer

    jmodel, params, model = _jax_model_and_port(seed=0)
    texts, labels = _texts(64, seed=3)
    kw = dict(task="seq-cls", dtype="float32", learning_rate=1e-3,
              scale_lr_by_world_size=False, log_every_steps=0, **cfg_kw)
    mesh = _mesh()
    jt = JaxTrainer(TrainConfig(**kw), jmodel, params, mesh)
    jscript = iter(script)
    jt.evaluate = lambda b: (lambda v: {"eval_loss": v, "eval_accuracy": 1 - v})(next(jscript))
    jhist = jt.fit(ShardedBatcher(ArrayDataset.from_texts(WordHashTokenizer(512), texts,
                                                          labels, SEQ),
                                  16, mesh, shuffle=True, seed=0), eval_batcher=object())

    trainer = Trainer(t_config.TrainConfig(**kw), model)
    pscript, captured = iter(script), []

    def fake_evaluate(batcher):
        captured.append({k: v.detach().clone() for k, v in model.state_dict().items()})
        loss = next(pscript)
        return {"eval_loss": loss, "eval_accuracy": 1 - loss}

    trainer.evaluate = fake_evaluate
    hist = trainer.fit(t_pipe.ShardedBatcher(
        t_pipe.ArrayDataset.from_texts(t_tok.WordHashTokenizer(512), texts, labels, SEQ),
        16, seed=0), eval_batcher=object())
    return (jt, jhist), (trainer, hist), captured


def _assert_live_and_export_equal(trainer, best, tmp_path):
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, best[k]), k
    auto.save_pretrained(str(tmp_path / "export"), trainer.model, "bert",
                         trainer.model.config)
    reloaded, _, _ = auto.from_pretrained(str(tmp_path / "export"), num_labels=2,
                                          dtype=torch.float32, device="cpu")
    for k, v in reloaded.state_dict().items():
        assert torch.equal(v, best[k]), k


def test_keep_best_matches_jax_and_exports_the_best_epoch(tmp_path, _jax_telemetry_off):
    (jt, jhist), (trainer, hist), captured = _scripted_fits(
        dict(epochs=3, keep_best=True), [0.5, 0.2, 0.9], tmp_path)
    assert hist["eval_loss"] == jhist["eval_loss"] == [0.5, 0.2, 0.9]
    assert hist["eval_accuracy"] == jhist["eval_accuracy"]
    assert trainer.best_epoch == jt.best_epoch == 1
    best, last = captured[1], captured[2]
    assert any(not torch.equal(best[k], last[k]) for k in best)
    _assert_live_and_export_equal(trainer, best, tmp_path)


def test_early_stopping_matches_jax(tmp_path, _jax_telemetry_off):
    script = [0.5, 0.2, 0.4, 0.3] + [0.9] * 6
    (jt, jhist), (trainer, hist), captured = _scripted_fits(
        dict(epochs=10, keep_best=True, early_stopping_patience=2), script, tmp_path)
    # best at epoch 1 (0.2); epochs 2 and 3 do not improve: stop after 3
    assert hist["eval_loss"] == jhist["eval_loss"] == [0.5, 0.2, 0.4, 0.3]
    assert trainer.best_epoch == jt.best_epoch == 1
    assert len(hist["loss"]) == len(jhist["loss"]) == 4 and trainer.step == 16
    _assert_live_and_export_equal(trainer, captured[1], tmp_path)


# -- the CLI ---------------------------------------------------------------------

def _tiny_model_dir(path):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps({
        "model_type": "bert", "vocab_size": 512, "hidden_size": 32,
        "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 64,
        "max_position_embeddings": SEQ}))
    return str(path)


def test_cli_rerun_resumes_and_keeps_the_best_epoch(tmp_path, capsys):
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli

    argv = ["--device", "cpu", "--model_name_or_path", _tiny_model_dir(tmp_path / "cfg"),
            "--from_scratch", "true", "--dataset", "vendored_reviews",
            "--max_train_samples", "48", "--max_eval_samples", "8",
            "--train_batch_size", "8", "--eval_batch_size", "4", "--dtype", "float32",
            "--max_seq_length", str(SEQ), "--log_every_steps", "0",
            "--checkpoint_dir", str(tmp_path / "ck"), "--checkpoint_every_steps", "4",
            "--keep_checkpoints", "2", "--keep_best", "true",
            "--output_data_dir", str(tmp_path / "out"), "--model_dir", str(tmp_path / "model")]
    res, trainer = cli.run(argv + ["--epochs", "1"])
    assert trainer.step == 6 and trainer.best_epoch == 0
    assert sorted((tmp_path / "ck").iterdir())[-1].name == "6"
    capsys.readouterr()
    res, trainer = cli.run(argv + ["--epochs", "2"])
    out = capsys.readouterr().out
    assert "resuming from epoch 1 (step-in-epoch 0)" in out
    assert "exporting best epoch 1" in out
    assert trainer.step == 12 and len(res["train"]["loss"]) == 1
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["10", "12"]
