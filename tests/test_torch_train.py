"""PyTorch port: the trainer (``train/trainer.py``), the training CLI
(``train/cli.py``), data parallelism (``parallel/distributed.py``) and
``utils/`` against the JAX package: the JAX ``Trainer``'s fp32 loss curve
over 5 steps, exact padded-tail evaluation, the fit history, the JAX
CLI's results-file keys, and two gloo processes equal to one process on
the doubled batch.

Tolerance: the 5-step loss curve 1e-5 relative (fp32; the two frameworks
sum in other orders)."""

import json
import math
import multiprocessing as mp
import os
import socket

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import config as t_config
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import pipeline as t_pipe
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import sources as t_src
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import tokenization as t_tok
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import layers as t_layers
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.bert import (
    BertForSequenceClassification,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
    init_bert,
    params_from_jax,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.results import (
    read_results_file,
    write_results_file,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.timing import (
    StepMeter,
    Stopwatch,
)

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


def _dataset(n, seed=0):
    texts, labels = t_src.synthetic_text_classification(n, seed=seed)
    return texts, labels


# -- trainer -------------------------------------------------------------------

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


def _to_torch(batch):
    return {k: torch.from_numpy(v).long() if k != "valid" else torch.from_numpy(v)
            for k, v in batch.items()}


def test_five_fp32_steps_match_jax_trainer():
    """Same weights, same batches, AdamW with decay, clipping and a cosine
    warmup: the port's loss curve is the JAX Trainer's."""
    import jax
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.train import Trainer as JaxTrainer

    kw = dict(epochs=1, dtype="float32", learning_rate=1e-3, scale_lr_by_world_size=False,
              weight_decay=0.01, max_grad_norm=1.0, warmup_ratio=0.4, lr_schedule="cosine",
              log_every_steps=0)
    jmodel, params, model = _jax_model_and_port()
    texts, labels = _dataset(48, seed=1)
    ds = t_pipe.ArrayDataset.from_texts(t_tok.WordHashTokenizer(512), texts, labels, SEQ)
    batches = list(t_pipe.ShardedBatcher(ds, 8, seed=0).local_batches(0))[:5]
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jtrainer = JaxTrainer(TrainConfig(**kw), jmodel, params, mesh, total_steps=5)
    trainer = Trainer(t_config.TrainConfig(**kw), model, total_steps=5)
    want, got = [], []
    for b in batches:
        jtrainer.state, m = jtrainer._train_step(jtrainer.state,
                                                 {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(jax.device_get(m["loss"])))
        got.append(trainer.train_step(_to_torch(b))["loss"].item())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert trainer.updates == 5 and len(set(np.round(want, 6))) == 5


def test_gradient_accumulation_matches_the_doubled_batch():
    texts, labels = _dataset(16, seed=2)
    ds = t_pipe.ArrayDataset.from_texts(t_tok.WordHashTokenizer(512), texts, labels, SEQ)
    big = _to_torch(ds[np.arange(16)])
    halves = [_to_torch(ds[np.arange(8)]), _to_torch(ds[np.arange(8, 16)])]
    cfg = t_layers.EncoderConfig(**TINY)
    one = Trainer(t_config.TrainConfig(learning_rate=1e-3),
                  init_bert(cfg, seed=1, device="cpu"))
    two = Trainer(t_config.TrainConfig(learning_rate=1e-3, gradient_accumulation_steps=2),
                  init_bert(cfg, seed=1, device="cpu"))
    one.train_step(big)
    for h in halves:
        two.train_step(h)
    assert (one.updates, two.updates) == (1, 1)
    for (name, a), b in zip(one.model.named_parameters(), two.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_trainer_sets_the_schedule_lr_at_every_update():
    cfg = t_config.TrainConfig(learning_rate=1e-3, warmup_ratio=0.3, lr_schedule="cosine",
                               gradient_accumulation_steps=2)
    trainer = Trainer(cfg, init_bert(t_layers.EncoderConfig(**TINY), seed=0, device="cpu"),
                      total_steps=12)
    texts, labels = _dataset(8, seed=3)
    batch = _to_torch(t_pipe.ArrayDataset.from_texts(t_tok.WordHashTokenizer(512), texts,
                                                     labels, SEQ)[np.arange(8)])
    seen = []
    for _ in range(12):
        trainer.train_step(batch)
        if trainer.step % 2 == 0:
            seen.append(trainer.optimizer.param_groups[0]["lr"])
    assert seen == [trainer.schedule(n) for n in range(6)]
    assert seen[0] == 0.0 and max(seen) == pytest.approx(1e-3)


def test_evaluate_is_exact_over_valid_rows_and_matches_jax():
    import jax

    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import (
        ArrayDataset,
        ShardedBatcher,
        WordHashTokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.train import Trainer as JaxTrainer

    jmodel, params, model = _jax_model_and_port(seed=4)
    texts, labels = _dataset(10, seed=4)
    ds = t_pipe.ArrayDataset.from_texts(t_tok.WordHashTokenizer(512), texts, labels, SEQ)
    trainer = Trainer(t_config.TrainConfig(dtype="float32"), model)
    got = trainer.evaluate(t_pipe.ShardedBatcher(ds, 4, shuffle=False, drop_remainder=False))
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(ds.columns["input_ids"]).long(),
                              torch.from_numpy(ds.columns["attention_mask"]).long())
    lab = torch.tensor(labels)
    np.testing.assert_allclose(got["eval_loss"],
                               torch.nn.functional.cross_entropy(logits, lab).item(), rtol=1e-5)
    assert got["eval_accuracy"] == (logits.argmax(-1) == lab).float().mean().item()
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jt = JaxTrainer(TrainConfig(dtype="float32"), jmodel, params, mesh)
    want = jt.evaluate(ShardedBatcher(ArrayDataset.from_texts(WordHashTokenizer(512), texts,
                                                              labels, SEQ),
                                      4, mesh, shuffle=False, drop_remainder=False))
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=1e-5)
    assert got["eval_accuracy"] == pytest.approx(want["eval_accuracy"])


def test_fit_history_and_meter(tmp_path):
    texts, labels = _dataset(40, seed=5)
    ds = t_pipe.ArrayDataset.from_texts(t_tok.WordHashTokenizer(512), texts, labels, SEQ)
    cfg = t_config.TrainConfig(epochs=2, steps_per_epoch=3, log_every_steps=2,
                               eval_each_epoch=True, output_data_dir=str(tmp_path))
    trainer = Trainer(cfg, init_bert(t_layers.EncoderConfig(**TINY), seed=0, device="cpu"))
    hist = trainer.fit(t_pipe.ShardedBatcher(ds, 8, seed=0),
                       eval_batcher=t_pipe.ShardedBatcher(ds, 8, shuffle=False,
                                                          drop_remainder=False))
    assert list(hist) == ["loss", "sparse_categorical_accuracy", "eval_loss",
                          "eval_accuracy", "train_runtime", "train_samples_per_second",
                          "train_samples_per_second_per_chip"]
    assert len(hist["loss"]) == len(hist["eval_loss"]) == 2 and trainer.step == 6
    assert trainer.meter.excluded_steps == 1 and hist["train_samples_per_second"] > 0
    trainer.write_train_results(hist)
    assert list(read_results_file(str(tmp_path / "train_results.txt"))) == list(hist)


def test_results_meter_and_stopwatch(tmp_path):
    path = write_results_file(str(tmp_path / "o"), "r.txt", {"a": 1, "b": [0.5]})
    assert read_results_file(path) == {"a": "1", "b": "[0.5]"}
    meter = StepMeter(n_chips=2)
    meter.begin_window()
    meter.window_step(8)
    meter.exclude_step(8)                  # the first step: excluded
    meter.begin_window()
    for _ in range(3):
        meter.window_step(8)
    summary = meter.end_window()
    assert summary["steps"] == 3 and meter.excluded_steps == 1
    assert meter.end_window() is None      # no window open
    assert meter.samples_per_sec_per_chip == pytest.approx(meter.samples_per_sec / 2)
    with Stopwatch() as sw:
        pass
    assert sw.elapsed >= 0


# -- CLI and data parallelism --------------------------------------------------

def _tiny_model_dir(path):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps({
        "model_type": "bert", "vocab_size": 512, "hidden_size": 32,
        "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 64,
        "max_position_embeddings": SEQ, "hidden_dropout_prob": 0.0,
        "attention_probs_dropout_prob": 0.0}))
    return str(path)


def test_cli_on_cpu_writes_the_jax_cli_files(tmp_path):
    from scripts.train import main as jax_main

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli

    model_dir = _tiny_model_dir(tmp_path / "cfg")
    common = ["--model_name_or_path", model_dir, "--from_scratch", "true",
              "--dataset", "vendored_reviews", "--max_train_samples", "48",
              "--max_eval_samples", "10", "--epochs", "1", "--train_batch_size", "2",
              "--eval_batch_size", "2", "--dtype", "float32", "--log_every_steps", "0",
              "--max_seq_length", str(SEQ)]
    outs = {}
    for name, run in (("port", lambda a: cli.main(a + ["--device", "cpu"])),
                      ("jax", jax_main)):
        out, mdir = tmp_path / name / "out", tmp_path / name / "model"
        res = run(common + ["--output_data_dir", str(out), "--model_dir", str(mdir)])
        outs[name] = (out, mdir, res)
    for fname in ("train_results.txt", "eval_results.txt"):
        got = read_results_file(str(outs["port"][0] / fname))
        want = read_results_file(str(outs["jax"][0] / fname))
        assert list(got) == list(want), fname
    assert sorted(p.name for p in outs["port"][1].iterdir()) == \
        sorted(p.name for p in outs["jax"][1].iterdir())
    res = outs["port"][2]
    assert math.isfinite(res["eval"]["eval_loss"]) and len(res["train"]["loss"]) == 1


def test_cli_defaults_to_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli

    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--model_name_or_path", _tiny_model_dir(tmp_path)])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_worker(rank, world, port, steps, out_path):
    """One data-parallel rank: its share of each global batch of 8."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank))
    torch.set_num_threads(1)
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )

    initialize_distributed("cpu")
    try:
        losses, params = _dp_run(steps)
        torch.save({"losses": losses, "params": params}, out_path)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def _dp_run(steps):
    texts, labels = _dataset(40, seed=6)
    ds = t_pipe.ArrayDataset.from_texts(t_tok.WordHashTokenizer(512), texts, labels, SEQ)
    cfg = t_config.TrainConfig(learning_rate=1e-3, scale_lr_by_world_size=False,
                               max_grad_norm=1.0)
    trainer = Trainer(cfg, init_bert(t_layers.EncoderConfig(**TINY), seed=2, device="cpu"))
    losses = []
    for i, batch in enumerate(t_pipe.ShardedBatcher(ds, 8, seed=3).global_arrays(0)):
        if i == steps:
            break
        losses.append(trainer.train_step(batch)["loss"].item())
    return losses, {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def test_two_gloo_processes_match_one_process(tmp_path):
    """Two ranks on halves of each global batch (a mean all-reduce of the
    gradients) take the same steps as one process on the whole batch."""
    steps = 3
    want_losses, want_params = _dp_run(steps)
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_dp_worker, args=(r, 2, port, steps, str(tmp_path / f"{r}.pt")))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs)
    ranks = [torch.load(str(tmp_path / f"{r}.pt")) for r in range(2)]
    np.testing.assert_allclose(np.mean([r["losses"] for r in ranks], axis=0), want_losses,
                               rtol=1e-5)
    for key, value in want_params.items():
        for r in ranks:
            np.testing.assert_allclose(r["params"][key].numpy(), value.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=key)
