"""PyTorch port: checkpoint/resume (``train/checkpoint.py``), the mid-epoch
data position (``data/pipeline.py``) and the replica-divergence check
(``parallel/collectives.py``).

A resumed fit must equal an uninterrupted one bit for bit on the CPU (no
tolerance): at an epoch boundary, mid-epoch, on a mid-epoch checkpoint
that lands on the epoch boundary, and between gradient-accumulation
micro-steps. Dropout is on (0.1) in those runs, so the generator states
are restored too. The mid-epoch batches equal the JAX
``ShardedBatcher.local_batches(epoch, start_step)`` exactly."""

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
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import init_bert
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.collectives import (
    ReplicaDivergenceError,
    replica_divergence,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.checkpoint import (
    Checkpointer,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer

TINY = dict(vocab_size=512, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=32,
            hidden_dropout=0.1, attention_dropout=0.0)
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


def _dataset(n=40, seed=0):
    texts, labels = t_src.synthetic_text_classification(n, seed=seed)
    return t_pipe.ArrayDataset.from_texts(t_tok.WordHashTokenizer(512), texts, labels, SEQ)


def _trainer(**kw):
    cfg = t_config.TrainConfig(**{**dict(epochs=2, learning_rate=1e-3,
                                         scale_lr_by_world_size=False, weight_decay=0.01,
                                         max_grad_norm=1.0, warmup_ratio=0.2,
                                         lr_schedule="cosine", log_every_steps=0), **kw})
    torch.manual_seed(7)   # dropout's generator, as the CLI seeds it
    return Trainer(cfg, init_bert(t_layers.EncoderConfig(**TINY), seed=3, device="cpu"),
                   total_steps=10)


class _Stop(Exception):
    """The injected interruption."""


def _record(trainer, losses, stop_after=None):
    """Record every micro-step's loss; raise ``_Stop`` before micro-step
    ``stop_after`` (counted over this trainer's calls)."""
    step = trainer.train_step

    def recorded(batch):
        if stop_after is not None and len(losses) == stop_after:
            raise _Stop
        out = step(batch)
        losses.append(out["loss"].item())
        return out

    trainer.train_step = recorded


def _state_equal(a, b):
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_state_equal(x, y) for x, y in zip(a, b))
    return a == b


# -- the Checkpointer ------------------------------------------------------------

@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_checkpointer_round_trip(tmp_path, async_save):
    trainer = _trainer(gradient_accumulation_steps=2)
    batch = next(iter(t_pipe.ShardedBatcher(_dataset(), 8, seed=1).global_arrays(0)))
    for _ in range(3):                     # an update, then a partial accumulator
        trainer.train_step(batch)
    ckpt = Checkpointer(str(tmp_path / "ck"), async_save=async_save)
    assert ckpt.restore() is None and ckpt.latest_step() is None
    want = ckpt._to_host(trainer.state_dict())
    ckpt.save(trainer.state_dict(), epoch=1, step_in_epoch=2)
    trainer.train_step(batch)              # mutates the live tensors in place
    state, epoch, step_in_epoch = ckpt.restore()
    assert (epoch, step_in_epoch, ckpt.latest_step()) == (1, 2, 3)
    assert _state_equal(state, want)
    assert state["grads"][0] is not None and state["updates"] == 1
    fresh = _trainer(gradient_accumulation_steps=2)
    fresh.load_state_dict(state)
    assert _state_equal(fresh.state_dict(), want)
    ckpt.close()


def test_checkpointer_prunes_skips_and_refuses(tmp_path):
    trainer = _trainer()
    ckpt = Checkpointer(str(tmp_path / "ck"), max_to_keep=2, async_save=True)
    for step in (2, 4, 6):
        trainer.step = step
        ckpt.save(trainer.state_dict(), epoch=0, step_in_epoch=step)
    ckpt.wait_until_finished()
    assert sorted(os.listdir(tmp_path / "ck")) == ["4", "6"]
    trainer.step = 6
    ckpt.save(trainer.state_dict(), epoch=5)          # not past the latest: skipped
    assert ckpt.restore()[1:] == (0, 6)
    with pytest.raises(FileExistsError):
        ckpt.save(trainer.state_dict(), force=True)   # that step exists
    trainer.step = 5
    ckpt.save(trainer.state_dict(), epoch=3, force=True)
    ckpt.close()
    assert sorted(os.listdir(tmp_path / "ck")) == ["5", "6"]


def test_failed_async_write_raises(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ck"), async_save=True)
    ckpt.save({"step": 1, "unpicklable": lambda: None})
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        ckpt.close()
    assert ckpt.latest_step() is None


# -- resume equals an uninterrupted fit ------------------------------------------

RESUME_CASES = {   # checkpoint_every_steps, accumulation, micro-steps before the stop
    "epoch_boundary": (0, 1, 6),      # restores the epoch-end save: epoch 1, step 0
    "mid_epoch": (3, 1, 4),           # restores step 3 of epoch 0
    "rollover": (5, 1, 7),            # the save at step 5 of 5 rolls over to epoch 1
    "accum2_mid_update": (3, 2, 4),   # restores a partial accumulator at micro-step 3
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resumed_fit_equals_uninterrupted_fit_bitwise(tmp_path, case):
    every, accum, stop = RESUME_CASES[case]
    kw = dict(checkpoint_every_steps=every, gradient_accumulation_steps=accum)
    ds = _dataset()

    full, want = _trainer(**kw), []
    _record(full, want)
    full.fit(t_pipe.ShardedBatcher(ds, 8, seed=1),
             checkpointer=Checkpointer(str(tmp_path / "full"), async_save=False))

    first, got = _trainer(**kw), []
    _record(first, got, stop_after=stop)
    ckpt = Checkpointer(str(tmp_path / "cut"), async_save=True)
    with pytest.raises(_Stop):
        first.fit(t_pipe.ShardedBatcher(ds, 8, seed=1), checkpointer=ckpt)
    ckpt.close()

    resumed = _trainer(**kw)
    state, epoch, step_in_epoch = Checkpointer(str(tmp_path / "cut")).restore()
    resumed.load_state_dict(state)
    start = resumed.step
    assert 0 < start < stop
    tail = []
    _record(resumed, tail)
    resumed.fit(t_pipe.ShardedBatcher(ds, 8, seed=1),
                checkpointer=Checkpointer(str(tmp_path / "cut")),
                start_epoch=epoch, start_step_in_epoch=step_in_epoch)
    assert got == want[:stop]
    assert tail == want[start:] and len(want) == 10
    assert (resumed.step, resumed.updates) == (full.step, full.updates) == (10, 10 // accum)
    for (name, a), b in zip(full.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("start_step", [0, 2, 4])
def test_mid_epoch_batches_match_jax(start_step):
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import (
        ArrayDataset,
        ShardedBatcher,
        WordHashTokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )

    texts, labels = t_src.synthetic_text_classification(41, seed=2)
    port = t_pipe.ShardedBatcher(
        t_pipe.ArrayDataset.from_texts(t_tok.WordHashTokenizer(512), texts, labels, SEQ),
        8, seed=4)
    ref = ShardedBatcher(ArrayDataset.from_texts(WordHashTokenizer(512), texts, labels, SEQ),
                         8, build_mesh(MeshConfig()), shuffle=True, seed=4)
    for epoch in (0, 1):
        got = list(port.local_batches(epoch, start_step))
        want = list(ref.local_batches(epoch, start_step))
        whole = list(port.local_batches(epoch))[start_step:]
        assert len(got) == len(want) == len(whole) == 5 - start_step
        for g, w, h in zip(got, want, whole):
            assert all(np.array_equal(g[k], h[k]) for k in h)   # continues, no replay
            assert sorted(g) == sorted(w)
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


# -- the replica-divergence check ------------------------------------------------

def test_replica_divergence_is_zero_on_one_rank():
    trainer = _trainer()
    assert replica_divergence(trainer.params) == 0.0
    assert trainer.check_replica_divergence() == 0.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _divergence_worker(rank, world, port, out_path):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )

    initialize_distributed("cpu")
    try:
        trainer = _trainer()
        agreed = trainer.check_replica_divergence()
        if rank == 1:
            with torch.no_grad():
                trainer.params[3].mul_(1.01)
        try:
            trainer.check_replica_divergence()
            raised = None
        except ReplicaDivergenceError as e:
            raised = str(e)
        torch.save({"agreed": agreed, "raised": raised,
                    "rel": replica_divergence(trainer.params)}, out_path)
    finally:
        dist.destroy_process_group()


def test_replica_divergence_two_gloo_ranks(tmp_path):
    """Equal replicas give 0; once rank 1 scales one parameter by 1.01,
    both ranks raise ``ReplicaDivergenceError`` with the same deviation."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_divergence_worker,
                         args=(r, 2, port, str(tmp_path / f"{r}.pt"))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs)
    out = [torch.load(str(tmp_path / f"{r}.pt")) for r in range(2)]
    assert [o["agreed"] for o in out] == [0.0, 0.0]
    assert all(o["raised"] and "diverge" in o["raised"] for o in out)
    assert out[0]["rel"] == out[1]["rel"] > 1e-6
