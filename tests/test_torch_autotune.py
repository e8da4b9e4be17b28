"""PyTorch port: the prefetch machinery (``data/autotune.py``,
``data/pipeline.py``: ``PrefetchAutotuner``, ``_AdaptiveQueue``,
``PrefetchIterator``, ``H2DStager`` and the autotuned
``ShardedBatcher.global_arrays``) against the JAX package: the controller
makes the JAX controller's decisions, decision for decision, on the same
scripted waits (fixed regimes and seeded random ones, no clocks), reads
the same environment; the iterator keeps the contracts the JAX tests hold
(values and exceptions, ``close``, reclaim by GC, sticky exhaustion) and
its decisions reach telemetry as ``autotune`` events."""

import gc
import json
import queue
import threading

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import autotune as t_auto
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import pipeline as t_pipe


@pytest.fixture(autouse=True, scope="module")
def _detached_compile_trackers():
    """A compile tracker that an earlier telemetry test installed in this
    worker rejects the ``fun_name`` keyword jax 0.9 passes to duration
    listeners, failing every later jax compile in the worker. Remove every
    installed tracker before and after this module, leaving the worker as a
    fresh one would be (a later telemetry test installs its own)."""
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


def _drive(tuner, waits, batch_bytes) -> list:
    """Feed one controller cumulative (producer, consumer) waits, one
    consumed batch at a time; returns every observe() result."""
    out, pw, cw = [], 0.0, 0.0
    for i, ((dp, dc), nbytes) in enumerate(zip(waits, batch_bytes), start=1):
        pw, cw = pw + dp, cw + dc
        out.append(tuner.observe(pw, cw, i, int(nbytes)))
    return out


def _scripted(regime: str, n: int, seed: int):
    """Per-batch (producer, consumer) wait deltas and batch bytes."""
    rng = np.random.RandomState(seed)
    if regime == "input_bound":
        waits = [(0.0, 0.01)] * n
    elif regime == "compute_bound":
        waits = [(0.01, 0.0)] * n
    elif regime == "noise":
        waits = [(1e-6, 1e-6)] * n
    elif regime == "bursty":      # starved in bursts, idle between them
        waits = [(0.0, 0.02) if (i // 16) % 2 == 0 else (0.01, 0.0) for i in range(n)]
    else:                         # seeded random mixture of all of them
        kind = rng.randint(0, 4, size=n)
        scale = rng.exponential(0.01, size=(n, 2))
        waits = [((0.0, s[1]), (s[0], 0.0), (1e-6, 1e-6), tuple(s))[k]
                 for k, s in zip(kind, scale)]
    nbytes = rng.choice([1000, 2000, 4000], size=n) if regime == "random" else [1000] * n
    return waits, nbytes


CONTROLLERS = [
    dict(min_depth=1, max_depth=16, window=4, initial_depth=2),
    dict(min_depth=1, max_depth=64, window=4, initial_depth=2, mem_budget_bytes=20_000),
    dict(min_depth=2, max_depth=8, window=2, initial_depth=8, shrink_patience=3),
    dict(window=8),
]
REGIMES = ["input_bound", "compute_bound", "noise", "bursty", "random"]


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("ctl", range(len(CONTROLLERS)))
def test_decisions_match_jax(regime, ctl):
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.autotune import (
        PrefetchAutotuner,
    )

    waits, nbytes = _scripted(regime, 160, seed=ctl * 10 + REGIMES.index(regime))
    port = t_auto.PrefetchAutotuner(**CONTROLLERS[ctl])
    ref = PrefetchAutotuner(**CONTROLLERS[ctl])
    got, want = _drive(port, waits, nbytes), _drive(ref, waits, nbytes)
    assert got == want
    assert (port.depth, port.decisions, port.hard_cap(), port._saturated) == \
        (ref.depth, ref.decisions, ref.hard_cap(), ref._saturated)


def test_saturation_latch_and_release_match_jax():
    """A producer steadily slower than the consumer: one growth, then the
    latch; the consumer stops waiting (latch released); bursts grow again."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.autotune import (
        PrefetchAutotuner,
    )

    waits = [(0.0, 0.003)] * 100 + [(0.0, 0.0)] * 16 + [(0.0, 0.01)] * 60
    port = t_auto.PrefetchAutotuner(min_depth=1, max_depth=64, window=4)
    ref = PrefetchAutotuner(min_depth=1, max_depth=64, window=4)
    got = _drive(port, waits, [1000] * len(waits))
    assert got == _drive(ref, waits, [1000] * len(waits))
    assert [d for d in got[:100] if d] == [(4, "input_bound")] and port.depth > 4


@pytest.mark.parametrize("env", [{}, {"HSTD_PREFETCH_AUTOTUNE": "0"},
                                 {"HSTD_PREFETCH_AUTOTUNE": "off"},
                                 {"HSTD_PREFETCH_MAX": "7", "HSTD_PREFETCH_MEM_MB": "1"},
                                 {"HSTD_PREFETCH_MIN": "9", "HSTD_PREFETCH_MAX": "3"},
                                 {"HSTD_PREFETCH_MIN": "x"}],
                         ids=["default", "off0", "off", "max_mem", "min_over_max", "bad"])
def test_from_env_matches_jax(monkeypatch, env):
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.autotune import (
        PrefetchAutotuner,
    )

    for name in ("HSTD_PREFETCH_AUTOTUNE", "HSTD_PREFETCH_MIN", "HSTD_PREFETCH_MAX",
                 "HSTD_PREFETCH_MEM_MB"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = t_auto.PrefetchAutotuner.from_env(), PrefetchAutotuner.from_env()
    assert (got is None) == (want is None)
    if want is not None:
        keys = ("min_depth", "max_depth", "mem_budget_bytes", "depth", "window")
        assert [getattr(got, k) for k in keys] == [getattr(want, k) for k in keys]


def test_adaptive_queue_capacity_change_unblocks_producer():
    q = t_pipe._AdaptiveQueue(1)
    q.put("a")
    with pytest.raises(queue.Full):
        q.put("b", timeout=0.05)
    unblocked = threading.Event()

    def producer():
        q.put("b", timeout=5)
        unblocked.set()

    threading.Thread(target=producer, daemon=True).start()
    q.set_capacity(2)
    assert unblocked.wait(timeout=5)
    assert q.get() == "a" and q.get() == "b"
    with pytest.raises(queue.Empty):
        q.get_nowait()


def test_prefetch_iterator_values_and_exceptions():
    assert list(t_pipe.PrefetchIterator(iter(range(7)), depth=2)) == list(range(7))

    def boom():
        yield 1
        raise RuntimeError("producer failed")

    it = t_pipe.PrefetchIterator(boom(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer failed"):
        next(it)


def test_prefetch_iterator_close_stops_thread():
    it = t_pipe.PrefetchIterator(iter(range(10_000)), depth=2)
    assert next(it) == 0
    thread = it._thread
    it.close()
    thread.join(timeout=5)
    assert not thread.is_alive()


def test_prefetch_iterator_gc_reclaims_thread():
    """Dropped without close(), the producer still stops: its thread holds
    no reference to the iterator."""
    it = t_pipe.PrefetchIterator(iter(range(10_000)), depth=2)
    assert next(it) == 0
    thread = it._thread
    del it
    gc.collect()
    thread.join(timeout=5)
    assert not thread.is_alive()


def test_prefetch_iterator_exhaustion_is_sticky():
    it = t_pipe.PrefetchIterator(iter(range(3)), depth=2)
    assert list(it) == [0, 1, 2]
    assert next(it, "default") == "default"
    it2 = t_pipe.PrefetchIterator(iter(range(3)), depth=2)
    it2.close()
    assert next(it2, None) is None


def test_autotuned_iterator_emits_decisions_and_waits(tmp_path):
    """Live threads: every item in order, depth within its bounds; each
    decision is an ``autotune`` event, the waits two metrics with the
    achieved depth; every event passes the schema."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.schema import (
        validate_events_file,
    )

    obs.reset(out_dir=str(tmp_path))
    try:
        tuner = t_auto.PrefetchAutotuner(min_depth=1, max_depth=8, window=2)
        tuner.observe(0.0, 1.0, 2, 100)   # the first window was starved: grow
        items = [{"x": np.zeros(4)} for _ in range(50)]

        def slow():
            for item in items:
                threading.Event().wait(0.002)
                yield item

        it = t_pipe.PrefetchIterator(slow(), autotuner=tuner)
        assert len(list(it)) == 50 and 1 <= it.depth <= tuner.hard_cap()
    finally:
        obs.reset()
    path = tmp_path / "events.jsonl"
    events = [json.loads(line) for line in path.read_text().splitlines()]
    assert validate_events_file(str(path))[1] == []
    names = {e.get("name") for e in events if e.get("type") == "metric"}
    assert {"data/consumer_wait_s", "data/producer_wait_s"} <= names
    wait = next(e for e in events if e.get("name") == "data/consumer_wait_s")
    assert wait["args"]["depth"] == it.depth and wait["args"]["batches"] == 50
    decisions = [e for e in events if e["type"] == "autotune"]
    assert decisions and all(e["name"] == "data/prefetch_depth" for e in decisions)


def test_stager_lookahead_and_close():
    """The stager stages batch N+1 before it hands over batch N, reports
    its staging once, and closes the prefetcher under it."""
    staged = []
    it = t_pipe.H2DStager(t_pipe.PrefetchIterator(iter(range(5)), depth=2),
                          lambda b: staged.append(b) or b * 10)
    assert next(it) == 0 and staged == [0, 1]
    assert next(it) == 10 and staged == [0, 1, 2]
    assert list(it) == [20, 30, 40] and it.staged == 5
    assert next(it, None) is None
    it2 = t_pipe.H2DStager(t_pipe.PrefetchIterator(iter(range(10_000)), depth=2), lambda b: b)
    next(it2)
    thread = it2._it._thread
    it2.close()
    thread.join(timeout=5)
    assert not thread.is_alive() and next(it2, None) is None


def _dataset(n=32, width=8):
    ids = np.arange(n * width, dtype=np.int32).reshape(n, width)
    return t_pipe.ArrayDataset({"input_ids": ids,
                                "attention_mask": np.ones((n, width), np.int32),
                                "labels": np.arange(n, dtype=np.int32) % 2})


def test_batcher_carries_the_depth_across_epochs():
    b = t_pipe.ShardedBatcher(_dataset(), 8, shuffle=False)
    it0 = b.global_arrays(0)
    assert b._auto_tuner is not None and it0.depth == 2
    it0.close()
    b._auto_tuner.depth = 8
    it1 = b.global_arrays(1)
    assert b._auto_tuner.depth == 8 and it1.depth == 8
    it1.close()


@pytest.mark.parametrize("prefetch", ["auto", 3, 0])
def test_every_prefetch_mode_gives_the_same_tensors(monkeypatch, prefetch):
    """auto, a fixed depth and no thread: the same int64 token columns and
    int32 ``valid``, equal to the rank-local numpy batches."""
    b = t_pipe.ShardedBatcher(_dataset(36), 8, shuffle=True, seed=4, drop_remainder=False)
    want = list(b.local_batches(1))
    got = list(b.global_arrays(1, prefetch=prefetch))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == (torch.int32 if k == "valid" else torch.int64)
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    monkeypatch.setenv("HSTD_PREFETCH_AUTOTUNE", "0")
    it = b.global_arrays(0)
    assert it.depth == 2 and it._it._autotuner is None
    it.close()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stager's side stream and pinned buffers")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_stager_on_card(cuda_device):
    """On the card, batches come from pinned buffers that are reused, are
    copied on the stager's side stream, and equal the host batches when a
    non-default stream consumes them; bucketed widths grow the buffers."""
    # 4 batches: an even count, so each pass stages the same batches in
    # the same one of the two slots
    cols = {"input_ids": np.arange(32 * 64, dtype=np.int32).reshape(32, 64) % 97,
            "attention_mask": (np.arange(64)[None, :] < (2 * np.arange(32) + 1)[:, None]
                               ).astype(np.int32),
            "labels": np.arange(32, dtype=np.int32) % 2}
    b = t_pipe.ShardedBatcher(t_pipe.ArrayDataset(cols), 8, shuffle=False,
                              device=cuda_device, bucket_sizes=[16, 32, 64])
    want = list(b.local_batches(0))
    consumer = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(consumer):
        got = [{k: (v * 1).cpu() for k, v in batch.items()} for batch in b.global_arrays(0)]
    assert len(got) == len(want) == 4
    assert len({w["input_ids"].shape[1] for w in want}) > 1
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    stager = b._cuda_stager
    assert stager is not None and stager.stream != consumer
    bufs = [dict(slot["bufs"]) for slot in stager._slots]
    assert all(t.is_pinned() for slot in bufs for t in slot.values())
    list(b.global_arrays(0))      # the same widths again: the same buffers
    for slot, before in zip(stager._slots, bufs):
        assert all(slot["bufs"][k] is t for k, t in before.items())
