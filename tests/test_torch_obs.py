"""PyTorch port: telemetry (``obs/``) and the meter's MFU accounting
(``utils/timing.py``) against the JAX package's.

- ``trainer_flops_per_token`` equals the JAX ``obs/flops.py`` for
  BERT-base and GPT-2 124M within 1e-12 relative; ``peak_tflops`` equals
  it under the same ``HSTD_PEAK_TFLOPS`` override.
- The ``StepMeter`` windows' achieved TFLOP/s and MFU equal the JAX
  meter's on the same window inputs and clock, within 1e-12 relative.
- The schema tables equal the JAX package's; every event a
  telemetry-on fit writes validates under the JAX validator and
  ``scripts/check_telemetry_schema.py``.
- The same loss, grad-norm and step-time observations raise the same
  anomalies as the JAX ``AnomalyDetector``; the flight dumps carry the
  same keys.
- The heartbeat writes a stall dump; ``--profile`` writes a trace; no
  test leaves a thread running."""

import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import config as t_config
from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import pipeline as t_pipe
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import sources as t_src
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import tokenization as t_tok
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import layers as t_layers
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import init_bert
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.gpt2 import Gpt2Config
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import anomaly as t_anomaly
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import core as t_core
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import flight as t_flight
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import flops as t_flops
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import schema as t_schema
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.watchdog import Heartbeat
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.checkpoint import (
    Checkpointer,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.timing import StepMeter

ROOT = Path(__file__).resolve().parents[1]
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


@pytest.fixture(autouse=True)
def _fresh_obs_and_no_thread_left():
    """Each test starts from a fresh, unconfigured port telemetry state
    and must leave no thread behind once that state is shut down."""
    before = set(threading.enumerate())
    obs.reset()
    yield
    obs.reset()
    left = [t for t in threading.enumerate() if t not in before and t.is_alive()]
    assert not left, f"threads left running: {[t.name for t in left]}"


# -- FLOPs and the peak ------------------------------------------------------------

def _configs():
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.gpt2 import (
        Gpt2Config as JaxGpt2,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.layers import (
        EncoderConfig as JaxEncoder,
    )

    return {"bert-base": (t_layers.EncoderConfig(), JaxEncoder(), "seq-cls"),
            "gpt2-124m": (Gpt2Config(), JaxGpt2(), "causal-lm")}


@pytest.mark.parametrize("name", ["bert-base", "gpt2-124m"])
@pytest.mark.parametrize("seq", [128, 512])
def test_trainer_flops_per_token_match_jax(name, seq):
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import flops as j_flops

    port_cfg, jax_cfg, task = _configs()[name]
    got = t_flops.trainer_flops_per_token(port_cfg, task, seq)
    want = j_flops.trainer_flops_per_token(jax_cfg, task, seq)
    assert want[0] > 0 and want[1] == got[1] == 0.0
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)


def test_trainer_flops_per_token_raises_without_transformer_dims():
    """The port's configs always carry the figures: a config without them
    raises instead of dropping MFU from the history."""
    with pytest.raises(AttributeError):
        t_flops.trainer_flops_per_token(object(), "seq-cls", 128)


def test_peak_tflops_table_and_override_match_jax(monkeypatch):
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import flops as j_flops

    monkeypatch.delenv(t_flops.ENV_PEAK, raising=False)
    assert t_flops.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert t_flops.peak_tflops("NVIDIA H100 PCIe") == 756.0
    assert t_flops.peak_tflops("TPU v5 lite") is None      # no TPU rows
    assert t_flops.peak_tflops(None) is None
    for raw in ("123.5", "989", "bogus", "-1"):
        monkeypatch.setenv(t_flops.ENV_PEAK, raw)
        assert t_flops.env_peak_tflops() == j_flops.env_peak_tflops()
        if j_flops.env_peak_tflops() is not None:
            for kind in ("NVIDIA H100 80GB HBM3", "TPU v5 lite", None):
                assert t_flops.peak_tflops(kind) == j_flops.peak_tflops(kind) == float(raw)


def _meter_windows(meter):
    """One excluded first step, three windows of steps with their real
    token counts, and an empty window (discarded)."""
    summaries = []
    meter.begin_window()
    meter.window_step(8)
    meter.window_tokens(4096)
    meter.exclude_step(8)
    meter.begin_window()
    for tokens in ([4096, 3900, 4001], [512], [4096, 4096]):
        for tok in tokens:
            meter.window_step(8)
            meter.window_tokens(tok)
        summaries.append(meter.end_window())
        meter.begin_window()
    meter.end_window()
    return summaries


def test_step_meter_mfu_matches_jax(monkeypatch):
    from huggingface_sagemaker_tensorflow_distributed_tpu.utils.timing import (
        StepMeter as JaxMeter,
    )

    fpt = t_flops.trainer_flops_per_token(t_layers.EncoderConfig(), "seq-cls", 512)[0]
    kw = dict(n_chips=2, flops_per_token=fpt, peak_tflops=989.0)
    results = []
    for cls in (StepMeter, JaxMeter):
        ticks = iter(10.0 + 0.0375 * np.arange(100) ** 1.5)   # the same clock for both
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
        meter = cls(**kw)
        results.append((meter, _meter_windows(meter)))
        monkeypatch.undo()
    (port, got), (ref, want) = results
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("steps", "samples", "tokens")} == \
            {k: w[k] for k in ("steps", "samples", "tokens")}
        for key in ("dt", "step_time_s", "model_flops", "achieved_tflops_per_chip", "mfu"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-12, err_msg=key)
    np.testing.assert_allclose(port.mfu, ref.mfu, rtol=1e-12)
    np.testing.assert_allclose(port.achieved_tflops_per_chip, ref.achieved_tflops_per_chip,
                               rtol=1e-12)
    assert port.excluded_steps == ref.excluded_steps == 1 and 0 < port.mfu < 1


# -- the schema, and a telemetry-on fit ------------------------------------------

def test_schema_tables_equal_jax():
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import schema as j_schema

    assert t_schema.SCHEMA_VERSION == j_schema.SCHEMA_VERSION
    assert t_schema.REQUIRED_FIELDS == j_schema.REQUIRED_FIELDS
    assert t_schema.OPTIONAL_FIELDS == j_schema.OPTIONAL_FIELDS
    assert t_schema.SERVE_EVENTS == j_schema.SERVE_EVENTS
    assert t_schema.ENVELOPE_FIELDS == j_schema.ENVELOPE_FIELDS


def _texts(n=40, seed=1):
    texts, labels = t_src.synthetic_text_classification(n, seed=seed)
    return t_pipe.ArrayDataset.from_texts(t_tok.WordHashTokenizer(512), texts, labels, SEQ)


def _fit(tmp_path, **kw):
    """A tiny fit under the current telemetry state; the batcher and the
    trainer are built after it is configured, as the CLI builds them."""
    ds = _texts()
    cfg = t_config.TrainConfig(**{**dict(epochs=2, learning_rate=1e-3, max_grad_norm=1.0,
                                         scale_lr_by_world_size=False, log_every_steps=2,
                                         max_seq_length=SEQ), **kw})
    trainer = Trainer(cfg, init_bert(t_layers.EncoderConfig(**TINY), seed=0, device="cpu"))
    ckpt = Checkpointer(str(tmp_path / "ck")) if cfg.checkpoint_dir else None
    try:
        hist = trainer.fit(t_pipe.ShardedBatcher(ds, 8, seed=0), checkpointer=ckpt,
                           eval_batcher=t_pipe.ShardedBatcher(ds, 8, shuffle=False,
                                                              drop_remainder=False))
    finally:
        if ckpt is not None:
            ckpt.close()
    return trainer, hist


def test_telemetry_fit_events_validate_under_the_jax_schema(tmp_path, monkeypatch):
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import schema as j_schema

    monkeypatch.setenv("HSTD_PEAK_TFLOPS", "0.5")
    tel = tmp_path / "tel"
    obs.configure(out_dir=str(tel))
    trainer, hist = _fit(tmp_path, keep_best=True, checkpoint_dir=str(tmp_path / "ck"),
                         checkpoint_every_steps=3)
    obs.shutdown()
    n, errors = j_schema.validate_events_file(str(tel / "events.jsonl"), strict_tail=True)
    assert not errors and n > 0
    n_trace, errors = j_schema.validate_trace_file(str(tel / "trace.json"))
    assert not errors and n_trace > 0
    events = [json.loads(line) for line in (tel / "events.jsonl").read_text().splitlines()]
    spans = {e["name"] for e in events if e["type"] == "span"}
    assert {"train/step_dispatch", "train/sync", "train/checkpoint",
            "train/checkpoint_write", "eval/run", "eval/sync"} <= spans
    series = {e["name"] for e in events if e["type"] == "metric"}
    assert {"train/mfu", "train/achieved_tflops_per_chip", "train/samples_per_sec",
            "train/loss", "eval/loss", "train/mfu_final"} <= series
    assert hist["train_mfu"] > 0 and hist["train_achieved_tflops_per_chip"] > 0
    assert events[0]["type"] == "run"
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "check_telemetry_schema.py"),
                           str(tel)], capture_output=True, text=True, timeout=120,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_fit_without_telemetry_writes_nothing_and_reports_no_mfu(tmp_path, monkeypatch):
    monkeypatch.delenv("HSTD_PEAK_TFLOPS", raising=False)
    trainer, hist = _fit(tmp_path)
    assert "train_mfu" not in hist and "train_achieved_tflops_per_chip" not in hist
    assert not obs.has_sink() and obs.state().spans == []
    assert not any(t.name == "hstd-heartbeat" for t in threading.enumerate())


# -- anomalies and the flight recorder -------------------------------------------

OBSERVATIONS = (
    [("step_time", s, 0.1 + 0.001 * (s % 3)) for s in range(10)]
    + [("step_time", 10, 0.9), ("grad_norm", 0, 1.0)]
    + [("grad_norm", s, 1.0 + 0.01 * s) for s in range(1, 10)]
    + [("grad_norm", 10, 50.0), ("loss", 11, 0.7), ("loss", 12, float("nan")),
       ("loss", 13, float("inf")), ("grad_norm", 14, float("nan"))])


def _feed(detector):
    for kind, step, value in OBSERVATIONS:
        getattr(detector, f"observe_{kind}")(step, value)
    detector.observe_straggler(0, {"straggler_ratio": 1.5, "argmax": 1})
    detector.observe_straggler(1, {"straggler_ratio": 1.6, "argmax": 1})
    detector.observe_stall(12.5, "MainThread")


def test_anomalies_match_jax_detector(tmp_path):
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import anomaly as j_anomaly
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import core as j_core
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import flight as j_flight

    dumps = {}
    for name, core, anomaly, flight in (("port", t_core, t_anomaly, t_flight),
                                        ("jax", j_core, j_anomaly, j_flight)):
        state = core.ObsState()
        state.configure(out_dir=str(tmp_path / name), enabled=True)
        state.events.emit("metric", {"name": "train/loss", "value": 0.7, "step": 3})
        det = anomaly.AnomalyDetector(state, recorder=state.ring,
                                      profiler=flight.ProfilerCapture(mode="off"),
                                      cooldown_s=0.0)
        _feed(det)
        state.shutdown()
        dumps[name] = (det, sorted(p.name for p in (tmp_path / name).glob("flight_*.jsonl")))
    (port, port_files), (ref, ref_files) = dumps["port"], dumps["jax"]
    assert port.counts == ref.counts
    assert set(port.counts) == {"step_time_spike", "grad_explosion", "nan_loss", "nan_grad",
                                "straggler", "heartbeat_stall"}
    strip = [{k: v for k, v in e.items() if k != "evidence"} for e in port.events]
    assert strip == [{k: v for k, v in e.items() if k != "evidence"} for e in ref.events]
    assert port_files == ref_files and len(port_files) == port.total
    for fname in port_files:       # the same records, the same keys, line for line
        a = [json.loads(x) for x in (tmp_path / "port" / fname).read_text().splitlines()]
        b = [json.loads(x) for x in (tmp_path / "jax" / fname).read_text().splitlines()]
        assert [sorted(r) for r in a] == [sorted(r) for r in b]
        assert [r["type"] for r in a] == [r["type"] for r in b]
        n, errors = t_schema.validate_events_file(str(tmp_path / "port" / fname))
        assert not errors and n == len(a)


def test_flight_recorder_dump_keys_match_jax(tmp_path):
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import core as j_core

    keys = {}
    for name, core in (("port", t_core), ("jax", j_core)):
        ring = core.FlightRecorder(capacity=3)
        log = core.EventLog(str(tmp_path / name / "events.jsonl"), 0, ring=ring)
        for i in range(5):
            log.emit("metric", {"name": "train/loss", "value": float(i), "step": i})
        log.emit("span", {"name": "train/sync", "dur": 0.5, "mono": 1.0, "tid": 7})
        log.close()
        path = ring.dump(str(tmp_path / name), step=9,
                         extra=log.stamp_record("anomaly", {"name": "nan_loss",
                                                            "message": "m"}))
        lines = [json.loads(x) for x in Path(path).read_text().splitlines()]
        keys[name] = ([sorted(r) for r in lines], [r.get("value") for r in lines],
                      Path(path).name)
    assert keys["port"] == keys["jax"]
    assert keys["port"][1] == [3.0, 4.0, None, None] and keys["port"][2] == "flight_9.jsonl"


def test_flight_recorder_dump_raises_when_it_cannot_write(tmp_path):
    ring = t_core.FlightRecorder(capacity=3)
    ring.record({"type": "metric", "name": "train/loss", "value": 1.0})
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    with pytest.raises(OSError):
        ring.dump(str(blocker), step=1)
    assert ring.dumps == []


# -- the heartbeat and the profiler window ---------------------------------------

def test_heartbeat_writes_a_stall_dump(tmp_path):
    state = t_core.ObsState()
    state.configure(out_dir=str(tmp_path), enabled=True)
    stalls = []
    hb = Heartbeat(state, interval=0.05, stall_after=0.2,
                   on_stall=lambda age, name: stalls.append((age, name)))
    done = threading.Event()

    def watched():
        hb.watch_current_thread()
        hb.pulse()
        done.wait(10)      # stops pulsing

    th = threading.Thread(target=watched, name="train-loop")
    th.start()
    hb.start()
    try:
        deadline = time.monotonic() + 10
        while not stalls and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        done.set()
        th.join(10)
        hb.stop()
        state.shutdown()
    assert not th.is_alive() and stalls and stalls[0][1] == "train-loop"
    assert hb.stall_count == 1           # one dump per stall, re-armed on a pulse
    events = [json.loads(x) for x in (tmp_path / "events.jsonl").read_text().splitlines()]
    stall = [e for e in events if e["type"] == "stall"]
    assert len(stall) == 1 and stall[0]["stalled"] == "train-loop"
    assert any(t.get("watched") and t["name"] == "train-loop" for t in stall[0]["threads"])
    assert any(e["type"] == "heartbeat" for e in events)
    n, errors = t_schema.validate_events_file(str(tmp_path / "events.jsonl"))
    assert not errors and n == len(events)


def test_profile_fit_writes_a_trace(tmp_path):
    trainer, hist = _fit(tmp_path, profile=True, profile_dir=str(tmp_path / "prof"),
                         log_every_steps=0)
    traces = list((tmp_path / "prof").glob("train_rank0_*.pt.trace.json"))
    assert len(traces) == 1
    doc = json.loads(traces[0].read_text())
    names = {e.get("name", "") for e in doc["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)    # CPU activity on the CPU


# -- the compile tracker and its budget ------------------------------------------------

def _both_states(tmp_path):
    """A file-backed state of each package: (port obs, port dir, JAX obs,
    JAX dir). The JAX package's tracker is built directly on its state:
    its ``install_compile_tracker`` would register the listener that
    breaks every later jax compile in this worker."""
    from huggingface_sagemaker_tensorflow_distributed_tpu import obs as jax_obs

    obs.reset(out_dir=str(tmp_path / "port"), enabled=True)
    jax_obs.reset(out_dir=str(tmp_path / "jax"), enabled=True)
    return jax_obs


def _typed(out, *types):
    path = out / "events.jsonl"
    if not path.exists():
        return []
    return [{k: v for k, v in e.items() if k not in ("t", "pid")}
            for e in map(json.loads, path.read_text().splitlines()) if e["type"] in types]


def test_compile_tracker_counts_compile_events_on_both_trackers(tmp_path):
    """The JAX package's ``test_compile_tracker_counts_compile_events`` on
    both trackers: the marker filter, the count, the cumulative seconds,
    and ``compile`` events equal field for field (apart from ``t`` and
    ``pid``) and valid under the JAX schema."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import schema as j_schema
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs.watchdog import (
        CompileTracker as JaxTracker,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.watchdog import (
        CompileTracker,
    )

    jax_obs = _both_states(tmp_path)
    try:
        trackers = (CompileTracker(obs.state()), JaxTracker(jax_obs.state()))
        for t in trackers:
            t.observe("/jax/core/compile/backend_compile_duration", 1.5)
            t.observe("/jax/core/something_else", 9.0)        # no marker: ignored
            t.observe("/jax/pjit/compile", 0.5)
            t.observe("/hstd/compile/load/flash_attention", 0.0125)
        for t in trackers:
            assert t.count == 3 and t.cum_secs == pytest.approx(2.0125)
            assert not t.budget_exceeded
    finally:
        obs.reset()
        jax_obs.reset()
    port, ref = _typed(tmp_path / "port", "compile"), _typed(tmp_path / "jax", "compile")
    assert port == ref and [c["count"] for c in port] == [1, 2, 3]
    assert all(j_schema.validate_event({**c, "t": 0.0, "pid": 1}) == [] for c in port)


def test_compile_budget_crossing_alerts_once_and_latches_like_jax(tmp_path, capsys):
    """The budget crossed on the second compile: one ``alert`` named
    ``compile_budget`` and one stderr line from each package, the flag
    latched (a third compile alerts no more), the ``compile`` and ``alert``
    events equal field for field apart from ``t``, ``pid`` and the
    message's wording (the JAX package names XLA and its compile cache;
    the port names its native builds), which carries the same budget, sum
    and count."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs.watchdog import (
        CompileTracker as JaxTracker,
    )

    jax_obs = _both_states(tmp_path)
    try:
        port = obs.compile_tracker()
        port.budget_s = 0.5
        ref = JaxTracker(jax_obs.state(), budget_s=0.5)
        assert not obs.compile_budget_exceeded()
        for secs in (0.3, 0.4, 0.4):
            for t in (port, ref):
                t.observe("backend_compile_time", secs)
        assert port.budget_exceeded and ref.budget_exceeded
        assert obs.compile_budget_exceeded() and obs.compile_budget_capped(1)
    finally:
        obs.reset()
        jax_obs.reset()
    assert not obs.compile_budget_exceeded()       # the tracker left with its state
    got, want = (_typed(tmp_path / d, "compile", "alert") for d in ("port", "jax"))
    messages = [e.pop("message") for e in got + want if e["type"] == "alert"]
    assert got == want and [e["type"] for e in got].count("alert") == 1
    assert got[2] == {"v": 1, "host": 0, "type": "alert", "name": "compile_budget",
                      "cum": 0.7, "budget_s": 0.5, "count": 2}
    shared = ("compile time 0.7s exceeds HSTD_COMPILE_BUDGET_S=0.5s after 2 compilations "
              "— bucket ladders will stop minting new widths")
    assert all(shared in m for m in messages)
    assert capsys.readouterr().err.count("[hstd-obs] COMPILE BUDGET:") == 2


def test_observe_takes_extra_keywords():
    """A caller may pass more than the event and its seconds (jax 0.9
    passes ``fun_name=`` to its listeners): the port's tracker takes them
    without raising."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.watchdog import (
        CompileTracker,
    )

    t = CompileTracker(obs.state(), budget_s=None)
    t.observe("/jax/core/compile/backend_compile_duration", 0.25, fun_name="f", extra=1)
    assert t.count == 1 and t.cum_secs == 0.25


def test_tracker_installs_only_on_an_enabled_state_and_once(tmp_path):
    obs.reset(enabled=False)
    assert obs.compile_tracker() is None and not obs.enabled()
    obs.reset(out_dir=str(tmp_path), enabled=True)
    assert obs.enabled() and obs.compile_tracker() is obs.compile_tracker()


def test_load_host_reports_one_compile_event(tmp_path, monkeypatch):
    """The first load of the (already built) host library in a process is
    one ``/hstd/compile/load/host`` observation; a second call is the
    cached library and reports nothing."""
    import functools

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import _build

    if shutil.which("g++") is None:
        pytest.skip("no g++: the host library cannot be built")
    _build.build_host()
    monkeypatch.setattr(_build, "load_host",
                        functools.lru_cache(maxsize=None)(_build.load_host.__wrapped__))
    obs.reset(out_dir=str(tmp_path), enabled=True)
    tracker = obs.compile_tracker()
    _build.load_host()
    _build.load_host()
    obs.reset()
    events = _typed(tmp_path, "compile")
    assert [e["event"] for e in events] == ["/hstd/compile/load/host"] and tracker.count == 1
    assert 0 <= events[0]["dur"] < 5


def _stub_nvcc(bin_dir, delays: dict, fail=()):
    """An ``nvcc`` on ``PATH`` that sleeps a source's delay, then writes the
    library (or exits 1 for a source in ``fail``)."""
    bin_dir.mkdir()
    script = bin_dir / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        f"delays, fail = {delays!r}, {tuple(fail)!r}\n"
        "args = sys.argv[1:]\n"
        "src = args[-1].rsplit('/', 1)[-1][:-3]\n"
        "time.sleep(delays[src])\n"
        "if src in fail:\n"
        "    sys.stderr.write('error: ' + src + '\\n'); sys.exit(1)\n"
        "open(args[args.index('-o') + 1], 'wb').write(b'lib')\n"
        "sys.stderr.write('ptxas info: ' + src + '\\n')\n")
    script.chmod(0o755)


def test_parallel_nvcc_builds_each_report_their_own_seconds(tmp_path, monkeypatch):
    """Two builds started together (the slower first in the list): each
    reports its own wall seconds, as the JAX package sums each compile's
    duration, and the two overlap."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import _build

    _stub_nvcc(tmp_path / "bin", {"flash_attention": 1.2, "paged_attention": 0.2})
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}:{os.environ['PATH']}")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    obs.reset(out_dir=str(tmp_path / "tel"), enabled=True)
    tracker = obs.compile_tracker()
    t0 = time.perf_counter()
    _build.build("flash_attention", "paged_attention")
    wall = time.perf_counter() - t0
    _build.build("flash_attention", "paged_attention")       # built: nothing to report
    obs.reset()
    events = {e["event"]: e["dur"] for e in _typed(tmp_path / "tel", "compile")}
    assert set(events) == {"/hstd/compile/nvcc/flash_attention",
                           "/hstd/compile/nvcc/paged_attention"} and tracker.count == 2
    assert events["/hstd/compile/nvcc/flash_attention"] >= 1.2
    assert events["/hstd/compile/nvcc/paged_attention"] < 1.0
    assert wall < 1.2 + 0.2 + 0.5
    for name in ("flash_attention", "paged_attention"):
        assert _build.library_path(name).read_bytes() == b"lib"
        assert name in _build.build_log(name).read_text()


def test_a_failed_nvcc_build_raises_and_reports_only_the_others(tmp_path, monkeypatch):
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import _build

    _stub_nvcc(tmp_path / "bin", {"flash_attention": 0.05, "paged_attention": 0.05},
               fail=("flash_attention",))
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}:{os.environ['PATH']}")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    tracker = obs.compile_tracker()
    with pytest.raises(RuntimeError, match="nvcc failed to build csrc/flash_attention.cu"):
        _build.build("flash_attention", "paged_attention")
    assert tracker.count == 1 and not _build.library_path("flash_attention").exists()
    assert _build.library_path("paged_attention").exists()


def test_obs_helpers_match_jax(monkeypatch, tmp_path):
    """``heartbeat_env_interval``, ``alert``, ``anomaly_counts``,
    ``anomaly_total`` and ``flight_recorder`` as the JAX package's."""
    from huggingface_sagemaker_tensorflow_distributed_tpu import obs as jax_obs

    for raw, default in (("", 60.0), ("2.5", 60.0), ("bad", 10.0), ("", 10.0)):
        monkeypatch.setenv("HSTD_HEARTBEAT_SECS", raw)
        assert obs.heartbeat_env_interval(default) == jax_obs.heartbeat_env_interval(default)
    assert obs.anomaly_counts() == {} and obs.anomaly_total() == 0
    obs.reset(out_dir=str(tmp_path / "port"), enabled=True)
    jax_obs.reset(out_dir=str(tmp_path / "jax"), enabled=True)
    try:
        for o in (obs, jax_obs):
            o.alert("host_oom", "the host ran out", args={"rss": 3})
            o.alert("budget", "over")
        assert (obs.flight_recorder() is None) == (jax_obs.flight_recorder() is None)
        det = obs.anomalies()
        det.observe_loss(3, float("nan"))
        assert obs.anomaly_counts() == dict(det.counts) and obs.anomaly_total() == det.total
        assert obs.anomaly_total() >= 1
    finally:
        obs.reset()
        jax_obs.reset()
    assert _typed(tmp_path / "port", "alert") == _typed(tmp_path / "jax", "alert")
    assert len(_typed(tmp_path / "port", "alert")) == 2


def test_instrumented_fit_installs_the_compile_tracker(tmp_path, monkeypatch):
    """A fit with a telemetry directory installs the compile tracker (as
    the JAX trainer does) and its compiles become events; a fit without
    one installs none."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import watchdog

    real = Trainer.train_step

    def step(self, batch):
        watchdog.report_compile("/hstd/compile/load/flash_attention", 0.01)
        return real(self, batch)

    monkeypatch.setattr(Trainer, "train_step", step)
    _fit(tmp_path, epochs=1)
    assert not [t for t in watchdog._INSTALLED if t.state is obs.state()]
    obs.reset(out_dir=str(tmp_path / "tel"), enabled=True)
    trainer, _ = _fit(tmp_path, epochs=1)
    installed = [t for t in watchdog._INSTALLED if t.state is obs.state()]
    obs.reset()
    compiles = _typed(tmp_path / "tel", "compile")
    assert len(installed) == 1 and installed[0].count == trainer.step == len(compiles) > 0
