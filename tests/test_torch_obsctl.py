"""PyTorch port: the offline run report, its diff and the goodput replay
(``obs/report.py``, ``obs/goodput.py``) and ``python -m <port>.obs`` against
the JAX package's readers and ``scripts/obsctl.py``. The JAX package's
``tests/test_obsctl.py`` cases run with every reader they call and every
``obsctl`` run they make paired with the port's on the same inputs (JSON,
text, stdout, stderr, written files and exit codes equal byte for byte,
``tests/torch_obs_pairs.py``); the events of a port engine run, a traced
two-replica fleet with a drain, two wall-clock open-loop runs and a
telemetry fit go through both packages' readers and both CLIs; every
subcommand runs with ``torch`` and ``jax`` poisoned."""

import inspect
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_obsctl as jax_obsctl_cases
import torch_obs_pairs as pairs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import goodput as t_goodput
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import report as t_report
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import timeline as t_timeline
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import trace as t_trace
from test_obsctl import three_hosts  # noqa: F401  (the fixture the cases take)
from torch_decode_pairs import detached_compile_trackers, one_torch_thread  # noqa: F401

C = jax_obsctl_cases
# the JAX cases that hold the JAX package's static analysis (not ported:
# ROADMAP queue 1, item 12), one of them with a poisoned-jax subprocess of
# every obsctl subcommand, which test_every_subcommand_runs_without_torch_or_jax
# holds for the port
NOT_READERS = ("test_cli_runs_without_jax", "test_cli_diff_runs_without_jax",
               "test_cli_subprocess_smoke_without_jax")
CASES = [name for name, fn in inspect.getmembers(C, inspect.isfunction)
         if name.startswith("test_") and name not in NOT_READERS]


def _call_case(fn, request):
    return fn(**{name: request.getfixturevalue(name)
                 for name in inspect.signature(fn).parameters})


@pytest.mark.parametrize("case", CASES)
def test_jax_obsctl_cases_hold_on_both_packages(case, monkeypatch, request):
    paired = pairs.pair_case(monkeypatch, C, modules=("report",))
    _call_case(getattr(C, case), request)
    assert paired.calls, f"{case} called no reader"


def test_reader_constants_equal_the_jax_ones():
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import goodput as j_goodput
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import report as j_report

    assert t_report.REPORT_VERSION == j_report.REPORT_VERSION
    assert t_report.DIFF_METRICS == j_report.DIFF_METRICS
    assert t_goodput.DEFAULT_KNEE_TARGET == j_goodput.DEFAULT_KNEE_TARGET


# -- a port engine run, fleet run, open-loop runs and fit through both readers ------

SERVE = dict(vocab_size=128, max_position_embeddings=64, hidden_size=32, num_layers=2,
             num_heads=2, intermediate_size=64, eos_token_id=127, pad_token_id=0)
ENGINE = dict(num_slots=2, block_size=8, prefill_chunk=8, max_model_len=64)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Telemetry directories of the port's own runs on the CPU: ``engine``
    (one engine, timelines on, 8 requests), ``fleet`` (two replicas, replica
    0 drained mid-trace), ``wall_<rate>`` (two wall-clock open-loop runs over
    two replicas with a TTFT and TPOT SLO) and ``fit`` (a 4-step tiny-BERT
    fit with telemetry)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
        init_gpt2,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.gpt2 import (
        Gpt2Config,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import (
        ServeEngine,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.loadgen import (
        OpenLoopDriver,
        SloSpec,
        make_schedule,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.router import Router

    root = tmp_path_factory.mktemp("port_runs")
    model = init_gpt2(Gpt2Config(hidden_dropout=0.0, embd_dropout=0.0, attention_dropout=0.0,
                                 **SERVE), seed=0, device="cpu")
    rng = np.random.RandomState(4)
    trace = [(rng.randint(1, 120, (int(rng.randint(4, 13)),)).astype(np.int32),
              int(rng.randint(3, 9))) for _ in range(8)]
    try:
        obs.reset(out_dir=str(root / "engine"), enabled=True)
        eng = ServeEngine(model, device="cpu", **ENGINE)
        for p, m in trace:
            eng.submit(p, m, group="interactive" if len(p) % 2 else "batch")
        eng.run()
        obs.reset(out_dir=str(root / "fleet"), enabled=True)
        router = Router(model, replicas=2, device="cpu", **ENGINE)
        for p, m in trace:
            router.submit(p, m)
        router.warmup()
        for _ in range(3):
            router.step()
        router.drain(0)
        router.run()
        assert router.migrations + router.requeues > 0
        for rate in (60.0, 2000.0):
            obs.reset(out_dir=str(root / f"wall_{rate:g}"), enabled=True)
            schedule = make_schedule(8, 120, process="poisson", rate=rate, seed=11,
                                     prompt_lo=4, prompt_hi=12, new_lo=3, new_hi=8,
                                     eos_token_id=127, groups=("interactive", "batch"))
            OpenLoopDriver(Router(model, replicas=2, device="cpu", **ENGINE), schedule,
                           clock="wall", slo=SloSpec(ttft_s=0.5, tpot_s=0.25),
                           process="poisson", rate=rate).run()
        obs.reset(out_dir=str(root / "fit"), enabled=True)
        _telemetry_fit()
    finally:
        obs.reset()
    return root


def _telemetry_fit():
    """A 4-step tiny-BERT fit under the current telemetry state."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import pipeline as t_pipe
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import sources as t_src
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import tokenization as t_tok
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
        init_bert,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.layers import (
        EncoderConfig,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer

    texts, labels = t_src.synthetic_text_classification(32, seed=1)
    ds = t_pipe.ArrayDataset.from_texts(t_tok.WordHashTokenizer(128), texts, labels, 32)
    cfg = TrainConfig(epochs=1, steps_per_epoch=4, learning_rate=1e-3,
                      scale_lr_by_world_size=False, log_every_steps=2, max_seq_length=32)
    model = init_bert(EncoderConfig(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                                    intermediate_size=64, max_position_embeddings=32,
                                    hidden_dropout=0.0, attention_dropout=0.0),
                      seed=0, device="cpu")
    Trainer(cfg, model).fit(t_pipe.ShardedBatcher(ds, 8, seed=0))


def _j(sub):
    import importlib

    return importlib.import_module(f"{pairs.JAX_PKG}.obs.{sub}")


def _events(root, name):
    return _j("timeline").load_events([str(root / name)])[0]


def _readers(root):
    """(name, JAX function, arguments) of every reader over the runs."""
    j_report, j_goodput, j_timeline, j_trace = (_j(m) for m in (
        "report", "goodput", "timeline", "trace"))
    dirs = [str(root / d) for d in ("engine", "fleet", "wall_60", "wall_2000", "fit")]
    report = j_report.build_report(dirs)
    records = j_timeline.collect_timelines(_events(root, "engine"))
    traces = j_trace.collect_traces(_events(root, "fleet"))
    return [
        ("build_report", j_report.build_report, (dirs,)),
        ("validate_report", j_report.validate_report, (report,)),
        ("render_text", j_report.render_text, (report,)),
        ("diff_reports", j_report.diff_reports,
         (j_report.build_report([str(root / "fit")]), report, 5.0)),
        ("goodput", j_goodput.goodput,
         (_events(root, "wall_60") + _events(root, "wall_2000"),)),
        ("render_goodput_text", j_goodput.render_goodput_text,
         (j_goodput.goodput(_events(root, "wall_60") + _events(root, "wall_2000")),)),
        ("collect_timelines", j_timeline.collect_timelines, (_events(root, "engine"),)),
        ("slo_attribution", j_timeline.slo_attribution, (records, 0.9)),
        ("render_slo_text", j_timeline.render_slo_text,
         (j_timeline.slo_attribution(records),)),
        ("gantt_text", j_timeline.gantt_text, (records,)),
        ("chrome_trace", j_timeline.chrome_trace, (records,)),
        ("collect_traces", j_trace.collect_traces, (_events(root, "fleet"),)),
        ("trace_text", lambda ts: [j_trace.trace_text(t) for t in ts], (traces,)),
        ("fleet_summary", j_trace.fleet_summary, (traces,)),
        ("fleet_text", j_trace.fleet_text, (traces,)),
        ("fleet_chrome_trace", j_trace.fleet_chrome_trace, (traces,)),
    ]


PORT_READERS = {
    "build_report": t_report.build_report, "validate_report": t_report.validate_report,
    "render_text": t_report.render_text, "diff_reports": t_report.diff_reports,
    "goodput": t_goodput.goodput, "render_goodput_text": t_goodput.render_goodput_text,
    "collect_timelines": t_timeline.collect_timelines,
    "slo_attribution": t_timeline.slo_attribution,
    "render_slo_text": t_timeline.render_slo_text, "gantt_text": t_timeline.gantt_text,
    "chrome_trace": t_timeline.chrome_trace, "collect_traces": t_trace.collect_traces,
    "trace_text": lambda ts: [t_trace.trace_text(t) for t in ts],
    "fleet_summary": t_trace.fleet_summary, "fleet_text": t_trace.fleet_text,
    "fleet_chrome_trace": t_trace.fleet_chrome_trace}


@pytest.mark.parametrize("reader", list(PORT_READERS))
def test_port_runs_read_alike_in_both_packages(port_runs, reader):
    (name, jax_fn, args), = [r for r in _readers(port_runs) if r[0] == reader]
    want = jax_fn(*args)
    assert want == [] if name == "validate_report" else want, name
    assert pairs.dump(PORT_READERS[name](*args)) == pairs.dump(want)


def test_port_runs_are_what_the_readers_expect(port_runs):
    """The runs carry what the readers read: eight timelines summing to
    e2e, eight complete traces with a hop, two open-loop runs with
    verdicts, step statistics."""
    records = t_timeline.collect_timelines(_events(port_runs, "engine"))
    assert len(records) == 8 and not [e for r in records
                                      for e in t_timeline.check_decomposition(r)]
    traces = t_trace.collect_traces(_events(port_runs, "fleet"))
    assert len(traces) == 8 and all(t["complete"] for t in traces)
    assert max(t["hops"] for t in traces) >= 1
    doc = t_goodput.goodput(_events(port_runs, "wall_60") + _events(port_runs, "wall_2000"))
    assert doc["runs"] == 2 and [r["rate"] for r in doc["rates"]] == [60.0, 2000.0]
    report = t_report.build_report([str(port_runs / "fit")])
    assert report["hosts"]["0"]["step_time_s"]["count"] > 0


def _cli_cases(root, tmp):
    engine, fleet = str(root / "engine"), str(root / "fleet")
    walls = [str(root / "wall_60"), str(root / "wall_2000")]
    tid = t_trace.collect_traces(_events(root, "fleet"))[0]["trace_id"]
    return {
        "report": ["report", engine, fleet, *walls, str(root / "fit"), "-o",
                   str(tmp / "r.json")],
        "report_text": ["report", "--text", str(root / "fit")],
        "validate": ["validate", engine, fleet, *walls, str(root / "fit")],
        "timeline": ["timeline", engine, "--trace", str(tmp / "chrome.json")],
        "timeline_json": ["timeline", "--json", "--width", "16", engine],
        "slo": ["slo", engine, "--percentile", "75", "--text"],
        "trace": ["trace", tid, fleet],
        "fleet": ["fleet", fleet, "--trace", str(tmp / "fleet.json")],
        "fleet_json": ["fleet", "--json", fleet],
        "goodput": ["goodput", *walls],
        "goodput_gate": ["goodput", *walls, "--min-attainment", "1.0", "--text"],
        "tail": ["tail", str(root / "wall_2000" / "events.jsonl"), "--updates", "1",
                 "--interval", "0"],
    }


@pytest.mark.parametrize("sub", ["report", "report_text", "validate", "timeline",
                                 "timeline_json", "slo", "trace", "fleet", "fleet_json",
                                 "goodput", "goodput_gate", "tail"])
def test_cli_on_port_runs_equals_obsctl(port_runs, sub, tmp_path):
    argv = _cli_cases(port_runs, tmp_path)[sub]
    run = pairs.Pairs()
    proc = run.cli_run(subprocess.run)(
        [sys.executable, pairs.OBSCTL, *argv], capture_output=True, text=True,
        cwd=pairs.REPO)
    assert run.calls == {argv[0]: 1}
    if sub == "goodput_gate":
        assert proc.returncode in (0, 2)
    else:
        assert proc.returncode == 0, proc.stderr


def test_cli_diff_of_port_reports_equals_obsctl(port_runs, tmp_path):
    """``diff`` over the port's own reports: clean against itself (rc 0),
    and the engine's serve summary against the fleet's past the threshold
    in both directions."""
    run = pairs.Pairs().cli_run(subprocess.run)
    for name in ("engine", "fleet"):
        doc = t_report.build_report([str(port_runs / name)])
        (tmp_path / f"{name}.json").write_text(json.dumps(doc))
    codes = []
    for a, b, extra in (("engine", "engine", []), ("engine", "fleet", ["--text"]),
                        ("fleet", "engine", ["--threshold-pct", "1"])):
        proc = run([sys.executable, pairs.OBSCTL, "diff", str(tmp_path / f"{a}.json"),
                    str(tmp_path / f"{b}.json"), *extra], capture_output=True, text=True,
                   cwd=pairs.REPO)
        codes.append(proc.returncode)
    assert codes[0] == 0 and set(codes[1:]) <= {0, 2}


# -- the import contract: a box with neither torch nor jax -------------------------

def _poison_cases(three, open_loop, tail, report):
    return {
        "report": (["report", *three], 0, None),
        "report_text": (["report", "--text", *three], 0, "straggler timeline:"),
        "diff": (["diff", report, report], 0, None),
        "validate": (["validate", three[0]], 0, "OK "),
        "timeline": (["timeline", *three], 1, "no request_timeline events"),
        "slo": (["slo", *three], 1, "no request_timeline events"),
        "tail": (["tail", tail, "--updates", "1", "--interval", "0.05"], 0, "waiting=2"),
        "goodput": (["goodput", *three], 1, "no open_loop events"),
        "goodput_open_loop": (["goodput", open_loop], 0, "overall_attainment"),
        "trace": (["trace", "t000000", *three], 1, "no traced serve events"),
        "fleet": (["fleet", *three], 1, "no traced serve events"),
        "lint": (["lint"], 1, "ROADMAP queue 1, item 12"),
    }


@pytest.mark.parametrize("sub", ["report", "report_text", "diff", "validate", "timeline",
                                 "slo", "tail", "goodput", "goodput_open_loop", "trace",
                                 "fleet", "lint"])
def test_every_subcommand_runs_without_torch_or_jax(three_hosts, tmp_path, sub):  # noqa: F811
    """``python -m <port>.obs SUB`` in a subprocess where importing
    ``torch`` or ``jax`` raises: each subcommand runs its whole path (the
    refusals on the fixture's timeline-less, trace-less stream say so, not
    an import error)."""
    report = tmp_path / "report.json"
    report.write_text(json.dumps(t_report.build_report(three_hosts)))
    loop = tmp_path / "loop"
    C._write(str(loop / "events.jsonl"), C._open_loop_run(1, 8.0, 4, missed=(1,)))
    tail = tmp_path / "tail.jsonl"
    tail.write_text(json.dumps(
        {"v": 1, "t": 1000.0, "host": 0, "pid": 1, "type": "serve",
         "event": "iteration_ledger", "iteration": 0, "dur_s": 0.05, "prefill_s": 0.01,
         "decode_s": 0.03, "gather_bucket": 64, "prefill_chunks": 1,
         "prefill_dispatches": 1, "decode_slots": 3, "tokens": 4, "waiting": 2,
         "kv_used_frac": 0.5}) + "\n")
    argv, want_rc, marker = _poison_cases(three_hosts, str(loop), str(tail),
                                          str(report))[sub]
    proc = pairs.run_port_cli(*argv, timeout=60)
    assert proc.returncode == want_rc, (proc.stdout, proc.stderr)
    assert "ModuleNotFoundError" not in proc.stderr and "ImportError" not in proc.stderr
    if marker is not None:
        assert marker in proc.stdout + proc.stderr


def test_package_imports_without_torch_numpy_or_jax():
    """The port's package, ``obs`` and its readers import with ``torch``,
    ``numpy`` and ``jax`` poisoned."""
    code = ("import sys\n"
            "for m in ('torch', 'numpy', 'jax'): sys.modules[m] = None\n"
            f"import {pairs.PORT_PKG}, {pairs.PORT_OBS}\n"
            + "".join(f"import {pairs.PORT_OBS}.{m}\n" for m in (
                "report", "goodput", "timeline", "trace", "schema", "watchdog",
                "__main__"))
            + "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=pairs.REPO,
                                        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and proc.stdout == "ok\n", proc.stderr


def test_resolve_device_still_refuses_cuda_without_a_card():
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()

