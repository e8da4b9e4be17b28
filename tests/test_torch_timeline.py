"""PyTorch port: the request-timeline readers (``obs/timeline.py``: the
Gantt rows, the Chrome trace, SLO attribution, the sliding window and the
live tail) against the JAX package's. The JAX package's
``tests/test_timeline.py`` host cases run with every reader function they
call and every ``scripts/obsctl.py`` run they make paired with the port's
on the same inputs (``tests/torch_obs_pairs.py``: JSON, text, stdout,
stderr, written files and exit codes equal byte for byte); its cases of
the window, the follower and the tail gauges run on the port's classes,
and its live-follow CLI case on ``python -m <port>.obs``; one event stream
through both packages' followers and gauges renders the same lines."""

import inspect
import json

import pytest

import test_timeline as jax_timeline_cases
import torch_obs_pairs as pairs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import timeline as t_timeline
from test_timeline import synthetic_dirs  # noqa: F401  (the fixture the cases take)
from torch_decode_pairs import detached_compile_trackers  # noqa: F401

T = jax_timeline_cases
# the JAX engine's runs (the port's engine runs are held in
# tests/test_torch_serve_engine.py and test_torch_obsctl.py) and the JAX
# package's static analysis
NOT_READERS = ("test_engine_timeline_decomposition_sums_on_real_run",
               "test_engine_timeline_off_restores_pre_tracing_stream",
               "test_engine_overlap_off_restores_pre_overlap_telemetry",
               "test_obs_timeline_runs_without_jax")
CLASSES = ("SlidingWindow", "TailFollower", "TailStats")
CLASS_CASES = ("test_sliding_window_percentile_exact_and_evicting",
               "test_tail_follower_reads_appends_only",
               "test_tail_follower_never_rereads_prefix",
               "test_tail_follower_flags_truncation",
               "test_tail_follower_flags_malformed_complete_lines",
               "test_tail_stats_rolls_ledger_and_ttft",
               "test_tail_stats_rolling_slo_attainment")
LIVE_CASES = ("test_cli_tail_follows_live_appends",)
CASES = [name for name, _ in inspect.getmembers(T, inspect.isfunction)
         if name.startswith("test_") and name not in NOT_READERS + CLASS_CASES + LIVE_CASES]


def _call_case(fn, request):
    return fn(**{name: request.getfixturevalue(name)
                 for name in inspect.signature(fn).parameters})


@pytest.mark.parametrize("case", CASES)
def test_jax_timeline_cases_hold_on_both_packages(case, monkeypatch, request):
    paired = pairs.pair_case(monkeypatch, T, modules=("report", "timeline", "schema"))
    _call_case(getattr(T, case), request)
    assert paired.calls, f"{case} called no reader"


@pytest.mark.parametrize("case", CLASS_CASES)
def test_jax_timeline_class_cases_hold_on_the_port(case, monkeypatch, request):
    pairs.port_classes(monkeypatch, T, CLASSES)
    pairs.pair_case(monkeypatch, T, modules=("report",))
    assert T.TailStats is t_timeline.TailStats
    _call_case(getattr(T, case), request)


@pytest.mark.parametrize("case", LIVE_CASES)
def test_jax_live_tail_case_holds_on_the_port_cli(case, monkeypatch, request, tmp_path):
    monkeypatch.setattr(T, "_OBSCTL", pairs.port_script(tmp_path / "port_obs.py"))
    _call_case(getattr(T, case), request)


def test_phases_equal_the_jax_ones():
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import timeline as j_timeline

    assert t_timeline.PHASES == j_timeline.PHASES
    assert t_timeline._PHASE_CHAR == j_timeline._PHASE_CHAR
    assert sorted(t_timeline.__all__) == sorted(j_timeline.__all__)


@pytest.mark.parametrize("window", [1, 3, 64])
def test_tail_gauges_render_alike_in_both_packages(tmp_path, window):
    """One stream (ledgers, first tokens, finishes with and without
    verdicts, waiting-depth metrics, a malformed line) appended in three
    bursts: both packages' followers return the same events and errors
    poll for poll, and both gauges render the same line."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import timeline as j_timeline

    path = tmp_path / "events.jsonl"
    bursts = [
        [T._ledger_event(i, t=1000.0 + i, tokens=2 + i, waiting=i, kv=0.1 * i)
         for i in range(4)],
        [{"v": 1, "t": 1010.0 + i, "host": 0, "pid": 1, "type": "serve",
          "event": "first_token", "request": i, "ttft_s": 0.01 * (i + 1)} for i in range(5)]
        + [{"v": 1, "t": 1020.0, "host": 0, "pid": 1, "type": "metric",
            "name": "serve/waiting_depth", "value": 9}],
        [{"v": 1, "t": 1030.0 + i, "host": 0, "pid": 1, "type": "serve", "event": "finish",
          "request": i, "tokens": 4, "preemptions": 0, **({"slo_met": i % 3 != 0}
                                                        if i % 2 else {})}
         for i in range(6)]]
    followers = (t_timeline.TailFollower(str(path)), j_timeline.TailFollower(str(path)))
    gauges = (t_timeline.TailStats(window), j_timeline.TailStats(window))
    for k, burst in enumerate(bursts):
        with open(path, "a", encoding="utf-8") as f:
            for e in burst:
                f.write(json.dumps(e) + "\n")
            if k == 1:
                f.write("not json\n")
        got, want = (fol.poll() for fol in followers)
        assert got == want and len(got[0]) == len(burst)
        for gauge, (events, _) in zip(gauges, (got, want)):
            for e in events:
                gauge.update(e)
        assert gauges[0].render() == gauges[1].render()
