"""PyTorch port: the open-loop load generator (``serve/loadgen.py``). The
JAX package's ``tests/test_loadgen.py`` host cases run on both packages
(generators, knob parsing, ``SloSpec``); arrivals, lengths and
``make_schedule`` equal the JAX draws element for element; on the same
schedule a virtual-clock ``OpenLoopDriver`` over the port's two-replica
router gives the JAX driver's summary field for field (its accounting is
a function of the schedule, the tokens and the iteration count); a
virtual replay is byte-identical, a one-replica router replays the bare
engine, the driver is one-shot, and the wall clock's verdicts ride the
events. Tokens, placements and counts are held exactly; the summaries
hold their percentiles of virtual times exactly too (the same ticks in
both packages)."""

import json

import pytest

import test_loadgen as jax_loadgen_cases
from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import schema as t_schema
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve import loadgen as t_loadgen
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import ServeEngine
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.router import Router
from torch_decode_pairs import (  # noqa: F401
    as_port,
    detached_compile_trackers,
    gpt2_pair,
    one_torch_thread,
)

C = jax_loadgen_cases
HOST_CASES = [
    ("poisson", C.test_poisson_arrivals_deterministic_monotone, False),
    ("bursty", C.test_bursty_arrivals_deterministic_and_bursty, False),
    ("heavy_tailed", C.test_heavy_tailed_lengths_bounded_deterministic, False),
    ("make_schedule", C.test_make_schedule_deterministic_sorted_and_grouped, False),
    ("slospec", C.test_slospec_validation, False),
    ("parse_arrival", C.test_parse_arrival_specs_and_env, True),
    ("parse_arrival_seed", C.test_parse_arrival_seed_env, True),
    ("parse_slo", C.test_parse_slo_specs_and_env, True),
]


@pytest.mark.parametrize("impl", ["jax_package", "port"])
@pytest.mark.parametrize("case", HOST_CASES, ids=[c[0] for c in HOST_CASES])
def test_jax_loadgen_host_cases_hold_on_both_packages(case, impl, monkeypatch):
    _, fn, wants_monkeypatch = case
    if impl == "port":
        as_port(monkeypatch, C)
        assert C.make_schedule is t_loadgen.make_schedule
        assert C.OpenLoopDriver is t_loadgen.OpenLoopDriver
    fn(monkeypatch) if wants_monkeypatch else fn()


@pytest.mark.parametrize("kw", [
    dict(process="poisson", rate=7.5, seed=0),
    dict(process="poisson", rate=500.0, seed=11, prompt_lo=32, prompt_hi=128, new_lo=8,
         new_hi=24, eos_token_id=126),
    dict(process="bursty", rate=40.0, rate_lo=4.0, p_switch=0.3, seed=9,
         groups=("a", "b", "c"), deadline_s=[0.5, 2.0], priorities=(0, 1)),
    dict(process="bursty", rate=100000.0, seed=3, alpha=1.1, deadline_s=1.5)],
    ids=["poisson", "poisson_disagg", "bursty_grouped", "bursty_heavy"])
def test_schedules_equal_the_jax_draws(kw):
    """``make_schedule`` and its parts give the JAX package's draws exactly:
    the same arrival times (float equality), lengths, tokens and riders."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve import loadgen as j_loadgen

    assert t_loadgen.make_schedule(24, 128, **kw) == j_loadgen.make_schedule(24, 128, **kw)
    assert (t_loadgen.poisson_arrivals(3.0, 40, seed=kw["seed"])
            == j_loadgen.poisson_arrivals(3.0, 40, seed=kw["seed"]))
    assert (t_loadgen.bursty_arrivals(50.0, 1.0, 0.2, 40, seed=kw["seed"])
            == j_loadgen.bursty_arrivals(50.0, 1.0, 0.2, 40, seed=kw["seed"]))
    assert (t_loadgen.heavy_tailed_lengths(60, 4, 64, seed=kw["seed"], alpha=1.2)
            == j_loadgen.heavy_tailed_lengths(60, 4, 64, seed=kw["seed"], alpha=1.2))


def test_knobs_and_constants_equal_the_jax_ones(monkeypatch):
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve import loadgen as j_loadgen

    for name in ("ENV_ARRIVAL", "ENV_ARRIVAL_SEED", "ENV_SLO_TTFT", "ENV_SLO_TPOT",
                 "PROCESSES", "CLOCKS", "MISS_PHASES"):
        assert getattr(t_loadgen, name) == getattr(j_loadgen, name), name
    for spec in ("closed", "", "poisson:2.5", "bursty:4,0.5,0.25", "POISSON:8"):
        assert t_loadgen.parse_arrival(spec) == j_loadgen.parse_arrival(spec)
    for bad in ("poisson", "poisson:0", "bursty:1,2", "wat:1"):
        with pytest.raises(ValueError) as want:
            j_loadgen.parse_arrival(bad)
        with pytest.raises(ValueError) as got:
            t_loadgen.parse_arrival(bad)
        assert str(got.value) == str(want.value)
    # both import paths of the deadline knob
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve import policy

    assert t_loadgen.SloSpec is policy.SloSpec and t_loadgen.parse_slo is policy.parse_slo


# -- the driver on real engines ------------------------------------------------

EOS = 127
_ENGINE_KW = dict(num_slots=2, block_size=8, num_blocks=17, prefill_chunk=8,
                  max_model_len=64, timeline="off")


@pytest.fixture(scope="module")
def pair():
    return gpt2_pair(num_layers=2, vocab=128, eos_token_id=EOS, pad_token_id=0)


def _schedule(rate=50.0, n=6):
    return t_loadgen.make_schedule(n, 128, process="poisson", rate=rate, seed=3,
                                   prompt_lo=4, prompt_hi=10, new_lo=3, new_hi=6,
                                   eos_token_id=EOS, groups=("a", "b"))


def _drive_port(model, schedule, slo, replicas=2, target="router", clock="virtual", rate=None):
    if target == "engine":
        t = ServeEngine(model, device="cpu", **_ENGINE_KW)
    else:
        t = Router(model, replicas=replicas, device="cpu", **_ENGINE_KW)
    drv = t_loadgen.OpenLoopDriver(t, schedule, clock=clock, tick_s=0.001, slo=slo,
                                   process="poisson", rate=rate)
    finished = drv.run()
    return t, [list(finished[rid].output) for rid in sorted(finished)], drv.summary()


def _drive_jax(jmodel, params, schedule, slo, rate=None):
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve import loadgen as j_loadgen
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve.router import Router as JRouter

    r = JRouter(jmodel, params, replicas=2, **_ENGINE_KW)
    jslo = None if slo is None else j_loadgen.SloSpec(ttft_s=slo.ttft_s, tpot_s=slo.tpot_s)
    drv = j_loadgen.OpenLoopDriver(r, schedule, clock="virtual", tick_s=0.001, slo=jslo,
                                   process="poisson", rate=rate)
    finished = drv.run()
    return r, [list(finished[rid].output) for rid in sorted(finished)], drv.summary()


@pytest.mark.parametrize("rate,slo", [
    (50.0, t_loadgen.SloSpec(ttft_s=0.02, tpot_s=0.01)),
    (100000.0, t_loadgen.SloSpec(ttft_s=0.003)),
    (400.0, None)], ids=["underload", "overload", "no_slo"])
def test_virtual_summary_equals_the_jax_drivers(pair, rate, slo):
    """The same schedule through the JAX driver over the JAX two-replica
    router and the port's: the same tokens, the same owners, and the
    summary equal field for field (the virtual TTFT/TPOT percentiles
    included, exact)."""
    jmodel, params, model = pair
    schedule = _schedule(rate, n=8)
    jr, jouts, jsum = _drive_jax(jmodel, params, schedule, slo, rate)
    tr, touts, tsum = _drive_port(model, schedule, slo, rate=rate)
    assert touts == jouts
    assert json.dumps(tsum, sort_keys=True) == json.dumps(jsum, sort_keys=True)
    assert ([tr.replica_of(rid) for rid in sorted(tr.finished)]
            == [jr.replica_of(rid) for rid in sorted(jr.finished)])
    for key in ("requests", "tokens", "iterations", "arrival_backlog_peak",
                "replica_load_imbalance"):
        assert tr.slo_summary().get(key) == jr.slo_summary().get(key), key


def test_virtual_replay_is_byte_identical(pair, tmp_path):
    """Same seed and schedule: the same outputs, byte-identical summaries
    and the same normalized event streams across reruns and across a
    one-replica router against the bare engine; ``open_loop`` leads each
    stream and every submit carries its arrival stamp."""
    _, _, model = pair
    slo = t_loadgen.SloSpec(ttft_s=0.02, tpot_s=0.01)
    runs = []
    for name, target in (("a", "engine"), ("b", "engine"), ("c", "router")):
        obs.reset(out_dir=str(tmp_path / name), enabled=True)
        try:
            _, outs, summary = _drive_port(model, _schedule(), slo, replicas=1,
                                           target=target, rate=50.0)
            obs.flush()
        finally:
            obs.reset()
        events = [e for _, e, err in t_schema.iter_events(str(tmp_path / name / "events.jsonl"))
                  if err is None and e["type"] == "serve"]
        runs.append((outs, summary, jax_loadgen_cases._normalize(events), events))
    outs0, sum0, norm0, ev0 = runs[0]
    assert all(outs0) and sum0["slo_attainment"] == 1.0 and sum0["clock"] == "virtual"
    for outs, summary, norm, _ in runs[1:]:
        assert outs == outs0 and norm == norm0
        assert json.dumps(summary, sort_keys=True) == json.dumps(sum0, sort_keys=True)
    assert ev0[0]["event"] == "open_loop" and ev0[0]["requests"] == 6
    assert all("arrival_s" in e for e in ev0 if e["event"] == "submit")


def test_virtual_overload_is_queue_dominant(pair):
    """Far past capacity: attainment below 1, queue the dominant miss
    phase, every miss queue-attributed, a backlog peak above 0."""
    _, _, model = pair
    eng, _, s = _drive_port(model, _schedule(rate=100000.0), t_loadgen.SloSpec(ttft_s=0.003),
                            target="engine", rate=100000.0)
    assert 0.0 < s["slo_attainment"] < 1.0
    assert s["dominant_miss_phase"] == "queue"
    assert s["miss_phases"]["queue"] == s["slo_missed"]
    assert set(s["group_slo_attainment"]) == {"a", "b"}
    assert eng.slo_summary()["arrival_backlog_peak"] > 0


def test_driver_is_one_shot(pair):
    _, _, model = pair
    eng = ServeEngine(model, device="cpu", **_ENGINE_KW)
    drv = t_loadgen.OpenLoopDriver(eng, _schedule(), clock="virtual")
    drv.run()
    with pytest.raises(RuntimeError, match="one-shot"):
        drv.run()
    with pytest.raises(ValueError):
        t_loadgen.OpenLoopDriver(eng, _schedule(), clock="sundial")
    with pytest.raises(ValueError):
        t_loadgen.OpenLoopDriver(eng, _schedule(), tick_s=0.0)


def test_rate_limited_submits_are_recorded_not_served(pair):
    """A per-tenant bucket on the router's virtual clock: the rejected
    arrivals count in ``rate_limited`` and stay out of the attainment."""
    _, _, model = pair
    r = Router(model, replicas=2, device="cpu", rate_limit="a=1:1", **_ENGINE_KW)
    drv = t_loadgen.OpenLoopDriver(r, _schedule(rate=1000.0), clock="virtual",
                                   slo=t_loadgen.SloSpec(ttft_s=1.0), rate=1000.0)
    finished = drv.run()
    s = drv.summary()
    assert s["rate_limited"] == r.rate_limited > 0
    assert len(finished) + s["rate_limited"] == 6
    assert s["slo_met"] + s["slo_missed"] == len(finished)


def test_wall_slo_verdicts_ride_the_stream(pair, tmp_path):
    """The wall clock threads ``slo`` into submit: finish events carry the
    verdicts, the report the attainment and the backlog peak, submits the
    arrival stamp and the target; the stream passes both packages'
    schema validators."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import schema as j_schema

    _, _, model = pair
    out = tmp_path / "wall"
    obs.reset(out_dir=str(out), enabled=True)
    try:
        eng, _, s = _drive_port(model, _schedule(rate=200.0),
                                t_loadgen.SloSpec(ttft_s=5.0, tpot_s=5.0), target="engine",
                                clock="wall", rate=200.0)
        assert eng.slo_summary()["slo_attainment"] == 1.0 == s["slo_attainment"]
        obs.flush()
    finally:
        obs.reset()
    for validate in (t_schema.validate_events_file, j_schema.validate_events_file):
        n, errors = validate(str(out / "events.jsonl"))
        assert n > 0 and not errors
    serve = [e for _, e, err in t_schema.iter_events(str(out / "events.jsonl"))
             if err is None and e["type"] == "serve"]
    finishes = [e for e in serve if e["event"] == "finish"]
    assert len(finishes) == 6 and all(e["slo_met"] and e["slack_s"] > 0 for e in finishes)
    (report,) = [e for e in serve if e["event"] == "report"]
    assert report["slo_attainment"] == 1.0 and "arrival_backlog_peak" in report
    assert all(e["arrival_s"] > 0 and e["slo_ttft_s"] == 5.0
               for e in serve if e["event"] == "submit")


def test_closed_loop_stream_has_no_open_loop_fields(pair, tmp_path):
    _, _, model = pair
    out = tmp_path / "closed"
    obs.reset(out_dir=str(out), enabled=True)
    try:
        eng = ServeEngine(model, device="cpu", **_ENGINE_KW)
        for _, spec in _schedule():
            eng.submit(spec["prompt"], spec["max_new_tokens"])
        eng.run()
        assert not {"slo_attainment", "arrival_backlog_peak"} & set(eng.slo_summary())
        obs.flush()
    finally:
        obs.reset()
    new_fields = {"arrival_s", "slo_ttft_s", "slo_tpot_s", "slo_met", "ttft_slo_met",
                  "tpot_slo_met", "slack_s", "slo_attainment", "group_slo_attainment",
                  "arrival_backlog", "arrival_backlog_peak", "trace_id", "hop", "replica"}
    for _, e, err in t_schema.iter_events(str(out / "events.jsonl")):
        assert err is None
        if e["type"] == "serve":
            assert not new_fields & set(e), e
