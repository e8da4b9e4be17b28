"""PyTorch port: admission policies (``serve/policy.py``) and the
scheduler's policy hooks. The JAX package's ``tests/test_policy.py``
host-side cases run against both packages (knob parsing, token buckets
and the rate-limit grammar, the ``slo`` key's order, the aging tier,
cache-aware demand, the scheduler's admission order, the 300-step
property schedule, the schema's typed riders); the port's ``parse_slo``
equals the JAX one; and the port's engine under ``policy='slo'`` orders
admission by deadline, keeps the fifo tokens, and emits the JAX engine's
serve events with the JAX engine's field sets, valid under both
packages' schema validators."""

import numpy as np
import pytest

import test_policy as jax_policy_cases
from huggingface_sagemaker_tensorflow_distributed_tpu.obs import schema as j_schema
from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import schema as t_schema
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve import policy as t_policy
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import ServeEngine
from torch_decode_pairs import (  # noqa: F401
    as_port,
    detached_compile_trackers,
    gpt2_pair,
    one_torch_thread,
)

C = jax_policy_cases
HOST_CASES = [
    ("parse_policy", C.test_parse_policy_default_env_and_errors, True),
    ("parse_aging", C.test_parse_aging_default_env_and_errors, True),
    ("sched_env", C.test_scheduler_reads_policy_env, True),
    ("token_bucket", C.test_token_bucket_refill_burst_and_backwards_clock, False),
    ("rate_limit", C.test_parse_rate_limit_dict_string_and_errors, False),
    ("rate_limited", C.test_rate_limited_is_structured_and_frozen, False),
    ("origin", C.test_request_origin_prefers_arrival_over_submit, False),
    ("slo_key", C.test_slo_key_priority_deadline_demand_rid_order, False),
    ("aging_tier", C.test_aging_tier_promotes_fifo_by_origin_ahead_of_priorities, False),
    ("demand", C.test_demand_blocks_is_cache_aware_and_swap_exact, False),
    ("deadline_order", C.test_slo_admission_orders_by_deadline_not_arrival, False),
    ("smaller_fills", C.test_smaller_demand_fills_slot_the_frontrunner_cannot, False),
    ("aging_blocks", C.test_aging_promoted_request_blocks_all_younger_admission, False),
    ("property_300", C.test_slo_schedule_property_300_steps, False),
    ("schema_riders", C.test_schema_types_policy_riders_and_rejects_mistypes, False),
]


@pytest.mark.parametrize("impl", ["jax_package", "port"])
@pytest.mark.parametrize("case", HOST_CASES, ids=[c[0] for c in HOST_CASES])
def test_jax_policy_cases_hold_on_both_packages(case, impl, monkeypatch):
    _, fn, wants_monkeypatch = case
    if impl == "port":
        as_port(monkeypatch, C)
        monkeypatch.setattr(C, "validate_event", t_schema.validate_event)
        assert C.SloPolicy is t_policy.SloPolicy
    fn(monkeypatch) if wants_monkeypatch else fn()


def test_parse_slo_equals_the_jax_one(monkeypatch):
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve import loadgen

    for spec in ("ttft:0.5", "tpot:0.02,ttft:1", "none", "", " TTFT:2 "):
        got, want = t_policy.parse_slo(spec), loadgen.parse_slo(spec)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.ttft_s, got.tpot_s) == (want.ttft_s, want.tpot_s)
    for bad in ("ttft", "ttft:1,ttft:2", "latency:3", "ttft:-1"):
        for parse in (t_policy.parse_slo, loadgen.parse_slo):
            with pytest.raises(ValueError):
                parse(bad)
    monkeypatch.setenv(t_policy.ENV_SLO_TPOT, "0.1")
    monkeypatch.delenv(t_policy.ENV_SLO_TTFT, raising=False)
    assert t_policy.parse_slo(None) == t_policy.SloSpec(tpot_s=0.1)
    assert t_policy.ENV_SLO_TTFT == loadgen.ENV_SLO_TTFT
    with pytest.raises(ValueError, match="at least one"):
        t_policy.SloSpec()


# -- the engine ----------------------------------------------------------------

ENGINE_KW = dict(num_slots=2, block_size=4, num_blocks=20, prefill_chunk=8,
                 max_model_len=64, kernel="xla", overlap="off")


@pytest.fixture(scope="module")
def pair():
    return gpt2_pair(num_layers=2, vocab=128, eos_token_id=127, pad_token_id=0)


def _trace(seed, shapes):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 120, (p,)).astype(np.int32), m) for p, m in shapes]


def _port_events(model, trace, out_dir, submit_kw=None, **kw):
    obs.reset(out_dir=str(out_dir), enabled=True)
    try:
        eng = ServeEngine(model, device="cpu", **kw)
        reqs = [eng.submit(p, m, **(submit_kw(i) if submit_kw else {}))
                for i, (p, m) in enumerate(trace)]
        eng.run()
        outs = [[int(t) for t in eng.output_ids(r)] for r in reqs]
        summary = eng.slo_summary()
    finally:
        obs.reset()
    n, errors = t_schema.validate_events_file(str(out_dir / "events.jsonl"))
    assert not errors and n > 0
    events = [e for _, e, err in t_schema.iter_events(str(out_dir / "events.jsonl"))
              if err is None and e["type"] == "serve"]
    assert all(j_schema.validate_event(e) == [] for e in events)
    return events, outs, summary, reqs


def _jax_events(jmodel, params, trace, out_dir, submit_kw=None, **kw):
    from huggingface_sagemaker_tensorflow_distributed_tpu import obs as j_obs
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve.engine import (
        ServeEngine as JaxServeEngine,
    )

    j_obs.reset(out_dir=str(out_dir), enabled=True)
    try:
        eng = JaxServeEngine(jmodel, params, **kw)
        reqs = [eng.submit(p, m, **(submit_kw(i) if submit_kw else {}))
                for i, (p, m) in enumerate(trace)]
        eng.run()
        outs = [[int(t) for t in eng.output_ids(r)] for r in reqs]
        j_obs.flush()
    finally:
        j_obs.reset(enabled=False)
    return [e for _, e, err in j_schema.iter_events(str(out_dir / "events.jsonl"))
            if err is None and e["type"] == "serve"], outs


def _shape(events):
    return [(e["event"], tuple(sorted(set(e) - {"request", "t", "pid", "host"})))
            for e in events]


def test_slo_engine_matches_the_jax_engine_events_and_tokens(pair, tmp_path):
    """``policy='slo'`` with deadlines, priorities and a TTFT target: the
    port's tokens equal the JAX engine's (and fifo's), its serve events are
    the JAX engine's events with the same fields in the same order, the
    finish events carry the deadline verdicts and the summary the policy's
    rollups."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve.loadgen import SloSpec

    jmodel, params, model = pair
    trace = _trace(9, [(6, 5), (9, 6), (5, 4), (12, 7)])

    def kw(i, slo):
        return dict(deadline_s=(1e-9 if i % 2 else 1e6), priority=i % 2, slo=slo)

    events, outs, summary, reqs = _port_events(
        model, trace, tmp_path / "port", lambda i: kw(i, t_policy.SloSpec(ttft_s=30.0)),
        policy="slo", aging_s=60.0, **ENGINE_KW)
    j_events, j_outs = _jax_events(jmodel, params, trace, tmp_path / "jax",
                                   lambda i: kw(i, SloSpec(ttft_s=30.0)),
                                   policy="slo", aging_s=60.0, **ENGINE_KW)
    assert outs == j_outs
    assert _shape(events) == _shape(j_events)
    _, fifo_outs, fifo_summary, _ = _port_events(model, trace, tmp_path / "fifo", **ENGINE_KW)
    assert fifo_outs == outs
    assert summary["policy"] == "slo" and summary["deadline_miss_frac"] == 0.5
    assert set(summary["priority_slo_attainment"]) == {"0", "1"}
    assert [r.deadline_miss for r in reqs] == [False, True] * 2
    assert all(r.slo_met for r in reqs) and summary["slo_attainment"] == 1.0
    assert not {"policy", "deadline_miss_frac", "aging_promotions"} & set(fifo_summary)
    finishes = [e for e in events if e["event"] == "finish"]
    assert len(finishes) == 4 and all("deadline_miss" in e for e in finishes)


def test_fifo_stream_is_the_default_engines(pair, tmp_path):
    """``policy='fifo'`` is the default engine: the same events with the
    same fields in the same order, and no policy field anywhere."""
    _, _, model = pair
    trace = _trace(7, [(5, 6), (11, 4), (7, 8), (4, 5)])
    ev_a, outs_a, sum_a, _ = _port_events(model, trace, tmp_path / "a", **ENGINE_KW)
    ev_b, outs_b, sum_b, _ = _port_events(model, trace, tmp_path / "b", policy="fifo",
                                          **ENGINE_KW)
    assert _shape(ev_a) == _shape(ev_b) and outs_a == outs_b
    policy_fields = {"policy", "deadline_s", "priority", "deadline_miss",
                     "aging_promotions", "deadline_miss_frac", "priority_slo_attainment"}
    for events, summary in ((ev_a, sum_a), (ev_b, sum_b)):
        assert not [k for e in events for k in e if k in policy_fields]
        assert not policy_fields & set(summary)


def test_slo_admits_by_deadline_on_one_slot(pair):
    """One slot, four requests submitted with deadlines 40, 10, 30, 20 s:
    ``policy='slo'`` serves them in deadline order, fifo in submission
    order; the tokens are the same."""
    _, _, model = pair
    trace = _trace(11, [(5, 3)] * 4)
    deadlines = (40.0, 10.0, 30.0, 20.0)
    runs = {}
    for policy in ("slo", "fifo"):
        eng = ServeEngine(model, device="cpu", policy=policy, **{**ENGINE_KW, "num_slots": 1})
        reqs = [eng.submit(p, m, deadline_s=d) for (p, m), d in zip(trace, deadlines)]
        eng.run()
        order = [r.deadline_s for r in sorted(reqs, key=lambda r: r.first_token_t)]
        runs[policy] = (order, [[int(t) for t in eng.output_ids(r)] for r in reqs])
    assert runs["slo"][0] == sorted(deadlines)
    assert runs["fifo"][0] == list(deadlines)
    assert runs["slo"][1] == runs["fifo"][1]
