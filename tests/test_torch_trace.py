"""PyTorch port: fleet request tracing, the stitching half
(``obs/trace.py``: ``collect_traces``, ``check_trace``, ``fleet_summary``).
The JAX package's ``tests/test_trace.py`` stitch cases run on both
packages (the unported renderers stay the JAX package's and read what the
port stitched); the events of the port's traced runs with a mid-decode
migration, a live drain and a prefill/decode handoff go through both
packages' stitchers, which report the same complete traces, phases and
fleet rollup and find nothing wrong; an untraced stream carries no
``trace_id``/``hop``. Trace records and rollups are held equal exactly
(the stitchers fold the same events with the same arithmetic)."""

import json

import numpy as np
import pytest

import test_trace as jax_trace_cases
from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import schema as t_schema
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import trace as t_trace
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import ServeEngine
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.router import Router
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.transport import (
    migrate_request,
)
from torch_decode_pairs import (  # noqa: F401
    as_port,
    detached_compile_trackers,
    gpt2_pair,
    one_torch_thread,
)

C = jax_trace_cases
RENDERERS = ("trace_text", "fleet_text", "fleet_chrome_trace")
HOST_CASES = [
    ("one_hop", C.test_stitch_one_hop_complete_and_telescoped_phases),
    ("ids_apart", C.test_stitch_keeps_router_scoped_ids_apart),
    ("torn_partial", C.test_stitch_degrades_torn_and_partial_streams_to_flagged),
    ("gap_overlap_sum", C.test_check_trace_names_gap_overlap_and_sum_bugs),
    ("fleet_rollup", C.test_fleet_summary_counts_roles_replicas_and_tenants),
    ("schema_trace_fields", C.test_schema_rejects_mistyped_trace_context_fields),
]


@pytest.mark.parametrize("impl", ["jax_package", "port"])
@pytest.mark.parametrize("case", HOST_CASES, ids=[c[0] for c in HOST_CASES])
def test_jax_trace_cases_hold_on_both_packages(case, impl, monkeypatch):
    _, fn = case
    if impl == "port":
        as_port(monkeypatch, C, keep=RENDERERS)
        assert C.collect_traces is t_trace.collect_traces
        assert C.check_trace is t_trace.check_trace
        assert C.fleet_summary is t_trace.fleet_summary
        monkeypatch.setattr("huggingface_sagemaker_tensorflow_distributed_tpu.obs.schema."
                            "validate_event", t_schema.validate_event)
    fn()


def test_phases_equal_the_jax_ones():
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import trace as j_trace

    assert t_trace.TRACE_PHASES == j_trace.TRACE_PHASES
    assert t_trace._EVENT_ORDER == j_trace._EVENT_ORDER


EOS = 127
_KW = dict(num_slots=2, block_size=4, num_blocks=40, prefill_chunk=8, max_model_len=64,
           gather_buckets=[16, 32], timeline="on")


@pytest.fixture(scope="module")
def pair():
    return gpt2_pair(num_layers=2, vocab=128, eos_token_id=EOS, pad_token_id=0)


def _events(out):
    return [e for _, e, err in t_schema.iter_events(str(out / "events.jsonl")) if err is None]


def _both_stitchers(events):
    """Both packages' traces of one stream: (port traces, the JAX ones),
    after checking them equal record for record with no finding."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import trace as j_trace

    got, want = t_trace.collect_traces(events), j_trace.collect_traces(events)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    for tr in got:
        assert tr["complete"], tr["incomplete"]
        assert t_trace.check_trace(tr) == [] == j_trace.check_trace(tr)
    assert (json.dumps(t_trace.fleet_summary(got), sort_keys=True)
            == json.dumps(j_trace.fleet_summary(want), sort_keys=True))
    return got, want


def test_mid_decode_migration_stitches_complete_in_both_packages(pair, tmp_path):
    """A traced request moved mid-decode between two replicas: one complete
    hop-1 trace in both packages, the transport priced, the hop clock
    covering the extraction, the stitched TTFT the engine's own, tokens
    exact; the stream valid under both packages' schemas."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs.schema import (
        validate_events_file as jax_validate,
    )

    _, _, model = pair
    rng = np.random.RandomState(3)
    prompt = rng.randint(1, 120, (9,)).astype(np.int32)
    base = ServeEngine(model, device="cpu", **_KW)
    breq = base.submit(prompt, 10)
    base.run()
    out = tmp_path / "mid_decode"
    obs.reset(out_dir=str(out), enabled=True)
    try:
        src, dst = ServeEngine(model, device="cpu", **_KW), ServeEngine(model, device="cpu", **_KW)
        src.replica, dst.replica = 0, 1
        req = src.submit(prompt, 10, trace_id="t000000")
        while src.has_work() and len(req.output) < 4:
            src.step()
        assert len(req.output) >= 1
        assert migrate_request(src, dst, req.rid) is not None and req.hop == 1
        dst.run()
        obs.flush()
    finally:
        obs.reset()
    assert list(dst.output_ids(req)) == list(base.output_ids(breq))
    for validate in (t_schema.validate_events_file, jax_validate):
        n, errors = validate(str(out / "events.jsonl"))
        assert n > 0 and not errors
    (tr,), _ = _both_stitchers(_events(out))
    assert tr["hops"] == 1 and tr["replicas"] == [0, 1]
    assert tr["phases"]["transport"] > 0
    (mig,) = tr["migrates"]
    assert mig["transport_hop_s"] >= mig["extract_s"] >= 0
    assert mig["from_replica"] == 0 and mig["to_replica"] == 1
    assert tr["ttft_s"] == pytest.approx(req.ttft_s, abs=1e-6)
    via = [s for s in tr["timeline"]["segments"] if s.get("via") == "migrate"]
    assert len(via) == 1 and via[0]["hop"] == 1 and via[0]["replica"] == 1


@pytest.mark.parametrize("fleet", ["drain", "roles"])
def test_traced_fleet_runs_stitch_alike_in_both_packages(pair, tmp_path, fleet):
    """A two-replica run drained mid-trace (requeues and live migrations)
    and a prefill/decode fleet (every request handed over once): every
    request one complete trace in both packages, equal records and rollups,
    the router's transport tail priced."""
    _, _, model = pair
    rng = np.random.RandomState(1)
    trace = [(rng.randint(1, 120, (int(rng.randint(5, 13)),)).astype(np.int32),
              int(rng.randint(3, 9))) for _ in range(8)]
    out = tmp_path / fleet
    obs.reset(out_dir=str(out), enabled=True)
    try:
        if fleet == "drain":
            router = Router(model, replicas=2, placement="round_robin", device="cpu", **_KW)
        else:
            router = Router(model, roles="prefill:1,decode:1", device="cpu", **_KW)
        reqs = [router.submit(p, m) for p, m in trace]
        if fleet == "drain":
            router.warmup()
            for _ in range(3):
                router.step()
            router.drain(0)
        router.run()
        obs.flush()
    finally:
        obs.reset()
    assert router.migrations > 0
    traces, _ = _both_stitchers(_events(out))
    assert len(traces) == len(trace)
    assert {t["request"] for t in traces} == {q.rid for q in reqs}
    hops = {t["trace_id"]: t["hops"] for t in traces}
    assert hops == {q.trace_id: q.hop for q in reqs}
    if fleet == "roles":
        assert set(hops.values()) == {1}
        roles = t_trace.fleet_summary(traces)["per_role"]
        assert roles["prefill"]["replicas"] == [0] and roles["decode"]["replicas"] == [1]
    assert router.slo_summary()["transport_hop_s_p99"] > 0


def test_untraced_stream_carries_no_trace_fields(pair, tmp_path):
    _, _, model = pair
    out = tmp_path / "untraced"
    obs.reset(out_dir=str(out), enabled=True)
    try:
        eng = ServeEngine(model, device="cpu", **_KW)
        eng.submit(np.arange(1, 9, dtype=np.int32), 4)
        eng.run()
        router = Router(model, replicas=2, trace="off", device="cpu", **_KW)
        for i in range(3):
            router.submit(np.arange(1, 9 + i, dtype=np.int32), 4)
        router.run()
        obs.flush()
    finally:
        obs.reset()
    events = _events(out)
    assert events and all("trace_id" not in e and "hop" not in e for e in events)
    assert t_trace.collect_traces(events) == []
    assert t_trace.fleet_summary([]) == {"traces": 0, "complete_traces": 0,
                                         "trace_stitch_failures": 0}
