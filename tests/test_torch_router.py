"""PyTorch port: the multi-replica router (``serve/router.py``) and the
serving CLI's fleet flags. The same trace goes through the JAX ``Router``
and the port's on the same weights under each placement and under
``roles="prefill:1,decode:1"``, and through a forced mid-trace drain: the
tokens, every request's replica, the fallback, drain, requeue and
migration counts and the deterministic fields of ``slo_summary()`` are
equal (exact; the wall-clock percentiles are not compared). On the port:
the randomized submit/drain/restart schedule conserves every request and
every block, affinity keeps families sticky and its index aged, the skew
bound falls back to load, a rejected submit moves no placement state, a
one-replica router's events are the bare engine's, and a two-replica
stream is tagged and valid under both packages' schema validators. The
CLI runs ``--replicas``, ``--placement``, ``--roles``, ``--arrival`` and
``--rate_limit`` with the one-engine run's tokens and the JAX fleet
summary's keys."""

import contextlib
import io
import json

import numpy as np
import pytest

import test_router as jax_router_cases
import test_transport as jax_transport_cases
from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import schema as t_schema
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve import cli
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve import router as t_router
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import ServeEngine
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.router import Router
from torch_decode_pairs import (  # noqa: F401
    as_port,
    detached_compile_trackers,
    gpt2_pair,
    one_torch_thread,
)

EOS = 127
_KW = dict(num_slots=2, block_size=4, num_blocks=40, prefill_chunk=8, max_model_len=64)
_TIGHT = dict(_KW, num_blocks=14)


@pytest.fixture(scope="module")
def pair():
    return gpt2_pair(num_layers=2, vocab=128, eos_token_id=EOS, pad_token_id=0)


def _trace(seed=0, n=6):
    return jax_router_cases._trace(seed, n)


def _single(model, trace, **kw):
    eng = ServeEngine(model, device="cpu", **kw)
    reqs = [eng.submit(p, m) for p, m in trace]
    eng.run()
    return [[int(t) for t in eng.output_ids(r)] for r in reqs]


# the summary fields a run's scheduling decides (the rest are wall times)
_DETERMINISTIC = ("requests", "replicas", "placement", "tokens", "iterations", "preemptions",
                  "peak_waiting_depth", "drains", "requeues", "migrations", "migration_bytes",
                  "replica_load_imbalance", "affinity_fallbacks", "prefix_cache",
                  "prefix_cached_tokens", "cache_hit_rate", "per_replica", "roles")
_PER_ROLE = ("replicas", "prefill_chunks", "prefill_dispatches", "decode_steps",
             "migrations_out", "migrations_in")


def _deterministic(summary: dict) -> dict:
    out = {k: summary[k] for k in _DETERMINISTIC if k in summary}
    if "per_role" in summary:
        out["per_role"] = {role: {k: row[k] for k in _PER_ROLE}
                           for role, row in summary["per_role"].items()}
    return out


def _run_both(pair, trace, router_kw, drive=None, **kw):
    """The trace through the JAX router and the port's: (outputs, owners,
    counts, summary) of each."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve.router import Router as JRouter

    jmodel, params, model = pair
    out = []
    for build in (lambda: JRouter(jmodel, params, **router_kw, **kw),
                  lambda: Router(model, device="cpu", **router_kw, **kw)):
        r = build()
        reqs = [r.submit(p, m) for p, m in trace]
        if drive is not None:
            drive(r)
        r.run()
        out.append(([[int(t) for t in r.output_ids(q)] for q in reqs],
                    [r.replica_of(q) for q in reqs],
                    (r.affinity_fallbacks, r.drains, r.requeues, r.migrations),
                    _deterministic(r.slo_summary()), r))
    return out


@pytest.mark.parametrize("router_kw", [
    dict(replicas=2, placement="round_robin"), dict(replicas=2, placement="least_loaded"),
    dict(replicas=2, placement="affinity"), dict(replicas=2, placement="length_aware"),
    dict(roles="prefill:1,decode:1")],
    ids=["round_robin", "least_loaded", "affinity", "length_aware", "roles"])
def test_router_matches_the_jax_router(pair, router_kw):
    """Tokens, owners, counts and the scheduling-decided summary fields
    equal the JAX router's, and equal the one engine's tokens."""
    (j_outs, j_own, j_counts, j_sum, _), (t_outs, t_own, t_counts, t_sum, r) = _run_both(
        pair, _trace(n=8), router_kw, **_KW)
    assert t_outs == j_outs == _single(pair[2], _trace(n=8), **_KW)
    assert t_own == j_own and t_counts == j_counts
    assert t_sum == j_sum
    if "roles" in router_kw:
        assert t_counts[3] == 8 and r.engines[0].decode_steps == 0
    else:
        assert set(t_own) == {0, 1}


def test_router_templated_affinity_matches_the_jax_router(pair):
    """Families behind shared prefixes: affinity keeps each on one replica
    in both packages, the same fallbacks and hit rates."""
    rng = np.random.RandomState(5)
    prefixes = [rng.randint(1, 120, (12,)).astype(np.int32) for _ in range(2)]
    trace = [(np.concatenate([prefixes[f], rng.randint(1, 120, (3,)).astype(np.int32)]), 4)
             for _ in range(3) for f in range(2)]
    (j_outs, j_own, j_counts, j_sum, _), (t_outs, t_own, t_counts, t_sum, _) = _run_both(
        pair, trace, dict(replicas=2, placement="affinity"), **_KW)
    assert (t_outs, t_own, t_counts, t_sum) == (j_outs, j_own, j_counts, j_sum)
    assert len(set(t_own[0::2])) == 1 and len(set(t_own[1::2])) == 1
    assert t_sum["cache_hit_rate"] > 0


def test_router_drain_mid_trace_matches_the_jax_router(pair):
    """A drain of replica 0 after two fleet steps: the waiting requeue and
    the residents migrate live, in both packages alike; every pool comes
    back free."""
    def drive(r):
        r.warmup()
        for _ in range(2):
            r.step()
        r.drain(0)

    (j_outs, j_own, j_counts, j_sum, _), (t_outs, t_own, t_counts, t_sum, r) = _run_both(
        pair, _trace(n=8), dict(replicas=2, placement="round_robin"), drive=drive, **_TIGHT)
    assert t_outs == j_outs == _single(pair[2], _trace(n=8), **_TIGHT)
    assert (t_own, t_counts, t_sum) == (j_own, j_counts, j_sum)
    assert t_counts[1] == 1 and t_counts[2] > 0 and t_counts[3] > 0
    for eng in r.engines:
        assert eng.blocks.num_used == 0
        assert eng.blocks.num_free + eng.blocks.num_cached == eng.blocks.num_blocks - 1
        assert not eng._migrated_in and not eng._migrate_hold


def test_router_sampled_streams_bitwise_across_placement(pair):
    """Sampled requests draw noise from (seed, token index): two replicas
    and one engine give the same streams."""
    _, _, model = pair
    rng = np.random.RandomState(3)
    trace = [(rng.randint(1, 120, (7,)).astype(np.int32), 6, 11 + i) for i in range(4)]
    eng = ServeEngine(model, device="cpu", **_KW)
    ereqs = [eng.submit(p, m, temperature=0.9, top_k=20, seed=s) for p, m, s in trace]
    eng.run()
    router = Router(model, replicas=2, placement="least_loaded", device="cpu", **_KW)
    rreqs = [router.submit(p, m, temperature=0.9, top_k=20, seed=s) for p, m, s in trace]
    router.run()
    assert ([list(router.output_ids(q)) for q in rreqs]
            == [list(eng.output_ids(r)) for r in ereqs])
    assert {router.replica_of(q) for q in rreqs} == {0, 1}


def test_router_conservation_under_random_drain_restart_schedule(pair):
    """A randomized submit/step/drain/restart schedule over 3 replicas:
    every request finishes exactly once, every pool is restored free, and
    the tokens equal one engine's."""
    _, _, model = pair
    rng = np.random.RandomState(7)
    router = Router(model, replicas=3, placement="least_loaded", device="cpu", **_TIGHT)
    router.warmup()
    submitted, trace = [], []
    for _ in range(30):
        op = rng.rand()
        if op < 0.5 and len(submitted) < 16:
            p = rng.randint(1, 120, (int(rng.randint(4, 12)),)).astype(np.int32)
            m = int(rng.randint(2, 9))
            trace.append((p, m))
            submitted.append(router.submit(p, m))
        elif op < 0.65:
            admitting = [i for i in range(3) if i not in router._draining]
            if len(admitting) > 1:
                router.drain(int(rng.choice(admitting)))
        elif op < 0.8 and router._draining:
            router.restart(int(rng.choice(sorted(router._draining))))
        if router.has_work():
            router.step()
    router.run()
    finished = [set(e.finished) for e in router.engines]
    assert sum(len(s) for s in finished) == len(submitted)
    assert set().union(*finished) == {q.rid for q in submitted}
    assert router.drains > 0
    assert [list(router.output_ids(q)) for q in submitted] == _single(model, trace, **_TIGHT)
    for eng in router.engines:
        assert eng.blocks.num_used == 0
        assert eng.blocks.num_free + eng.blocks.num_cached == eng.blocks.num_blocks - 1


def test_router_affinity_index_ages_and_skew_falls_back(pair):
    """A capped affinity index forgets old families but never changes
    tokens; past ``affinity_max_skew`` a family's next request goes to the
    lighter replica, counted (the JAX router's counts on the same
    submissions)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve.router import Router as JRouter

    jmodel, params, model = pair
    rng = np.random.RandomState(5)
    prefixes = [rng.randint(1, 120, (12,)).astype(np.int32) for _ in range(2)]
    trace = [(np.concatenate([prefixes[f], rng.randint(1, 120, (3,)).astype(np.int32)]), 4)
             for _ in range(3) for f in range(2)]
    tiny = Router(model, replicas=2, placement="affinity", affinity_cap=2, device="cpu", **_KW)
    treqs = [tiny.submit(p, m) for p, m in trace]
    tiny.run()
    assert len(tiny._affinity) <= 2
    assert [list(tiny.output_ids(q)) for q in treqs] == _single(model, trace, **_KW)
    rng = np.random.RandomState(6)
    prefix = rng.randint(1, 120, (12,)).astype(np.int32)
    same = [(np.concatenate([prefix, rng.randint(1, 120, (3,)).astype(np.int32)]), 3)
            for _ in range(6)]
    owners = []
    for r in (JRouter(jmodel, params, replicas=2, placement="affinity", affinity_max_skew=2,
                      **_KW),
              Router(model, replicas=2, placement="affinity", affinity_max_skew=2,
                     device="cpu", **_KW)):
        reqs = [r.submit(p, m) for p, m in same]
        owners.append(([r.replica_of(q) for q in reqs], r.affinity_fallbacks))
        r.run()
        assert len(r.finished) == len(same)
    assert owners[0] == owners[1]
    own, fallbacks = owners[1]
    assert own[1] == own[0] and (1 - own[0]) in own and fallbacks > 0


def test_router_rejected_submit_leaves_placement_state_untouched(pair):
    _, _, model = pair
    rng = np.random.RandomState(4)
    too_long = rng.randint(1, 120, (60,)).astype(np.int32)
    ok = rng.randint(1, 120, (8,)).astype(np.int32)
    rr = Router(model, replicas=2, placement="round_robin", device="cpu", **_KW)
    with pytest.raises(ValueError):
        rr.submit(too_long, 16)
    assert rr._rr == 0
    assert rr.replica_of(rr.submit(ok, 3)) == 0
    aff = Router(model, replicas=2, placement="affinity", device="cpu", **_KW)
    with pytest.raises(ValueError):
        aff.submit(too_long, 16)
    assert not aff._affinity
    rr.run(), aff.run()


HOST_CASES = [
    ("router_knobs", jax_router_cases.test_router_knob_parsing),
    ("parse_roles", jax_transport_cases.test_parse_roles_knob),
]


@pytest.mark.parametrize("impl", ["jax_package", "port"])
@pytest.mark.parametrize("case", HOST_CASES, ids=[c[0] for c in HOST_CASES])
def test_jax_router_knob_cases_hold_on_both_packages(case, impl, monkeypatch):
    _, fn = case
    if impl == "port":
        for mod in (jax_router_cases, jax_transport_cases):
            as_port(monkeypatch, mod)
        assert jax_transport_cases.parse_roles is t_router.parse_roles
    fn(monkeypatch)


def test_knob_errors_and_trace_knob_equal_the_jax_ones(monkeypatch):
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve import router as j_router

    monkeypatch.delenv("HSTD_SERVE_TRACE", raising=False)
    for name in ("parse_replicas", "parse_roles", "parse_placement", "parse_trace"):
        for spec in ("0", "x", "", "on", "OFF", "maybe", "prefill:1", "prefill:1,decode:2",
                     "random", "affinity", "3"):
            got = want = None
            try:
                want = getattr(j_router, name)(spec)
            except ValueError as e:
                want = ("ValueError", str(e))
            try:
                got = getattr(t_router, name)(spec)
            except ValueError as e:
                got = ("ValueError", str(e))
            assert got == want, (name, spec)
    assert t_router.PLACEMENTS == j_router.PLACEMENTS


def test_roles_contradicting_replicas_refused(pair):
    _, _, model = pair
    with pytest.raises(ValueError, match="contradicts"):
        Router(model, replicas=3, roles="prefill:1,decode:1", device="cpu", **_KW)
    r = Router(model, replicas=2, roles="prefill:1,decode:1", device="cpu", **_KW)
    assert r.n == 2 and r.role_of == ["prefill", "decode"] and r.engines[0].prefill_only
    with pytest.raises(ValueError, match="never fit any decode"):
        r.submit(np.arange(1, 61, dtype=np.int32), 16)


# -- telemetry ---------------------------------------------------------------------

def _serve_events(tmp_path, name, build, trace):
    out = tmp_path / name
    obs.reset(out_dir=str(out), enabled=True)
    try:
        srv = build()
        for p, m in trace:
            srv.submit(p, m)
        srv.run()
        obs.flush()
    finally:
        obs.reset()
    events = [e for _, e, err in t_schema.iter_events(str(out / "events.jsonl"))
              if err is None]
    return srv, out, [e for e in events if e["type"] == "serve"]


def test_single_replica_router_is_the_bare_engine(pair, tmp_path):
    """A one-replica router: the bare engine's event sequence with the same
    key sets, no router field anywhere, nothing new in the summary."""
    _, _, model = pair
    trace = _trace(n=5)
    _, _, eng_ev = _serve_events(tmp_path, "engine",
                                 lambda: ServeEngine(model, device="cpu", **_KW), trace)
    rt, _, rt_ev = _serve_events(tmp_path, "router",
                                 lambda: Router(model, replicas=1, device="cpu", **_KW), trace)
    assert ([(e["event"], tuple(sorted(e))) for e in rt_ev]
            == [(e["event"], tuple(sorted(e))) for e in eng_ev])
    router_keys = {"replica", "replicas", "placement", "requeued", "to_replica", "drains",
                   "requeues", "replica_load_imbalance", "per_replica", "affinity_fallbacks",
                   "trace_id", "hop"}
    assert not [e for e in rt_ev if router_keys & set(e)]
    assert not router_keys & set(rt.slo_summary())
    assert rt.engines[0].replica is None and not rt.trace


def test_two_replica_stream_is_tagged_and_valid_under_both_schemas(pair, tmp_path):
    """Every lifecycle event and timeline of a two-replica run carries its
    replica (and its trace context); the run ends with a report per
    replica and the fleet's last; the stream passes the port's and the JAX
    package's validators (``scripts/check_telemetry_schema.py``'s)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs.schema import (
        validate_events_file as jax_validate,
    )

    _, _, model = pair
    router, out, serve = _serve_events(
        tmp_path, "fleet",
        lambda: Router(model, replicas=2, placement="round_robin", device="cpu", **_KW),
        _trace(n=5))
    for validate in (t_schema.validate_events_file, jax_validate):
        n, errors = validate(str(out / "events.jsonl"))
        assert n > 0 and not errors
    for kind in ("submit", "admit", "first_token", "finish", "request_timeline"):
        rows = [e for e in serve if e["event"] == kind]
        assert rows and all(isinstance(e.get("replica"), int) for e in rows), kind
        assert all(e["trace_id"].startswith("t") and e["hop"] == 0 for e in rows), kind
    assert {e["replica"] for e in serve if e["event"] == "finish"} == {0, 1}
    reports = [e for e in serve if e["event"] == "report"]
    assert len(reports) == 3 and [r.get("replica") for r in reports[:2]] == [0, 1]
    agg = reports[-1]
    assert agg["replicas"] == 2 and agg["placement"] == "round_robin"
    assert isinstance(agg["replica_load_imbalance"], float) and len(agg["per_replica"]) == 2


# -- the CLI ---------------------------------------------------------------------------

FLEET_SUMMARY_KEYS = {
    "summary", "requests", "tokens", "tokens_per_sec", "replicas", "placement", "drains",
    "requeues", "replica_load_imbalance", "affinity_fallbacks", "ttft_p50_s", "ttft_p95_s",
    "ttft_p99_s", "e2e_p50_s", "e2e_p95_s", "e2e_p99_s", "peak_waiting_depth",
    "decode_steps", "decode_tokens_per_sec", "prefill_chunks", "preemptions",
    "gather_buckets", "prefix_cache", "cache_hit_rate", "timeline", "overlap", "kernel",
    "kv_dtype", "tp", "per_replica", "paged_kernel_launches"}
ROLE_KEYS = {"roles", "per_role", "migrations", "migration_bytes"}
ARRIVAL_KEYS = {"arrival", "arrival_backlog_peak"}


def _cli(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--device", "cpu", "--requests", "6", "--max_new_tokens", "8", *argv])
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    return lines[:-1], lines[-1]


@pytest.fixture(scope="module")
def one_engine_rows():
    rows, _ = _cli()
    return rows


@pytest.mark.parametrize("flags,keys", [
    (("--replicas", "2", "--placement", "affinity"), FLEET_SUMMARY_KEYS),
    (("--replicas", "2", "--placement", "least_loaded"), FLEET_SUMMARY_KEYS),
    (("--roles", "prefill:1,decode:1"), FLEET_SUMMARY_KEYS | ROLE_KEYS),
    (("--arrival", "poisson:50"), {"arrival", "arrival_backlog_peak"}),
    (("--replicas", "2", "--arrival", "bursty:50,10,0.5", "--slo", "ttft:30"),
     FLEET_SUMMARY_KEYS | ARRIVAL_KEYS | {"slo", "slo_attainment", "goodput_tokens"}),
    (("--rate_limit", "*=1000:100",), {"tokens"}),
    (("--replicas", "2", "--rate_limit", "*=1000:100"), FLEET_SUMMARY_KEYS)],
    ids=["replicas_affinity", "replicas_least_loaded", "roles", "arrival", "fleet_arrival_slo",
         "rate_limit", "fleet_rate_limit"])
def test_cli_fleet_flags_serve_the_one_engine_tokens(one_engine_rows, flags, keys):
    """Each flag runs (no ``NotImplementedError`` any more): its rows hold
    the one-engine run's tokens (by request order), a fleet's rows their
    replica, and the summary the JAX fleet summary's keys."""
    rows, summary = _cli(*flags)
    assert [r["output_ids"] for r in rows] == [r["output_ids"] for r in one_engine_rows]
    assert keys <= set(summary), keys - set(summary)
    fleet = "--replicas" in flags or "--roles" in flags
    assert all(("replica" in r) == fleet for r in rows)
    if fleet:
        assert set(summary) <= (FLEET_SUMMARY_KEYS | ROLE_KEYS | ARRIVAL_KEYS | {
            "slo", "slo_attainment", "group_slo_attainment", "slo_met", "slo_missed",
            "goodput_tokens", "miss_phases", "dominant_miss_phase"})
        assert summary["replicas"] == 2 and len(summary["per_replica"]) == 2
    if "--roles" in flags:
        assert summary["migrations"] == 6 and summary["per_role"]["prefill"]["decode_steps"] == 0
        assert {r["replica"] for r in rows} == {1}
    if "--arrival" in flags:
        assert summary["arrival"]["clock"] == "wall"


def test_cli_rate_limit_rejects_past_the_bucket():
    """A tenant bucket of one request: the other five are rejected, counted
    in the summary, never served."""
    rows, summary = _cli("--rate_limit", "*=0.001:1")
    assert len(rows) == 1 and summary["rate_limited"] == 5
