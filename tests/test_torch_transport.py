"""PyTorch port: cross-engine KV transport (``serve/transport.py``). A
request migrated mid-decode across a width boundary emits the JAX
engine's tokens with zero re-prefill on the destination; a sampled stream
survives migration bit for bit; ``pool_signature`` mismatches, unknown
requests and too-small destinations raise ``TransportError`` with the JAX
messages; a randomized two-engine submit/step/migrate schedule conserves
every block on both pools at every step and every request's tokens; a
drain migrates its residents at once; ``length_aware`` placement over a
heterogeneous fleet gives the JAX router's owners. Tokens, owners and
counts are held exactly."""

import re

import numpy as np
import pytest

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import schema as t_schema
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import ServeEngine
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.router import Router
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.transport import (
    TransportError,
    can_accept,
    migrate_request,
)
from torch_decode_pairs import (  # noqa: F401
    detached_compile_trackers,
    gpt2_pair,
    one_torch_thread,
)

EOS = 127
_KW = dict(num_slots=2, block_size=4, num_blocks=40, prefill_chunk=8, max_model_len=64,
           gather_buckets=[16, 32])


@pytest.fixture(scope="module")
def pair():
    return gpt2_pair(num_layers=2, vocab=128, eos_token_id=EOS, pad_token_id=0)


def _engine(model, **over):
    return ServeEngine(model, device="cpu", **{**_KW, **over})


def _jax_engine(pair, **over):
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve.engine import (
        ServeEngine as JaxServeEngine,
    )

    jmodel, params, _ = pair
    return JaxServeEngine(jmodel, params, **{**_KW, **over})


def _slot_of(eng, rid):
    return next((s for s in eng.sched.slots
                 if s.request is not None and s.request.rid == rid), None)


def _conserved(eng):
    b = eng.blocks
    return b.num_free + b.num_used + b.num_cached + b.num_hosted == b.num_blocks - 1


def _baseline(model, trace, **over):
    eng = _engine(model, **over)
    reqs = [eng.submit(p, m, **kw) for p, m, kw in trace]
    eng.run()
    return [[int(t) for t in eng.output_ids(r)] for r in reqs]


@pytest.mark.parametrize("overlap", ["on", "off"])
def test_migrate_mid_decode_across_a_width_boundary_is_the_jax_engines_tokens(pair, overlap):
    """A request moved mid-decode after its context crossed the first width
    (16), so the destination resumes at the wider one, emits the JAX
    engine's tokens; the destination never prefills; the source is
    released whole; the counters say one migration each way."""
    rng = np.random.RandomState(0)
    prompt = rng.randint(1, 120, (14,)).astype(np.int32)
    jeng = _jax_engine(pair, overlap="off", timeline="off")
    jreq = jeng.submit(prompt, 12)
    jeng.run()
    want = [int(t) for t in jeng.output_ids(jreq)]
    _, _, model = pair
    src, dst = _engine(model, overlap=overlap), _engine(model, overlap=overlap)
    req = src.submit(prompt, 12)
    while src.has_work():
        slot = _slot_of(src, req.rid)
        if slot is not None and slot.context_len > 18:
            break
        src.step()
    assert _slot_of(src, req.rid).context_len > 16
    info = migrate_request(src, dst, req.rid)
    assert info is not None and not info["cold"]
    assert info["bytes"] > 0 and info["context_len"] > 16 and req.hop == 1
    assert _slot_of(src, req.rid) is None and not src.has_work()
    assert src.blocks.num_used == 0 and _conserved(src)
    dst.run()
    assert [int(t) for t in dst.output_ids(req)] == want
    assert req.rid in dst.finished and req.rid not in src.finished
    st_dst, st_src = dst.stats(), src.stats()
    assert st_dst.prefill_chunks == 0
    assert (st_dst.migrations_in, st_src.migrations_out) == (1, 1)
    assert st_dst.migration_bytes == info["bytes"] and dst.migration_restore_s > 0
    assert dst.slo_summary()["migrations_in"] == 1
    assert _conserved(dst) and dst.blocks.num_used == 0 and not dst._migrated_in


def test_migrated_sampled_stream_is_bitwise_the_unmigrated_one(pair):
    _, _, model = pair
    rng = np.random.RandomState(2)
    prompt = rng.randint(1, 120, (9,)).astype(np.int32)
    skw = dict(temperature=0.9, top_k=20, seed=13)
    want = _baseline(model, [(prompt, 10, skw)])
    src, dst = _engine(model), _engine(model)
    req = src.submit(prompt, 10, **skw)
    while src.has_work() and len(req.output) < 4:
        src.step()
    assert len(req.output) >= 1
    assert migrate_request(src, dst, req.rid) is not None
    dst.run()
    assert [[int(t) for t in dst.output_ids(req)]] == want


def test_cold_migration_of_a_prefilling_request_re_prefills(pair):
    """A mid-prefill resident moves cold: no payload, a ``migrate`` event
    with zero bytes, the destination prefills it anew."""
    _, _, model = pair
    rng = np.random.RandomState(8)
    prompt = rng.randint(1, 120, (30,)).astype(np.int32)
    want = _baseline(model, [(prompt, 5, {})])
    src, dst = _engine(model, prefill_batch=1), _engine(model)
    src.replica, dst.replica = 0, 1
    req = src.submit(prompt, 5)
    src.step()
    assert _slot_of(src, req.rid).prefill_pos < len(prompt)
    info = migrate_request(src, dst, req.rid)
    assert info["cold"] and info["bytes"] == 0
    dst.run()
    assert [[int(t) for t in dst.output_ids(req)]] == want
    assert dst.stats().prefill_chunks > 0 and dst.stats().migrations_in == 1


def _messages(make, transport, tiny_blocks):
    """The TransportError messages of the self-move, the unknown request,
    the geometry mismatch and the too-small destination (request ids
    masked), and whether a finished request moves as a no-op."""
    migrate, signature = transport.migrate_request, transport.pool_signature
    src, dst = make(), make()
    assert signature(src) == signature(dst)
    req = src.submit(np.arange(1, 9, dtype=np.int32), 4)
    other = make(block_size=8, num_blocks=20)
    tiny = make(num_blocks=tiny_blocks)
    assert signature(src) != signature(other) and not transport.can_accept(tiny, req)
    got = []
    for d, rid in ((src, req.rid), (dst, 10 ** 9), (other, req.rid), (tiny, req.rid)):
        with pytest.raises(Exception) as err:
            migrate(src, d, rid)
        assert type(err.value).__name__ == "TransportError"
        got.append(re.sub(r"request \d+", "request N", str(err.value)))
    src.run()
    return got, migrate(src, dst, req.rid)


def test_rejections_raise_the_jax_messages(pair):
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve import transport as j_transport
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve import (
        transport as t_transport,
    )

    _, _, model = pair
    want, jnone = _messages(lambda **o: _jax_engine(pair, **o), j_transport, 4)
    got, tnone = _messages(lambda **o: _engine(model, **o), t_transport, 4)
    assert got == want and tnone is None is jnone
    assert issubclass(TransportError, RuntimeError)


def test_can_accept_equals_the_jax_probe(pair):
    """The worst-case block probe over requests near every limit, against
    engines of other geometry, statically and against live headroom."""
    from types import SimpleNamespace

    from huggingface_sagemaker_tensorflow_distributed_tpu.serve import transport as j_transport

    _, _, model = pair
    for over in ({}, dict(num_blocks=8), dict(num_blocks=20, block_size=8),
                 dict(prefill_chunk=16), dict(speculate_k=2, draft=1)):
        t_eng, j_eng = _engine(model, **over), _jax_engine(pair, **over)
        for p, m in ((4, 4), (30, 30), (40, 24), (60, 4), (8, 56), (1, 63)):
            req = SimpleNamespace(prompt=np.ones(p, np.int32), max_new_tokens=m)
            for live in (False, True):
                assert (can_accept(t_eng, req, live=live)
                        == j_transport.can_accept(j_eng, req, live=live)), (over, p, m)


def test_randomized_two_engine_conservation_schedule(pair):
    """300 random submit/step/migrate operations over two engines with
    tight pools: every step's block accounting is exact on both pools,
    every table points into its own pool, every request finishes exactly
    once, and the tokens equal one engine's (and the JAX engine's)."""
    _, _, model = pair
    rng = np.random.RandomState(7)
    engines = [_engine(model, num_blocks=14), _engine(model, num_blocks=14)]
    trace, reqs, homes = [], [], []
    migrations = 0
    for _ in range(300):
        op = rng.rand()
        if op < 0.35 and len(reqs) < 20:
            p = rng.randint(1, 120, (int(rng.randint(4, 12)),)).astype(np.int32)
            m = int(rng.randint(2, 9))
            e = int(rng.randint(2))
            trace.append((p, m, {}))
            reqs.append(engines[e].submit(p, m))
            homes.append(e)
        elif op < 0.55:
            e = int(rng.randint(2))
            resident = [s.request.rid for s in engines[e].sched.slots if s.request is not None]
            if resident:
                rid = int(rng.choice(resident))
                try:
                    if migrate_request(engines[e], engines[1 - e], rid) is not None:
                        migrations += 1
                        homes[[q.rid for q in reqs].index(rid)] = 1 - e
                except TransportError:
                    pass
        else:
            e = int(rng.randint(2))
            if engines[e].has_work():
                engines[e].step()
        for eng in engines:
            assert _conserved(eng)
            for s in eng.sched.slots:
                if s.request is not None:
                    n = eng.blocks.blocks_for(s.context_len)
                    assert all(0 < int(b) < eng.blocks.num_blocks for b in s.table[:n])
    for eng in engines:
        eng.run()
    assert migrations > 0
    finished = [set(e.finished) for e in engines]
    assert not finished[0] & finished[1]
    assert finished[0] | finished[1] == {q.rid for q in reqs}
    outs = [[int(t) for t in engines[homes[i]].output_ids(q)] for i, q in enumerate(reqs)]
    assert outs == _baseline(model, trace, num_blocks=14)
    jeng = _jax_engine(pair, num_blocks=14, overlap="off", timeline="off")
    jreqs = [jeng.submit(p, m) for p, m, _ in trace]
    jeng.run()
    assert outs == [[int(t) for t in jeng.output_ids(r)] for r in jreqs]
    for eng in engines:
        assert eng.blocks.num_used == 0 and _conserved(eng)


def test_drain_live_migrates_residents_and_completes(pair, tmp_path):
    """A drain empties the replica at once: the waiting requeue, the
    residents move with their blocks (one cohort extraction), the drain
    event splits migrated from in-place, every migrate event carries its
    bytes and restore time, and the tokens stay one engine's."""
    _, _, model = pair
    rng = np.random.RandomState(1)
    trace = [(rng.randint(1, 120, (int(rng.randint(5, 13)),)).astype(np.int32),
              int(rng.randint(3, 9)), {}) for _ in range(8)]
    want = _baseline(model, trace)
    out = tmp_path / "drain"
    obs.reset(out_dir=str(out), enabled=True)
    try:
        router = Router(model, replicas=2, placement="round_robin", device="cpu", **_KW)
        reqs = [router.submit(p, m) for p, m, _ in trace]
        router.warmup()
        for _ in range(3):
            router.step()
        src = router.engines[0]
        assert any(s.request is not None for s in src.sched.slots)
        router.drain(0)
        assert router.migrations > 0
        assert all(s.request is None for s in src.sched.slots)
        assert not src.sched.waiting and src.blocks.num_used == 0
        router.run()
        obs.flush()
    finally:
        obs.reset()
    assert [[int(t) for t in router.output_ids(q)] for q in reqs] == want
    for eng in router.engines:
        assert eng.blocks.num_used == 0 and _conserved(eng)
    events = [e for _, e, err in t_schema.iter_events(str(out / "events.jsonl"))
              if err is None]
    (drain,) = [e for e in events if e.get("event") == "drain"]
    assert drain["migrated"] >= 1 and drain["residents_in_place"] == 0
    migrates = [e for e in events if e.get("event") == "migrate"]
    assert len(migrates) == router.migrations
    for e in migrates:
        assert e["from_replica"] == 0 and e["to_replica"] == 1
        assert isinstance(e["migration_bytes"], int) and isinstance(e["restore_s"], float)
        assert e["transport_hop_s"] >= e["extract_s"] >= 0 and e["hop"] == 1
    assert any(e["migration_bytes"] > 0 for e in migrates)
    summary = router.slo_summary()
    assert summary["migrations"] == router.migrations
    assert summary["migration_bytes"] == sum(e["migration_bytes"] for e in migrates)
    assert summary["transport_hop_s_p99"] > 0


def test_length_aware_heterogeneous_fleet_places_as_the_jax_router(pair):
    """A small and a large replica (one pool signature): long prompts to the
    deep one, short to the shallow one (owners [0, 1, 0, 1] in both
    packages), tokens the one engine's."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve.router import Router as JRouter

    jmodel, params, model = pair
    rng = np.random.RandomState(6)
    short = [(rng.randint(1, 120, (5,)).astype(np.int32), 4, {}) for _ in range(2)]
    long_ = [(rng.randint(1, 120, (16,)).astype(np.int32), 4, {}) for _ in range(2)]
    trace = [row for pr in zip(short, long_) for row in pr]
    owners = []
    for r in (JRouter(jmodel, params, replicas=2, placement="length_aware",
                      replica_kwargs=[{"num_blocks": 20}, {}], length_threshold=10, **_KW),
              Router(model, replicas=2, placement="length_aware",
                     replica_kwargs=[{"num_blocks": 20}, {}], length_threshold=10,
                     device="cpu", **_KW)):
        assert r.engines[0].blocks.num_blocks < r.engines[1].blocks.num_blocks
        reqs = [r.submit(p, m) for p, m, _ in trace]
        owners.append([r.replica_of(q) for q in reqs])
        r.run()
        outs = [[int(t) for t in r.output_ids(q)] for q in reqs]
    assert owners == [[0, 1, 0, 1]] * 2
    assert outs == _baseline(model, trace)
