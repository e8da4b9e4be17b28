"""PyTorch port: the serving engine's single-device feature set
(``serve/engine.py``). The knobs parse as the JAX engine's and default to
its defaults but for the decode route (K3, ``kernel='pallas'``); greedy
tokens equal the JAX engine's and ``generate_causal``'s across the width
ladder's boundaries on both routes, with speculation (an independent
draft that forces rejections, and under preemption), with int8 pools
composed with speculation and the prefix cache, and with the
dispatch-ahead overlap (an EOS found with a dispatch in flight, width
switches, forced flushes, a lone stream); sampled streams are the same
with overlap on and off; the request timelines sum to their e2e under
both packages' checks; ``timeline='off'`` and ``overlap='off'`` emit the
streams from before those features; a tensor-parallel engine's
single-process refusals carry the JAX messages (it serves in
``tests/test_torch_tp_serve.py``); and the CLI takes the new flags and
refuses ``--replicas`` with ``--tp`` (the fleet flags run:
``tests/test_torch_router.py``)."""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.generate import (
    generate_causal,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import schema as t_schema
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.timeline import (
    check_decomposition,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve import cli
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve import engine as t_engine
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import ServeEngine
from torch_decode_pairs import (  # noqa: F401
    detached_compile_trackers,
    gpt2_pair,
    llama_pair,
    one_torch_thread,
)

EOS = 127


@pytest.fixture(scope="module")
def pair():
    """(JAX GPT-2, params, the port's twin): 2 layers, eos 127."""
    return gpt2_pair(num_layers=2, vocab=128, eos_token_id=EOS, pad_token_id=0)


@pytest.fixture(scope="module")
def draft_pair():
    """An independently initialized 1-layer draft of the same vocabulary:
    it disagrees with the target often, so rejections happen."""
    return gpt2_pair(num_layers=1, seed=5, vocab=128, eos_token_id=EOS, pad_token_id=0)


def run_port(model, trace, kws=None, **kw):
    eng = ServeEngine(model, device="cpu", **kw)
    reqs = [eng.submit(p, m, **(kws[i] if kws else {})) for i, (p, m) in enumerate(trace)]
    eng.run()
    return eng, [[int(t) for t in eng.output_ids(r)] for r in reqs]


def run_jax(jmodel, params, trace, **kw):
    """The JAX engine, serial, telemetry off (gather route unless asked)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve.engine import (
        ServeEngine as JaxServeEngine,
    )

    kw = {"kernel": "xla", "overlap": "off", "timeline": "off", **kw}
    eng = JaxServeEngine(jmodel, params, **kw)
    reqs = [eng.submit(p, m) for p, m in trace]
    eng.run()
    return eng, [[int(t) for t in eng.output_ids(r)] for r in reqs]


def plain_greedy(model, trace) -> list:
    eos = model.config.eos_token_id
    out = []
    for prompt, max_new in trace:
        ref = generate_causal(model, torch.from_numpy(prompt)[None],
                              max_new_tokens=max_new)[0].tolist()
        out.append(ref[:ref.index(eos) + 1] if eos in ref else ref)
    return out


def _trace(seed, shapes):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 120, (p,)).astype(np.int32), m) for p, m in shapes]


# -- knobs ---------------------------------------------------------------------

KNOB_INPUTS = {
    "parse_prefix_cache": [None, "on", "off", True, False, "1", "0", "yes", "", "banana"],
    "parse_timeline": [None, "on", "off", "true", "no", "maybe"],
    "parse_overlap": [None, "ON", " off ", False, "2"],
    "parse_swap": [None, "auto", "always", "never", "off", " ALWAYS ", "", "sometimes"],
    "parse_swap_bytes": [None, 0, 4096, "2048", "", "-1", "lots"],
    "parse_tp": [None, 1, "2", " 4 ", "0", "x"],
}


def _parse(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("name", sorted(KNOB_INPUTS))
def test_knobs_parse_as_the_jax_engines(name, monkeypatch):
    """Each knob reads the same ``HSTD_SERVE_*`` variable with the same
    default and takes and refuses the same values, word for word."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve import engine as j_engine

    for var in ("PREFIX_CACHE", "TIMELINE", "OVERLAP", "SWAP", "SWAP_BYTES", "TP"):
        monkeypatch.delenv(f"HSTD_SERVE_{var}", raising=False)
    got, want = getattr(t_engine, name), getattr(j_engine, name)
    for spec in KNOB_INPUTS[name]:
        assert _parse(got, spec) == _parse(want, spec), spec
    env = {"parse_prefix_cache": "ENV_PREFIX_CACHE", "parse_timeline": "ENV_TIMELINE",
           "parse_overlap": "ENV_OVERLAP", "parse_swap": "ENV_SWAP",
           "parse_swap_bytes": "ENV_SWAP_BYTES", "parse_tp": "ENV_TP"}[name]
    assert getattr(t_engine, env) == getattr(j_engine, env)
    for value in ("off", "always", "3", "0"):
        monkeypatch.setenv(getattr(j_engine, env), value)
        assert _parse(got, None) == _parse(want, None), value


def test_gather_ladder_and_kernel_knobs(monkeypatch):
    """The ladder parses as the JAX engine's; the decode route takes the
    JAX spellings, and its default is the one recorded difference: K3
    (``pallas``) in the port, ``xla`` in the JAX package."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve import engine as j_engine

    monkeypatch.delenv("HSTD_SERVE_KERNEL", raising=False)
    for spec in (None, "auto", "", "full", "off", "0", "512,2048", [100, 300], "64, 65",
                 [-4, 0], "a,b", (1024,)):
        for width, bs in ((1024, 16), (512, 16), (64, 4)):
            assert (_parse(t_engine.parse_gather_buckets, spec, width, bs)
                    == _parse(j_engine.parse_gather_buckets, spec, width, bs)), spec
    for spec in ("xla", "pallas", " XLA ", "triton"):
        assert _parse(t_engine.parse_kernel, spec) == _parse(j_engine.parse_kernel, spec)
    assert t_engine.parse_kernel(None) == "pallas" and j_engine.parse_kernel(None) == "xla"
    monkeypatch.setenv(j_engine.ENV_KERNEL, "xla")
    assert t_engine.parse_kernel(None) == "xla"


def test_engine_defaults_are_the_jax_engines(pair, monkeypatch):
    """Prefix cache on, timeline on, overlap on, ladder auto, swap off,
    fifo, no speculation; the route is K3."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve.engine import (
        ServeEngine as JaxServeEngine,
    )

    for var in ("PREFIX_CACHE", "TIMELINE", "OVERLAP", "GATHER_BUCKETS", "SWAP", "KERNEL",
                "SPECULATE_K", "POLICY", "TP"):
        monkeypatch.delenv(f"HSTD_SERVE_{var}", raising=False)
    jmodel, params, model = pair
    kw = dict(num_blocks=20, block_size=4, max_model_len=64, prefill_chunk=8)
    got, want = ServeEngine(model, device="cpu", **kw), JaxServeEngine(jmodel, params, **kw)
    for knob in ("prefix_cache", "timeline", "overlap", "gather_buckets", "swap",
                 "swap_bytes", "policy", "speculate_k", "tp", "kv_cache_dtype"):
        assert getattr(got, knob) == getattr(want, knob), knob
    assert got.gather_buckets == [16, 64] and got.prefix_cache and got.overlap
    assert (got.kernel, want.kernel) == ("pallas", "xla")


def test_stats_carry_the_jax_fields(pair):
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve.engine import (
        EngineStats as JaxEngineStats,
    )

    fields = t_engine.EngineStats._fields
    assert fields[:len(JaxEngineStats._fields)] == JaxEngineStats._fields
    assert set(fields) - set(JaxEngineStats._fields) == {"paged_kernel_launches"}


def _jax_refusal(jmodel, params, **kw) -> str:
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve.engine import (
        ServeEngine as JaxEngine,
    )

    with pytest.raises(ValueError) as err:
        JaxEngine(jmodel, params, num_blocks=9, block_size=4, **kw)
    return str(err.value)


@pytest.mark.parametrize("mesh", [2, "4", "env", "object"])
def test_tensor_parallel_raises_naming_its_item(pair, mesh, monkeypatch, devices8):
    """The single-process refusals of a tensor-parallel engine (the cases
    that serve run in gloo worlds, ``tests/test_torch_tp_serve.py``): a
    degree with no process group of that many ranks names the world size;
    K/V heads the degree does not divide (a Llama of 2 K/V heads at 4),
    ``kernel='pallas'`` with ``HSTD_SERVE_TP=2`` and a mesh argument of
    the wrong kind raise the JAX engine's ``ValueError``."""
    jmodel, params, model = pair
    case, kw = mesh, {}
    if mesh == "4":
        jmodel, params, model = llama_pair(num_kv_heads=2)
    elif mesh == "env":
        monkeypatch.setenv("HSTD_SERVE_TP", "2")
        mesh, kw = None, {"kernel": "pallas"}
    elif mesh == "object":
        mesh = object()
    if mesh == 2:
        with pytest.raises(ValueError, match="needs a process group of 2 ranks, the world "
                                             "has 1"):
            ServeEngine(model, device="cpu", num_blocks=9, block_size=4, mesh=mesh)
        return
    with pytest.raises(ValueError) as err:
        ServeEngine(model, device="cpu", num_blocks=9, block_size=4, mesh=mesh, **kw)
    want = _jax_refusal(jmodel, params, mesh=mesh, **kw)
    if case == "object":
        assert str(err.value).startswith("unparseable HSTD_SERVE_TP value <object object")
        assert want.startswith("unparseable HSTD_SERVE_TP value <object object")
    else:
        assert str(err.value) == want


# -- the width ladder ------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_ladder_exact_across_width_boundaries(pair, kernel):
    """Prompts of 15, 16 and 17 tokens against a first width of 16: the
    ladder grows at once, and every run's tokens, decode steps, switches,
    read waste and bytes read equal the JAX engine's on the same ladder."""
    jmodel, params, model = pair
    trace = _trace(3, [(15, 8), (16, 8), (17, 8), (5, 20)])
    kw = dict(num_slots=3, block_size=4, num_blocks=40, prefill_chunk=8, max_model_len=64,
              gather_buckets=[16, 32], prefix_cache="off")
    eng, got = run_port(model, trace, kernel=kernel, overlap="off", **kw)
    jeng, want = run_jax(jmodel, params, trace, **kw)
    assert got == want == plain_greedy(model, trace)
    assert eng.gather_buckets == [16, 32, 64]
    st, jst = eng.stats(), jeng.stats()
    assert st.bucket_switches > 0
    for f in ("decode_steps", "prefill_chunks", "prefill_dispatches", "bucket_switches",
              "gather_waste_peak", "gather_waste_mean", "kv_bytes_read", "decode_tokens"):
        assert getattr(st, f) == pytest.approx(getattr(jst, f)), f
    assert st.paged_kernel_launches == 0          # the CPU runs the plain version


# -- speculation -----------------------------------------------------------------

def test_speculative_exact_across_width_boundaries(pair, draft_pair):
    """Greedy draft-2 windows with an independent draft: tokens equal the
    JAX engine's and ``generate_causal``'s across the ladder's boundaries,
    rejections happen, and the window accounting equals the JAX engine's."""
    jmodel, params, model = pair
    jdraft, dparams, dmodel = draft_pair
    trace = _trace(6, [(15, 6), (16, 6), (17, 6)])
    kw = dict(num_slots=3, block_size=4, num_blocks=40, prefill_chunk=8, max_model_len=64,
              gather_buckets=[16, 32], speculate_k=2)
    eng, got = run_port(model, trace, draft=(dmodel, None), overlap="off", **kw)
    jeng, want = run_jax(jmodel, params, trace, draft=(jdraft, dparams), **kw)
    assert got == want == plain_greedy(model, trace)
    st, jst = eng.stats(), jeng.stats()
    assert 0 <= st.acceptance_rate < 1 and st.paged_kernel_launches == 0
    for f in ("draft_proposed", "draft_accepted", "spec_windows", "verify_waste_mean",
              "bucket_switches", "decode_steps"):
        assert getattr(st, f) == pytest.approx(getattr(jst, f)), f
    assert eng.blocks.num_used == 0
    assert eng.blocks.num_free + eng.blocks.num_cached == eng.blocks.num_blocks - 1


def test_speculative_exact_under_preemption_rewind_leak_free(pair, draft_pair):
    jmodel, params, model = pair
    jdraft, dparams, dmodel = draft_pair
    trace = _trace(1, [(9, 14)] * 5)
    kw = dict(num_slots=4, block_size=4, num_blocks=11, prefill_chunk=8, max_model_len=32,
              speculate_k=2)
    eng, got = run_port(model, trace, draft=(dmodel, dmodel.state_dict()), **kw)
    _, want = run_jax(jmodel, params, trace, draft=(jdraft, dparams), **kw)
    assert got == want == plain_greedy(model, trace)
    assert eng.stats().preemptions > 0
    assert eng.blocks.num_used == 0
    assert eng.blocks.num_free + eng.blocks.num_cached == eng.blocks.num_blocks - 1


def test_int8_pools_compose_with_speculation_and_the_prefix_cache(pair):
    """int8 pools (the draft's too) with a self-draft and shared prefixes:
    tokens equal the JAX int8 engine's and ``generate_causal`` on the int8
    cache; the draft's pools are int8 with scales."""
    jmodel, params, model = pair
    int8 = type(model)(dataclasses.replace(model.config, kv_cache_dtype="int8"))
    int8.load_state_dict(model.state_dict())
    int8.eval()
    rng = np.random.RandomState(26)
    prefix = rng.randint(1, 120, (12,)).astype(np.int32)
    trace = [(np.concatenate([prefix, rng.randint(1, 120, (t,)).astype(np.int32)]), m)
             for t, m in ((3, 10), (1, 6), (2, 8))]
    kw = dict(num_slots=2, block_size=4, num_blocks=40, prefill_chunk=8, max_model_len=32,
              speculate_k=2, draft=1, prefix_cache="on")
    eng, got = run_port(model, trace, kv_cache_dtype="int8", **kw)
    jint8 = jmodel.clone(config=dataclasses.replace(jmodel.config, kv_cache_dtype="int8"))
    _, want = run_jax(jint8, params, trace, **kw)
    assert got == want == plain_greedy(int8, trace)
    assert {p.dtype for p in eng._dkv.k + eng._dkv.v} == {torch.int8}
    assert eng._dkv.k_scale is not None
    assert eng.stats().prefix_cached_tokens > 0 and eng.stats().draft_proposed > 0


def test_draft_knob_forms(pair, draft_pair, monkeypatch):
    """An int is ``self_draft``'s first layers (sharing the target's
    tensors), None reads ``HSTD_SERVE_DRAFT_LAYERS`` (else a quarter of
    the layers), a pair loads its weights; another vocabulary raises."""
    _, _, model = pair
    _, _, dmodel = draft_pair
    kw = dict(device="cpu", num_blocks=20, block_size=4, max_model_len=64, speculate_k=2)
    eng = ServeEngine(model, draft=1, **kw)
    assert eng.draft_model.config.num_layers == 1
    assert eng.draft_model.backbone.h[0] is model.backbone.h[0]
    monkeypatch.setenv("HSTD_SERVE_DRAFT_LAYERS", "1")
    assert ServeEngine(model, **kw).draft_model.config.num_layers == 1
    monkeypatch.delenv("HSTD_SERVE_DRAFT_LAYERS")
    assert ServeEngine(model, **kw).draft_model.config.num_layers == 1   # 2 // 4 -> 1
    fresh = type(dmodel)(dmodel.config)
    loaded = ServeEngine(model, draft=(fresh, dmodel.state_dict()), **kw).draft_model
    assert torch.equal(loaded.backbone.wte.weight, dmodel.backbone.wte.weight)
    other = type(dmodel)(dataclasses.replace(dmodel.config, vocab_size=64))
    with pytest.raises(ValueError, match="vocabulary"):
        ServeEngine(model, draft=(other, None), **kw)


# -- the dispatch-ahead overlap ------------------------------------------------------

def _overlap_pair(model, trace, kws=None, **kw):
    off_eng, off = run_port(model, trace, kws, overlap="off", **kw)
    on_eng, on = run_port(model, trace, kws, overlap="on", **kw)
    assert on_eng.overlap and not off_eng.overlap
    return off, on, on_eng


def test_overlap_exact_with_eos_in_flight(pair):
    """EOS is a token one request's greedy continuation first emits after
    two decode steps or more: it finishes with a dispatch in flight, whose
    token is discarded. On, off, ``generate_causal`` and the JAX engine
    agree."""
    jmodel, params, model = pair
    prompts = [np.random.RandomState(21).randint(1, 120, (p,)).astype(np.int32)
               for p in (5, 9, 12, 7)]
    refs = [generate_causal(model, torch.from_numpy(p)[None], max_new_tokens=12)[0].tolist()
            for p in prompts]
    i, n = next((i, j) for i, ref in enumerate(refs) for j in range(2, 12)
                if ref[j] not in ref[:j])
    eos = refs[i][n]
    eos_model = type(model)(dataclasses.replace(model.config, eos_token_id=eos))
    eos_model.load_state_dict(model.state_dict())
    eos_model.eval()
    trace = [(p, 12) for p in prompts]
    kw = dict(num_slots=4, block_size=4, num_blocks=60, prefill_chunk=8, max_model_len=64)
    off, on, eng = _overlap_pair(eos_model, trace, **kw)
    _, want = run_jax(jmodel.clone(config=dataclasses.replace(jmodel.config, eos_token_id=eos)),
                      params, trace, **kw)
    assert on == off == want == plain_greedy(eos_model, trace)
    assert len(on[i]) == n + 1 and on[i][-1] == eos


def test_overlap_exact_across_width_switches(pair):
    _, _, model = pair
    trace = _trace(22, [(15, 9), (16, 9), (17, 9), (5, 9)])
    off, on, eng = _overlap_pair(model, trace, num_slots=4, block_size=4, num_blocks=60,
                                 prefill_chunk=8, max_model_len=64, gather_buckets=[16, 32])
    assert on == off == plain_greedy(model, trace)
    assert eng.bucket_switches > 0 and eng.overlap_flushes == 0


def test_overlap_exact_under_forced_preemption_and_flushes(pair):
    _, _, model = pair
    trace = _trace(1, [(9, 18)] * 5)
    off, on, eng = _overlap_pair(model, trace, num_slots=4, block_size=4, num_blocks=10,
                                 prefill_chunk=8, max_model_len=32)
    assert on == off == plain_greedy(model, trace)
    assert eng.stats().preemptions > 0
    assert eng.overlap_flushes > 0 and eng.stats().overlap_flushes == eng.overlap_flushes


def test_overlap_sampled_bitwise_and_spec_rejection_storm(pair, draft_pair):
    """Sampled streams are the same bit for bit with overlap on and off
    (the token index counts the one in flight), also under preemption;
    a speculative engine with an independent draft and a tight pool is
    the same on and off."""
    _, _, model = pair
    _, _, dmodel = draft_pair
    trace = _trace(23, [(9, 14)] * 4)
    kws = [dict(temperature=0.9, top_k=20, top_p=0.9, seed=s) for s in (1, 2, 3)] + [{}]
    off, on, _ = _overlap_pair(model, trace, kws, num_slots=3, block_size=4, num_blocks=40,
                               prefill_chunk=8, max_model_len=32)
    assert on == off
    teng, tight = run_port(model, trace, kws, num_slots=3, block_size=4, num_blocks=9,
                           prefill_chunk=8, max_model_len=32)
    assert tight == on and teng.stats().preemptions > 0
    off_s, on_s, eng = _overlap_pair(model, trace, kws, num_slots=4, block_size=4,
                                     num_blocks=11, prefill_chunk=8, max_model_len=32,
                                     speculate_k=2, draft=(dmodel, None))
    assert on_s == off_s
    assert eng.stats().preemptions > 0 and 0 <= eng.stats().acceptance_rate < 1
    assert eng.blocks.num_used == 0


def test_overlap_lone_stream_runs_serially(pair, monkeypatch):
    """One decoding request and an empty queue: nothing is dispatched
    ahead, the iterations equal the serial loop's; more streams engage
    the pipeline, tokens unchanged."""
    _, _, model = pair
    calls = []
    orig = ServeEngine._dispatch_decode
    monkeypatch.setattr(ServeEngine, "_dispatch_decode",
                        lambda self: (calls.append(1), orig(self))[1])
    kw = dict(num_slots=3, block_size=4, num_blocks=40, prefill_chunk=8, max_model_len=64)
    trace = _trace(34, [(9, 8)])
    off_eng, off = run_port(model, trace, overlap="off", **kw)
    on_eng, on = run_port(model, trace, overlap="on", **kw)
    assert not calls and on == off and on_eng.iterations == off_eng.iterations
    off2, on2, _ = _overlap_pair(model, _trace(35, [(7, 6)] * 3), **kw)
    assert off2 == on2 and calls


# -- telemetry -----------------------------------------------------------------------

def _events(model, out_dir, timeline, overlap, n_req=5):
    obs.reset(out_dir=str(out_dir), enabled=True)
    try:
        rng = np.random.RandomState(1)
        eng = ServeEngine(model, device="cpu", num_slots=4, block_size=4, num_blocks=10,
                          prefill_chunk=8, max_model_len=32, timeline=timeline,
                          overlap=overlap)
        for i in range(n_req):
            eng.submit(rng.randint(1, 120, (9,)).astype(np.int32), 18, group=f"tenant{i % 2}")
        eng.run()
    finally:
        obs.reset()
    n, errors = t_schema.validate_events_file(str(out_dir / "events.jsonl"))
    assert not errors and n > 0
    return eng, [e for _, e, err in t_schema.iter_events(str(out_dir / "events.jsonl"))
                 if err is None]


@pytest.mark.parametrize("overlap", [True, False])
def test_timeline_decomposition_sums(pair, tmp_path, overlap):
    """Forced preemption with the timeline on: every request's last
    ``request_timeline`` sums to its e2e under the port's and the JAX
    package's ``check_decomposition``, a partial timeline per preemption,
    one ledger per iteration whose tokens close, blocked heads named."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import timeline as j_timeline

    _, _, model = pair
    eng, events = _events(model, tmp_path / "t", True, overlap)
    assert eng.sched.n_preemptions > 0
    assert (eng.overlap_flushes > 0) == overlap
    recs = j_timeline.collect_timelines(events)
    assert sorted(r["request"] for r in recs) == sorted(eng.finished)
    for rec in recs:
        assert check_decomposition(rec) == [] == j_timeline.check_decomposition(rec)
        assert rec["at"] == "finish" and rec["decode_s"] > 0
    assert any(r["preempted_s"] > 0 for r in recs if r["preemptions"])
    partials = [e for e in events if e.get("event") == "request_timeline"
                and e.get("at") == "preempt"]
    assert len(partials) == eng.sched.n_preemptions
    assert [s for r in recs for s in r["segments"] if s.get("blocked_iters")]
    ledgers = [e for e in events if e.get("event") == "iteration_ledger"]
    assert [e["iteration"] for e in ledgers] == list(range(eng.iterations))
    assert sum(e["tokens"] for e in ledgers) == eng.tokens_generated
    assert all(e["dur_s"] >= e["prefill_s"] + e["decode_s"] - 1e-5 for e in ledgers)
    slo = eng.slo_summary()
    assert sum(slo[f"{ph}_time_frac"] for ph in
               ("queue", "prefill", "decode", "preempted", "overhead")) == pytest.approx(1, abs=0.01)
    bad = check_decomposition(dict(recs[0], overhead_s=recs[0]["overhead_s"] - 1.0))
    assert any("phase sum" in b for b in bad)


def test_timeline_off_and_overlap_off_give_the_earlier_streams(pair, tmp_path):
    """``timeline='off'``: no timeline event, no timeline field anywhere,
    nothing stamped; ``overlap='off'``: no overlap field, the timeline
    intact."""
    _, _, model = pair
    eng, events = _events(model, tmp_path / "a", False, True, n_req=3)
    serve = [e for e in events if e["type"] == "serve"]
    assert {e["event"] for e in serve} <= {"submit", "admit", "first_token", "finish",
                                           "preempt", "bucket_switch", "report"}
    new_keys = {"at", "e2e_s", "queue_s", "prefill_s", "decode_s", "preempted_s",
                "overhead_s", "segments", "group", "blocked_iters", "iteration",
                "dur_s", "queue_wait_p50_s", "queue_time_frac", "overhead_time_frac"}
    assert not [k for e in serve for k in e if k in new_keys]
    assert not new_keys & set(eng.slo_summary())
    assert all(v == 0.0 for r in eng.finished.values() for v in r.phase_s.values())
    eng, events = _events(model, tmp_path / "b", True, False)
    serve = [e for e in events if e["type"] == "serve"]
    assert not [e for e in serve if {"overlap", "overlap_flushes"} & set(e)
                and e["event"] != "report"]
    assert "overlap" not in eng.slo_summary() and eng.overlap_flushes == 0
    assert {"request_timeline", "iteration_ledger"} <= {e["event"] for e in serve}


# -- the CLI -----------------------------------------------------------------------------

SERVE_SUMMARY_KEYS = {
    "summary", "requests", "tokens", "tokens_per_sec", "ttft_p50_s",
    "ttft_p95_s", "ttft_p99_s", "e2e_p50_s", "e2e_p95_s", "e2e_p99_s",
    "peak_waiting_depth", "decode_steps", "decode_tokens_per_sec",
    "prefill_chunks", "prefill_dispatches", "preemptions", "gather_buckets",
    "bucket_switches", "gather_read_waste_peak", "gather_read_waste_mean",
    "speculate_k", "acceptance_rate", "verify_read_waste_mean",
    "prefix_cache", "cache_hit_rate", "blocks_shared_peak",
    "blocks_saved_peak", "cow_copies", "timeline", "queue_wait_p99_s",
    "queue_time_frac", "prefill_time_frac", "decode_time_frac",
    "preempted_time_frac", "overhead_time_frac", "overlap",
    "overlap_flushes", "kernel", "kv_dtype", "tp",
    "kv_pool_bytes_per_device", "kv_bytes_read_per_step",
    "kv_peak_utilization", "swap_policy", "swap_outs", "swap_ins", "swap_bytes",
    "restore_s", "recompute_tokens_avoided", "host_tier_hits", "host_tier_hit_rate",
    "slo", "slo_attainment", "group_slo_attainment", "policy", "aging_promotions",
    "deadline_miss_frac"}


def _cli(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--device", "cpu", *argv])
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    return lines[:-1], lines[-1]


def test_cli_serves_a_templated_file_with_the_new_flags(tmp_path):
    """A templated ``--input_file`` with swap, speculation, the slo policy
    and an SLO: the JAX summary keys (and ``paged_kernel_launches``), the
    cache hit, the acceptance, rows with their phases and verdicts; the
    same tokens as ``--prefix_cache off --overlap off --gather_buckets
    full --kernel xla``."""
    rng = np.random.RandomState(4)
    template = rng.randint(1, 1000, (32,)).tolist()
    rows = [{"prompt_ids": template + rng.randint(1, 1000, (int(t),)).tolist(),
             "max_new_tokens": 6} for t in rng.randint(2, 9, 6)]
    path = tmp_path / "req.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    common = ["--input_file", str(path), "--num_slots", "2", "--num_blocks", "40",
              "--max_model_len", "128", "--prefill_chunk", "16"]
    out, summary = _cli(*common, "--swap", "always", "--speculate_k", "2",
                        "--draft_layers", "1", "--policy", "slo", "--slo", "ttft:30")
    assert set(summary) - {"paged_kernel_launches"} <= SERVE_SUMMARY_KEYS
    assert summary["swap_policy"] == "always" and summary["speculate_k"] == 2
    assert summary["cache_hit_rate"] > 0 and summary["policy"] == "slo"
    assert summary["slo_attainment"] == 1.0 and summary["kernel"] == "pallas"
    assert all("phase_s" in r and r["slo_met"] for r in out)
    plain, psum = _cli(*common, "--prefix_cache", "off", "--overlap", "off",
                       "--gather_buckets", "full", "--kernel", "xla", "--timeline", "off")
    assert [r["output_ids"] for r in plain] == [r["output_ids"] for r in out]
    assert psum["cache_hit_rate"] is None and psum["gather_buckets"] == [128]
    assert "phase_s" not in plain[0]


@pytest.mark.parametrize("argv,item", [(("--replicas", "2", "--tp", "2"), "11")])
def test_cli_refuses_unported_flags(argv, item):
    """A fleet of tensor-parallel replicas is the next part of item 11."""
    with pytest.raises(NotImplementedError, match=rf"ROADMAP queue 1, item {item}\b"):
        _cli("--requests", "1", *argv)
