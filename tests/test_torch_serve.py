"""PyTorch port: serving (``serve/``). The block manager and scheduler
unit cases of ``tests/test_serve.py`` run against both packages' host
code; the port's engine on the CPU is token-exact against the JAX
``ServeEngine(kernel='xla')`` and ``generate_causal`` (mixed lengths,
forced preemption, EOS); the CLI and the device rule of the entry
points; per-request sampling (seeded streams the same across
preemption), int8 pools with their scales, byte-sized pools, and the
CLI's sampling, ``--model_dir`` and ``--kv_cache_dtype`` flags."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import gpt2 as t_gpt2
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve import cli
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import (
    ServeEngine,
)

TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=128,
            hidden_dropout=0.0, embd_dropout=0.0, attention_dropout=0.0,
            eos_token_id=127, pad_token_id=0)


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


# -- block manager and scheduler, both packages ------------------------------

def _host(impl):
    """(BlockManager, PoolExhausted, Request, Scheduler, states) of one
    package's host-side serving code."""
    if impl == "jax_package":
        from huggingface_sagemaker_tensorflow_distributed_tpu.serve import (
            paged_kv,
            scheduler,
        )
    else:
        from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve import (
            paged_kv,
            scheduler,
        )
    return (paged_kv.BlockManager, paged_kv.PoolExhausted, scheduler.Request,
            scheduler.Scheduler, scheduler)


def _block_alloc_free_roundtrip(BlockManager, PoolExhausted, Request, Scheduler, st):
    bm = BlockManager(num_blocks=9, block_size=4)
    assert bm.num_free == 8                        # block 0 reserved
    got = bm.allocate(3)
    assert len(got) == 3 and 0 not in got
    assert bm.num_used == 3 and bm.peak_used == 3
    bm.free(got)
    assert bm.num_free == 8 and bm.peak_used == 3  # peak latches
    with pytest.raises(ValueError):
        bm.free([got[0], got[0]])                  # double free
    with pytest.raises(ValueError):
        bm.free([0])                               # the null block


def _pool_exhausted_is_all_or_nothing(BlockManager, PoolExhausted, Request,
                                      Scheduler, st):
    bm = BlockManager(num_blocks=5, block_size=4)
    bm.allocate(2)
    with pytest.raises(PoolExhausted):
        bm.allocate(3)
    assert bm.num_free == 2                        # nothing leaked


def _grow_and_trim_follow_context(BlockManager, PoolExhausted, Request,
                                  Scheduler, st):
    bm = BlockManager(num_blocks=9, block_size=4)
    table = []
    assert len(bm.grow(table, 1)) == 1
    assert bm.grow(table, 4) == []
    assert len(bm.grow(table, 5)) == 1
    assert len(table) == 2
    bm.trim(table, 3)
    assert len(table) == 1 and bm.num_free == 7


def _fragmentation_is_last_block_padding(BlockManager, PoolExhausted, Request,
                                         Scheduler, st):
    bm = BlockManager(num_blocks=9, block_size=4)
    assert bm.fragmentation([5, 8]) == pytest.approx(3 / 16)
    assert bm.fragmentation([]) == 0.0


def _sched(BlockManager, Scheduler, num_slots=2, num_blocks=9, block_size=4,
           chunk=4, max_len=32):
    return Scheduler(num_slots, BlockManager(num_blocks, block_size), chunk,
                     max_len)


def _admission_is_fifo_into_free_slots(BlockManager, PoolExhausted, Request,
                                       Scheduler, st):
    s = _sched(BlockManager, Scheduler)
    reqs = [Request(prompt=np.arange(1, 4), max_new_tokens=4) for _ in range(3)]
    for r in reqs:
        s.submit(r)
    admitted = s.admit()
    assert [sl.request.rid for sl in admitted] == [reqs[0].rid, reqs[1].rid]
    assert reqs[0].state == st.PREFILL and reqs[2].state == st.WAITING
    assert s.blocks.num_used == 2
    assert s.admit() == []


def _admission_respects_pool_capacity(BlockManager, PoolExhausted, Request,
                                      Scheduler, st):
    s = _sched(BlockManager, Scheduler, num_slots=2, num_blocks=4)
    a = Request(prompt=np.arange(1, 9), max_new_tokens=4)
    b = Request(prompt=np.arange(1, 9), max_new_tokens=4)
    s.submit(a)
    s.submit(b)
    assert [sl.request.rid for sl in s.admit()] == [a.rid]
    assert b.state == st.WAITING


def _submit_rejects_over_length_requests(BlockManager, PoolExhausted, Request,
                                         Scheduler, st):
    s = _sched(BlockManager, Scheduler, max_len=16)
    with pytest.raises(ValueError):
        s.submit(Request(prompt=np.arange(1, 14), max_new_tokens=8))


def _submit_rejects_requests_that_can_never_fit(BlockManager, PoolExhausted,
                                                Request, Scheduler, st):
    s = _sched(BlockManager, Scheduler, num_slots=1, num_blocks=4,
               block_size=4, max_len=32)
    with pytest.raises(ValueError, match="KV blocks"):
        s.submit(Request(prompt=np.arange(1, 9), max_new_tokens=12))
    s.submit(Request(prompt=np.arange(1, 9), max_new_tokens=4))


def _scheduler_rejects_chunk_not_dividing_max_len(BlockManager, PoolExhausted,
                                                  Request, Scheduler, st):
    with pytest.raises(ValueError, match="prefill_chunk"):
        _sched(BlockManager, Scheduler, chunk=48, max_len=64)


def _preemption_evicts_youngest_and_requeues_front(BlockManager, PoolExhausted,
                                                   Request, Scheduler, st):
    s = _sched(BlockManager, Scheduler, num_slots=2, num_blocks=6,
               block_size=4, chunk=4)
    old = Request(prompt=np.arange(1, 5), max_new_tokens=16)
    young = Request(prompt=np.arange(1, 5), max_new_tokens=16)
    s.submit(old)
    s.submit(young)
    s.admit()
    for slot in s.slots:
        s.finish_prefill(slot)
        slot.request.output = [7, 8]
        slot.context_len = 6
    s.slots[0].context_len = s.slots[1].context_len = 8
    preempted = s.ensure_decode_capacity()
    assert [r.rid for r in preempted] == [young.rid]
    assert young.state == st.WAITING and s.waiting[0] is young
    assert list(young.prompt) == [1, 2, 3, 4, 7, 8]
    assert young.output == [] and young.preemptions == 1
    assert old.state == st.DECODE


HOST_CASES = [_block_alloc_free_roundtrip, _pool_exhausted_is_all_or_nothing,
              _grow_and_trim_follow_context, _fragmentation_is_last_block_padding,
              _admission_is_fifo_into_free_slots, _admission_respects_pool_capacity,
              _submit_rejects_over_length_requests,
              _submit_rejects_requests_that_can_never_fit,
              _scheduler_rejects_chunk_not_dividing_max_len,
              _preemption_evicts_youngest_and_requeues_front]


@pytest.mark.parametrize("impl", ["jax_package", "port"])
@pytest.mark.parametrize("case", HOST_CASES, ids=lambda f: f.__name__.strip("_"))
def test_host_serving_unit_cases(case, impl):
    case(*_host(impl))


# -- engine exactness --------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model) on the same weights."""
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.auto import (
        init_params,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.gpt2 import (
        Gpt2Config,
        Gpt2LMHeadModel,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
        params_from_jax,
    )

    jmodel = Gpt2LMHeadModel(Gpt2Config(dtype=jnp.float32, **TINY))
    params = init_params(jmodel, jmodel.config, seed=0)
    model = t_gpt2.Gpt2LMHeadModel(t_gpt2.Gpt2Config(**TINY))
    model.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}))
    return jmodel, params, model.eval()


def _port_run(model, trace, **kw):
    eng = ServeEngine(model, device="cpu", **kw)
    reqs = [eng.submit(p, m) for p, m in trace]
    eng.run()
    return eng, [[int(t) for t in eng.output_ids(r)] for r in reqs]


def _jax_run(jmodel, params, trace, **kw):
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve.engine import (
        ServeEngine as JaxServeEngine,
    )

    eng = JaxServeEngine(jmodel, params, kernel="xla", prefix_cache="off",
                         timeline="off", overlap="off", gather_buckets="full",
                         **kw)
    reqs = [eng.submit(p, m) for p, m in trace]
    eng.run()
    return eng, [[int(t) for t in eng.output_ids(r)] for r in reqs]


def _jax_generate_batch(jmodel, params, prompts, max_new):
    """JAX ``generate_causal`` greedy rows for same-length prompts."""
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.generate import (
        generate_causal,
    )

    out = np.asarray(generate_causal(jmodel, params, jnp.asarray(np.stack(prompts)),
                                     max_new_tokens=max_new))
    return [[int(t) for t in row] for row in out]


def _jax_generate(jmodel, params, prompt, max_new, eos):
    ref = _jax_generate_batch(jmodel, params, [prompt], max_new)[0]
    return ref[:ref.index(eos) + 1] if eos in ref else ref


def test_engine_matches_jax_engine_and_generate_mixed_lengths(models):
    jmodel, params, model = models
    rng = np.random.RandomState(0)
    trace = [(rng.randint(1, 120, (p,)).astype(np.int32), m)
             for p, m in [(5, 7), (9, 3), (12, 10), (5, 1), (9, 8)]]
    kw = dict(num_slots=3, block_size=4, num_blocks=40, prefill_chunk=8,
              max_model_len=64)
    eng, got = _port_run(model, trace, **kw)
    _, want = _jax_run(jmodel, params, trace, **kw)
    assert got == want
    # one generate_causal per prompt length (rows decode independently;
    # a longer budget only appends tokens) keeps the reference compiles few
    eos = TINY["eos_token_id"]
    for p_len in sorted({len(p) for p, _ in trace}):
        rows = [i for i, (p, _) in enumerate(trace) if len(p) == p_len]
        ref = _jax_generate_batch(jmodel, params, [trace[i][0] for i in rows],
                                  max(trace[i][1] for i in rows))
        for i, r in zip(rows, ref):
            r = r[:trace[i][1]]
            assert got[i] == (r[:r.index(eos) + 1] if eos in r else r)
    st = eng.stats()
    assert st.preemptions == 0 and st.paged_kernel_launches == 0
    assert st.tokens_generated == sum(len(t) for t in got)
    summary = eng.slo_summary()
    assert summary["requests"] == len(trace)
    assert {"ttft_p50_s", "ttft_p99_s", "e2e_p50_s", "e2e_p99_s"} <= set(summary)


def test_engine_exact_under_preemption(models):
    """9 allocatable blocks of 4 = 36 resident tokens for 5 requests that
    each want 27: preemption is forced, tokens stay the JAX engine's."""
    jmodel, params, model = models
    rng = np.random.RandomState(1)
    trace = [(rng.randint(1, 120, (9,)).astype(np.int32), 18) for _ in range(5)]
    kw = dict(num_slots=4, block_size=4, num_blocks=10, prefill_chunk=8,
              max_model_len=32)
    eng, got = _port_run(model, trace, **kw)
    jeng, want = _jax_run(jmodel, params, trace, **kw)
    assert got == want
    assert eng.stats().preemptions > 0
    assert eng.stats().preemptions == jeng.stats().preemptions
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.generate import (
        generate_causal,
    )

    for (prompt, max_new), tokens in zip(trace, got):
        ref = generate_causal(model, torch.from_numpy(prompt)[None],
                              max_new_tokens=max_new)[0].tolist()
        assert tokens == ref


def test_engine_stops_at_eos(models):
    jmodel, params, model = models
    prompt = np.random.RandomState(2).randint(1, 120, (9,)).astype(np.int32)
    ref = _jax_generate(jmodel, params, prompt, 12, eos=-1)
    eos = int(ref[2])                     # the engine must stop early
    eos_model = t_gpt2.Gpt2LMHeadModel(t_gpt2.Gpt2Config(
        **{**TINY, "eos_token_id": eos}))
    eos_model.load_state_dict(model.state_dict())
    _, got = _port_run(eos_model.eval(), [(prompt, 12)], num_slots=2,
                       block_size=4, num_blocks=20, prefill_chunk=8,
                       max_model_len=64)
    assert got == [ref[:ref.index(eos) + 1]]


def test_make_trace_matches_serve_bench():
    from benchmarks.serve_bench import make_trace as jax_make_trace

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.trace import (
        make_trace,
    )

    args = (20, 1023, 8, 48, (4, 16), (32, 64))
    got = make_trace(np.random.RandomState(5), *args, long_every=4)
    want = jax_make_trace(np.random.RandomState(5), *args, long_every=4)
    assert len(got) == len(want)
    for (gp, gm), (wp, wm) in zip(got, want):
        np.testing.assert_array_equal(gp, wp)
        assert gm == wm


# -- sampling and int8 pools ------------------------------------------------------

def _tiny(**kw):
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
        init_gpt2,
    )

    return init_gpt2(t_gpt2.Gpt2Config(**{**TINY, **kw}), seed=0, device="cpu")


def _plain_draws(model, prompt, output, req_kw) -> list:
    """What each of a sampled request's tokens must be: ``sample_per_slot``
    on a full forward of the prompt and the tokens before it."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.generate import (
        sample_per_slot,
    )

    seq = list(prompt) + list(output)
    with torch.no_grad():
        logits = model(torch.tensor([seq]))[0]
    want = []
    for n in range(len(output)):
        row = logits[len(prompt) + n - 1][None].float()
        want.append(int(sample_per_slot(
            row, torch.tensor([req_kw["temperature"]]), torch.tensor([req_kw["top_k"]]),
            torch.tensor([req_kw["top_p"]]), torch.tensor([req_kw["seed"]]),
            torch.tensor([n]))[0]))
    return want


def test_sampled_serve_is_seed_deterministic_across_preemption():
    """Identical seeds reproduce the streams bit for bit, preemption and
    requeue do not change them, another seed changes only its own stream,
    each sampled token is ``sample_per_slot``'s draw on the plain forward
    at its (seed, index), and the greedy rider stays ``generate_causal``."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.generate import (
        generate_causal,
    )

    model = _tiny()
    rng = np.random.RandomState(9)
    trace = [(rng.randint(1, 120, (9,)).astype(np.int32), 14) for _ in range(4)]
    kws = [dict(temperature=0.9, top_k=20, top_p=0.9, seed=s) for s in (1, 2, 3)] + [{}]

    def run(num_blocks, kws):
        eng = ServeEngine(model, num_slots=3, block_size=4, num_blocks=num_blocks,
                          prefill_chunk=8, max_model_len=32, device="cpu")
        reqs = [eng.submit(p, m, **kw) for (p, m), kw in zip(trace, kws)]
        eng.run()
        return [[int(t) for t in eng.output_ids(r)] for r in reqs], eng

    base, _ = run(40, kws)
    again, _ = run(40, kws)
    assert again == base
    tight, teng = run(9, kws)
    assert teng.stats().preemptions > 0
    assert tight == base
    reseeded, _ = run(40, [dict(kws[0], seed=99)] + kws[1:])
    assert reseeded[0] != base[0] and reseeded[1:] == base[1:]
    for (prompt, _), kw, out in zip(trace[:3], kws, base):
        assert out == _plain_draws(model, prompt, out, kw)
    prompt, m = trace[3]
    assert base[3] == generate_causal(model, prompt[None], max_new_tokens=m)[0].tolist()


def test_request_rejects_bad_sampling_params():
    """The port's ``Request`` refuses what the JAX ``Request`` refuses."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve.scheduler import (
        Request as JaxRequest,
    )

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.scheduler import Request

    for bad, match in ((dict(temperature=-1.0), "temperature"), (dict(top_p=1.5), "top_p"),
                       (dict(top_k=-2), "top_k")):
        for cls in (Request, JaxRequest):
            with pytest.raises(ValueError, match=match):
                cls(prompt=np.arange(1, 4), max_new_tokens=2, **bad)
    req = Request(prompt=np.arange(1, 4), max_new_tokens=2, temperature=0.5)
    assert req.sampled and not Request(prompt=np.arange(1, 4), max_new_tokens=2).sampled


def test_engine_exact_int8_pools_under_preemption(models):
    """int8 pools with fp32 scales: tokens equal ``generate_causal`` on the
    int8 dense cache of the same config and the JAX engine's int8 pools,
    under forced recompute preemption; a token costs fewer bytes than in
    fp pools."""
    import dataclasses

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.generate import (
        generate_causal,
    )

    jmodel, params, model = models
    int8 = t_gpt2.Gpt2LMHeadModel(dataclasses.replace(model.config, kv_cache_dtype="int8"))
    int8.load_state_dict(model.state_dict())
    int8.eval()
    rng = np.random.RandomState(12)
    trace = [(rng.randint(1, 120, (9,)).astype(np.int32), 18) for _ in range(4)]
    kw = dict(num_slots=4, block_size=4, num_blocks=10, prefill_chunk=8, max_model_len=32)
    eng, got = _port_run(int8, trace, **kw)
    assert eng.stats().preemptions > 0 and eng.kv_cache_dtype == "int8"
    assert {p.dtype for p in eng.k_pools + eng.v_pools} == {torch.int8}
    assert {p.dtype for p in eng.k_scale_pools + eng.v_scale_pools} == {torch.float32}
    for (prompt, max_new), tokens in zip(trace, got):
        assert tokens == generate_causal(int8, prompt[None], max_new_tokens=max_new)[0].tolist()
    jint8 = jmodel.clone(config=dataclasses.replace(jmodel.config, kv_cache_dtype="int8"))
    _, want = _jax_run(jint8, params, trace, **kw)
    assert got == want
    fp_eng, _ = _port_run(model, trace[:1], **kw)
    assert eng.blocks.token_bytes < fp_eng.blocks.token_bytes
    # the knob overrides the model's own storage
    assert ServeEngine(model, kv_cache_dtype="int8", device="cpu", **{
        k: v for k, v in kw.items() if k != "num_slots"}).kv_cache_dtype == "int8"


def test_kv_pool_bytes_doubles_int8_admission(models):
    """Pools sized by the same byte budget hold about twice the blocks in
    int8 (scales counted) and, through the block-denominated admission,
    at least twice the resident requests."""
    import dataclasses

    _, _, model = models
    int8 = t_gpt2.Gpt2LMHeadModel(dataclasses.replace(model.config, kv_cache_dtype="int8"))
    int8.load_state_dict(model.state_dict())
    rng = np.random.RandomState(16)
    trace = [(rng.randint(1, 120, (8,)).astype(np.int32), 8) for _ in range(6)]
    kw = dict(num_slots=6, block_size=4, prefill_chunk=8, max_model_len=32)
    probe = ServeEngine(model, num_blocks=8, device="cpu", **kw)
    budget = 5 * probe.blocks.block_bytes
    fp_eng, fp_got = _port_run(model, trace, kv_pool_bytes=budget, **kw)
    int8_eng, _ = _port_run(int8.eval(), trace, kv_pool_bytes=budget, **kw)
    assert fp_eng.blocks.num_blocks == 6
    assert int8_eng.blocks.num_blocks >= 2 * fp_eng.blocks.num_blocks - 1
    assert (int8_eng.stats().peak_resident_requests
            >= 2 * fp_eng.stats().peak_resident_requests)
    head_dim = TINY["hidden_size"] // TINY["num_heads"]
    assert int8_eng.blocks.token_bytes * 4 * head_dim == (
        fp_eng.blocks.token_bytes * (head_dim + 4))


def test_cli_samples_and_serves_int8_pools_from_a_model_dir(tmp_path):
    """``--model_dir`` serves a GPT-2 export; ``--temperature`` and the
    sampling flags set every request's default (JSONL fields override,
    and a non-integral ``top_k`` is refused naming its line);
    ``--kv_cache_dtype int8`` serves from int8 pools."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto as t_auto

    model = _tiny()
    t_auto.save_pretrained(str(tmp_path / "gpt2"), model, "gpt2", model.config)
    trace = tmp_path / "req.jsonl"
    trace.write_text("\n".join([json.dumps({"prompt_ids": [3, 4, 5, 6], "max_new_tokens": 5}),
                                json.dumps({"prompt_ids": [7, 8, 9], "max_new_tokens": 5,
                                            "temperature": 0})]) + "\n")

    def serve(*extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["--device", "cpu", "--model_dir", str(tmp_path / "gpt2"),
                      "--input_file", str(trace), "--num_slots", "2", *extra])
        lines = [json.loads(x) for x in buf.getvalue().splitlines()]
        return [r["output_ids"] for r in lines[:-1]], lines[-1]

    greedy, summary = serve()
    assert summary["kv_dtype"] == "fp"
    sampled, _ = serve("--temperature", "1.0", "--top_k", "50", "--sample_seed", "3")
    assert sampled[1] == greedy[1] and sampled[0] != greedy[0]
    assert serve("--temperature", "1.0", "--top_k", "50", "--sample_seed", "3")[0] == sampled
    int8, summary = serve("--kv_cache_dtype", "int8")
    assert summary["kv_dtype"] == "int8" and [len(r) for r in int8] == [5, 5]
    trace.write_text(json.dumps({"prompt_ids": [3, 4], "top_k": 2.5}) + "\n")
    with pytest.raises(SystemExit, match="req.jsonl:1"):
        serve()


# scripts/serve.py's single-engine summary keys
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
    "kv_peak_utilization"}


def test_cli_serves_on_cpu(tmp_path):
    trace = tmp_path / "req.jsonl"
    trace.write_text("\n".join(json.dumps({"prompt_ids": [3, 4, 5, 6],
                                           "max_new_tokens": m})
                               for m in (3, 5)) + "\n")
    for extra in ([], ["--input_file", str(trace)]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["--device", "cpu", "--requests", "5",
                      "--max_new_tokens", "8", "--num_slots", "2", *extra])
        lines = [json.loads(x) for x in buf.getvalue().splitlines()]
        rows, summary = lines[:-1], lines[-1]
        assert summary["summary"] is True
        assert len(rows) == summary["requests"] == (5 if not extra else 2)
        assert set(summary) - {"paged_kernel_launches"} <= SERVE_SUMMARY_KEYS
        assert summary["paged_kernel_launches"] == 0
        assert summary["tokens"] == sum(len(r["output_ids"]) for r in rows)
        if extra:
            assert [len(r["output_ids"]) for r in rows] == [3, 5]


def test_entry_points_need_cuda_unless_cpu_is_asked():
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
        init_gpt2,
    )

    cfg = t_gpt2.Gpt2Config(**TINY)
    model = init_gpt2(cfg, seed=0, device="cpu")
    ServeEngine(model, num_blocks=9, block_size=4, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_gpt2(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, num_blocks=9, block_size=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--requests", "1"])
