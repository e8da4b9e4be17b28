"""PyTorch port: swap preemption and the host KV tier (the engine's
``swap`` / ``swap_bytes`` knobs over ``serve/paged_kv.py``'s host tier).
On the forced-preemption trace a swapped and restored request's greedy
tokens equal the recompute path's, the JAX engine's (with the same swap
counts) and ``generate_causal``'s, with overlap on and off, with int8
pools and with a draft's pools; sampled streams are the same bit for bit
under swap and under ``auto``; a budget too small for a victim falls back
to recompute; and prefix demotion revives host-tier blocks instead of
prefilling them again, with the JAX engine's host-tier hits."""

import dataclasses

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.generate import (
    generate_causal,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import ServeEngine
from torch_decode_pairs import (  # noqa: F401
    detached_compile_trackers,
    gpt2_pair,
    one_torch_thread,
)

EOS = 127
TIGHT = dict(num_slots=4, block_size=4, num_blocks=10, prefill_chunk=8, max_model_len=32)


@pytest.fixture(scope="module")
def pair():
    return gpt2_pair(num_layers=2, vocab=128, eos_token_id=EOS, pad_token_id=0)


@pytest.fixture(scope="module")
def trace():
    rng = np.random.RandomState(1)
    return [(rng.randint(1, 120, (9,)).astype(np.int32), 18) for _ in range(5)]


def run_port(model, trace, kws=None, **kw):
    eng = ServeEngine(model, device="cpu", **kw)
    reqs = [eng.submit(p, m, **(kws[i] if kws else {})) for i, (p, m) in enumerate(trace)]
    eng.run()
    return eng, [[int(t) for t in eng.output_ids(r)] for r in reqs]


def run_jax(jmodel, params, trace, **kw):
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve.engine import (
        ServeEngine as JaxServeEngine,
    )

    kw = {"kernel": "xla", "overlap": "off", "timeline": "off", **kw}
    eng = JaxServeEngine(jmodel, params, **kw)
    reqs = [eng.submit(p, m) for p, m in trace]
    eng.run()
    return eng, [[int(t) for t in eng.output_ids(r)] for r in reqs]


def plain_greedy(model, trace) -> list:
    out = []
    for prompt, max_new in trace:
        ref = generate_causal(model, torch.from_numpy(prompt)[None],
                              max_new_tokens=max_new)[0].tolist()
        out.append(ref[:ref.index(EOS) + 1] if EOS in ref else ref)
    return out


@pytest.mark.parametrize("overlap", ["on", "off"])
def test_swap_preemption_token_exact_greedy(pair, trace, overlap):
    """``swap='always'``: victims' blocks go to host and come back at
    re-admission (no re-prefill, output unfolded); the tokens equal the
    recompute run's, the JAX engine's and ``generate_causal``'s, the swap
    counts the JAX engine's; the reservations are all returned."""
    jmodel, params, model = pair
    eng, got = run_port(model, trace, swap="always", overlap=overlap, **TIGHT)
    _, recompute = run_port(model, trace, swap="off", overlap=overlap, **TIGHT)
    jeng, want = run_jax(jmodel, params, trace, swap="always", **TIGHT)
    assert got == recompute == want == plain_greedy(model, trace)
    st, jst = eng.stats(), jeng.stats()
    assert st.swap_outs == st.swap_ins > 0 and st.swap_bytes > 0
    assert st.recompute_tokens_avoided > 0 and st.swap_policy == "always"
    if overlap == "off":
        for f in ("swap_outs", "swap_ins", "swap_bytes", "recompute_tokens_avoided",
                  "preemptions"):
            assert getattr(st, f) == getattr(jst, f), f
    else:
        assert eng.overlap_flushes > 0          # extraction acts on committed state
    # every swap reservation returned; what stays host-side is demoted prefixes
    assert eng.blocks._swap_bytes_held == 0 and eng.blocks.num_used == 0
    assert eng.blocks.hosted_bytes == eng.blocks._host_bytes
    assert all(r.swap_set is None for r in eng.finished.values())


def test_swap_sampled_bitwise_and_auto_policy(pair, trace):
    """Sampled streams under swap equal the roomy pool's bit for bit (the
    draw index is the output length, which swap never rewinds); ``auto``
    chooses per victim and changes no token."""
    _, _, model = pair
    kws = [dict(temperature=0.9, top_k=20, top_p=0.9, seed=s) for s in range(5)]
    _, roomy = run_port(model, trace, kws, **{**TIGHT, "num_blocks": 60})
    eng, swapped = run_port(model, trace, kws, swap="always", **TIGHT)
    assert swapped == roomy and eng.stats().swap_outs > 0
    auto_eng, auto = run_port(model, trace, kws, swap="auto", **TIGHT)
    assert auto == roomy and auto_eng.stats().preemptions > 0
    # the estimate: a victim swaps when moving its blocks both ways costs
    # less than streaming the weights once per prefill chunk
    assert auto_eng._param_bytes == sum(p.numel() * p.element_size()
                                        for p in model.parameters())


def test_swap_int8_pools_and_draft_pools(pair, trace):
    """int8 pools travel with their scale pools, a speculative engine's
    draft pools with the target's: tokens equal ``generate_causal`` on the
    int8 cache and the JAX int8 engine's."""
    jmodel, params, model = pair
    int8 = type(model)(dataclasses.replace(model.config, kv_cache_dtype="int8"))
    int8.load_state_dict(model.state_dict())
    int8.eval()
    eng, got = run_port(model, trace, swap="always", kv_cache_dtype="int8", **TIGHT)
    jint8 = jmodel.clone(config=dataclasses.replace(jmodel.config, kv_cache_dtype="int8"))
    _, want = run_jax(jint8, params, trace, swap="always", **TIGHT)
    assert got == want == plain_greedy(int8, trace)
    assert eng.stats().swap_outs > 0
    # 2 layers x (K, V int8 + their fp32 scales) of 4 heads x 8 dims per token
    assert eng._host_block_bytes == 4 * 2 * 2 * 4 * (8 + 4)
    spec_kw = {**TIGHT, "num_blocks": 11}
    seng, sgot = run_port(model, trace, swap="always", speculate_k=2, draft=1, **spec_kw)
    assert sgot == plain_greedy(model, trace)
    assert seng.stats().swap_outs > 0
    assert seng._host_block_bytes == 4 * 4 * (2 * 2 * 4 * 8 + 1 * 2 * 4 * 8)   # fp32


def test_swap_budget_falls_back_to_recompute(pair, trace):
    """A host budget below one victim's blocks: nothing swaps, every
    preemption recomputes, tokens unchanged."""
    _, _, model = pair
    eng, got = run_port(model, trace, swap="always", swap_bytes=64, **TIGHT)
    assert got == plain_greedy(model, trace)
    assert eng.stats().preemptions > 0 and eng.stats().swap_outs == 0


def test_prefix_demotion_revives_instead_of_recomputing(pair):
    """Two templates alternating over a pool that holds one: evict-only
    (``swap='off'``) misses every swing, the tier (``never``: demotion,
    recompute preemption) revives demoted blocks from host. Tokens equal,
    and the hit rates and host-tier hits equal the JAX engine's."""
    jmodel, params, model = pair
    rng = np.random.RandomState(31)
    t1 = rng.randint(1, 120, (16,)).astype(np.int32)
    t2 = rng.randint(1, 120, (16,)).astype(np.int32)
    trace = [(np.concatenate([t, rng.randint(1, 120, (2,)).astype(np.int32)]), 3)
             for _ in range(6) for t in (t1, t2)]
    kw = dict(num_slots=1, block_size=4, num_blocks=8, prefill_chunk=8, max_model_len=32)
    off_eng, off = run_port(model, trace, swap="off", **kw)
    tier_eng, tier = run_port(model, trace, swap="never", **kw)
    jeng, want = run_jax(jmodel, params, trace, swap="never", **kw)
    assert tier == off == want
    st, jst = tier_eng.stats(), jeng.stats()
    assert st.cache_hit_rate > (off_eng.stats().cache_hit_rate or 0.0)
    assert st.host_tier_hits == jst.host_tier_hits > 0
    assert st.host_tier_hit_rate == pytest.approx(jst.host_tier_hit_rate)
    assert st.cache_hit_rate == pytest.approx(jst.cache_hit_rate)
    assert off_eng.stats().host_tier_hit_rate is None
    bm = tier_eng.blocks
    assert bm.num_free + bm.num_used + bm.num_cached + bm.num_hosted == bm.num_blocks - 1
