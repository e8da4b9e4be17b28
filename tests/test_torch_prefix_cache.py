"""PyTorch port: the prefix cache and the KV hierarchy (``serve/paged_kv.py``,
the scheduler's cache-aware admission, the engine's copy-on-write). The
JAX package's own host-side cases run against both packages; the chain
keys equal the JAX keys value for value; one random schedule runs op for
op on both packages' ``BlockManager``s with equal state after every op;
``extract_blocks`` / ``insert_blocks`` round-trip bitwise; and the
engine's greedy tokens equal the JAX engine's and ``generate_causal``'s
under forced copy-on-write and under preemption of a sharing request."""

from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import test_serve as jax_serve_cases
from huggingface_sagemaker_tensorflow_distributed_tpu.serve import paged_kv as j_pkv
from huggingface_sagemaker_tensorflow_distributed_tpu.serve import scheduler as j_sched
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve import paged_kv as t_pkv
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve import scheduler as t_sched
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import ServeEngine
from torch_decode_pairs import (  # noqa: F401
    as_port,
    detached_compile_trackers,
    gpt2_pair,
    one_torch_thread,
)

# -- the JAX package's host-side cases, both packages ---------------------------

HOST_CASES = [
    ("gather_waste", jax_serve_cases.test_block_manager_gather_waste_accounting, ()),
    ("verify_waste", jax_serve_cases.test_block_manager_verify_waste_is_separate_from_gather_waste,
     ()),
    ("double_free", jax_serve_cases.test_block_manager_double_free_guard, ()),
    ("prefix_lru", jax_serve_cases.test_block_manager_prefix_match_register_lru_roundtrip, ()),
    ("privatize_cow", jax_serve_cases.test_block_manager_privatize_cow_semantics, ()),
    ("conservation_seed0", jax_serve_cases.test_block_conservation_under_random_schedule,
     (0,)),
    ("conservation_seed1", jax_serve_cases.test_block_conservation_under_random_schedule,
     (1,)),
    ("lookahead", jax_serve_cases.test_scheduler_lookahead_reserves_verify_window, ()),
    ("revive_pinned", jax_serve_cases.test_revive_survives_budget_eviction_during_reservation,
     ()),
]


@pytest.mark.parametrize("impl", ["jax_package", "port"])
@pytest.mark.parametrize("case", HOST_CASES, ids=[c[0] for c in HOST_CASES])
def test_jax_host_cases_hold_on_both_packages(case, impl, monkeypatch):
    _, fn, seeds = case
    if impl == "port":
        as_port(monkeypatch, jax_serve_cases)
        assert jax_serve_cases.BlockManager is t_pkv.BlockManager
        assert jax_serve_cases.Scheduler is t_sched.Scheduler
    fn(*(np.random.RandomState(s) for s in seeds))


# -- chain keys ------------------------------------------------------------------

@pytest.mark.parametrize("block_size", [1, 4, 16])
def test_chain_keys_equal_the_jax_keys(block_size):
    rng = np.random.RandomState(block_size)
    for n in (0, 3, 17, 64, 200):
        tokens = rng.randint(0, 50257, (n,)).astype(np.int32)
        want = list(j_pkv.prefix_chain_keys(tokens, block_size))
        assert list(t_pkv.prefix_chain_keys(tokens, block_size)) == want
        assert list(t_pkv.prefix_chain_keys(tokens.tolist(), block_size)) == want
        assert len(want) == n // block_size
    assert t_pkv._CHAIN_ROOT == j_pkv._CHAIN_ROOT


# -- one random schedule, op for op on both managers ------------------------------

def _state(s, order) -> tuple:
    """Everything the two packages' managers and schedulers must agree on;
    requests named by their submission index."""
    bm = s.blocks
    return (list(bm._free), list(bm._ref), list(bm._lru), list(bm._hosted),
            [(k, e.parent, e.chunk, e.nbytes) for k, e in bm._host_payloads.items()],
            {k: tuple(e) for k, e in bm._index.items()}, dict(bm._block_key),
            bm.num_used, bm.num_cached, bm.num_hosted, bm.hosted_bytes, bm.peak_used,
            bm.cow_copies, bm.prefix_evictions, bm.prefix_demotions, bm.host_evictions,
            bm.host_tier_hits, bm.host_tier_lookups, bm.blocks_saved(),
            bm.peak_shared_blocks, bm.peak_blocks_saved,
            [(sl.table, sl.context_len, sl.prefill_pos, len(sl.pending_copies),
              len(sl.pending_restores), sl.pending_swap_in is not None,
              None if sl.free else order[id(sl.request)]) for sl in s.slots],
            [order[id(r)] for r in s.waiting], s.n_preemptions)


@pytest.mark.parametrize("seed", [0, 2, 3])
def test_block_managers_agree_op_for_op(seed):
    """The JAX ``test_block_conservation_under_random_schedule`` schedule
    (submit, admit, prefill, decode, preempt with swap or recompute, demote,
    finish; prefix cache on, a tight pool and host budget), each op applied
    to both packages: refcounts, free list, LRU order, host tier and every
    slot equal after every op, and conservation on the port."""
    rng = np.random.RandomState(seed)
    pkgs = []
    for pkv, sch in ((j_pkv, j_sched), (t_pkv, t_sched)):
        bm = pkv.BlockManager(num_blocks=20, block_size=4)
        s = sch.Scheduler(3, bm, 8, 32, prefix_cache=True)
        bm.set_spill(lambda b: SimpleNamespace(nbytes=64), host_budget=1024)
        pkgs.append((s, sch, np.random.RandomState(100 + seed), {}))

    def hook_for(s, swap_rng):
        def swap_hook(slot):
            if not swap_rng.randint(0, 2):
                return False
            n = s.blocks.blocks_for(slot.context_len)
            if n <= 0 or n > len(slot.table) or not s.blocks.host_reserve(n * 64):
                return False
            slot.request.swap_set = SimpleNamespace(n_blocks=n, nbytes=n * 64)
            slot.request.swap_context = slot.context_len
            return True
        return swap_hook

    for s, _, swap_rng, _ in pkgs:
        s.swap_hook = hook_for(s, swap_rng)
    prefixes = [rng.randint(1, 100, (12,)).astype(np.int32),
                rng.randint(1, 100, (20,)).astype(np.int32)]
    n_submitted = 0
    for step in range(300):
        op = rng.randint(0, 6)
        if op == 0 and len(pkgs[0][0].waiting) < 4:
            if rng.randint(0, 2):
                pre = prefixes[rng.randint(0, len(prefixes))]
                prompt = np.concatenate(
                    [pre, rng.randint(1, 100, (rng.randint(1, 6),)).astype(np.int32)])
            else:
                prompt = rng.randint(1, 100, (rng.randint(1, 16),)).astype(np.int32)
            max_new = int(rng.randint(1, 5))
        elif op == 4:
            pick = rng.randint(0, 1 << 30)
        elif op == 5:
            n_demote = int(rng.randint(1, 3))
        for s, sch, _, order in pkgs:
            if op == 0 and len(s.waiting) < 4:
                req = sch.Request(prompt=prompt, max_new_tokens=max_new)
                try:
                    s.submit(req)
                    order[id(req)] = n_submitted
                except ValueError:
                    pass
            elif op == 1:
                s.admit()
            elif op == 2:
                for slot in s.next_prefill_slots(3):
                    slot.prefill_pos += s.prefill_chunk
                    if slot.prefill_pos >= s.padded_prompt_len(slot.request):
                        s.finish_prefill(slot)
            elif op == 3:
                s.ensure_decode_capacity()
                for slot in s.decode_slots():
                    slot.context_len += 1
                    slot.request.output.append(0)
                    if len(slot.request.output) >= slot.request.max_new_tokens:
                        s.finish(slot)
            elif op == 4:
                ds = s.decode_slots()
                if ds:
                    s.preempt(ds[pick % len(ds)])
            elif op == 5:
                s.blocks.demote(max_blocks=n_demote)
        if op == 0 and len(pkgs[0][3]) > n_submitted:
            n_submitted += 1
        want, got = (_state(s, order) for s, _, _, order in pkgs)
        assert got == want, f"step {step} (op {op}): the managers differ"
        bm = pkgs[1][0].blocks
        assert bm.num_free + bm.num_used + bm.num_cached + bm.num_hosted == bm.num_blocks - 1
        held = Counter(b for sl in pkgs[1][0].slots if not sl.free for b in sl.table)
        assert dict(held) == {b: r for b, r in enumerate(bm._ref) if r > 0}
    s, bm = pkgs[1][0], pkgs[1][0].blocks
    # the schedule reached sharing, copy-on-write, preemption, the host tier
    assert bm.peak_shared_blocks > 0 and bm.cow_copies > 0
    assert s.n_preemptions > 0 and bm.prefix_demotions > 0


# -- extract / insert ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_extract_insert_blocks_roundtrip_bitwise(dtype):
    """A block set leaves every pool (int8 values with their fp32 scale
    pools; a draft's pools) and lands bitwise in other ids or the same
    ids; the manager never moves; mismatched calls raise."""
    gen = torch.Generator().manual_seed(17)
    nb, bs = 12, 4
    if dtype == "int8":
        pools = [torch.randint(-127, 128, (nb, bs, 2, 3), generator=gen).to(torch.int8),
                 torch.rand(nb, bs, 2, 1, generator=gen)]
    else:
        pools = [torch.randn(nb, bs, 2, 3, generator=gen).to(getattr(torch, dtype))
                 for _ in range(2)]
    d_pools = [torch.randn(nb, bs, 2, 3, generator=gen)]
    before = [p.clone() for p in pools]
    bm = t_pkv.BlockManager(num_blocks=nb, block_size=bs)
    src = bm.allocate(3)
    snapshot = (list(bm._free), bm.num_used)
    bset = t_pkv.extract_blocks(pools, src, d_pools=d_pools)
    assert bset.n_blocks == 3
    assert bset.nbytes == sum(p[:3].numel() * p.element_size() for p in pools + d_pools)
    assert bset.signature == (tuple((tuple(p.shape[1:]), str(p.dtype)[6:]) for p in pools),
                              ((tuple(d_pools[0].shape[1:]), "float32"),))
    dst = [b for b in range(1, nb) if b not in src][:3]
    zero = [torch.zeros_like(p) for p in pools]
    zero_d = [torch.zeros_like(d_pools[0])]
    out, out_d = t_pkv.insert_blocks(zero, bset, dst, d_pools=zero_d)
    assert out is zero and out_d is zero_d                  # in place
    for p, b in zip(out, before):
        assert p.dtype == b.dtype
        assert torch.equal(p[dst], b[src])
        assert not p[[i for i in range(nb) if i not in dst]].any()
    assert torch.equal(out_d[0][dst], d_pools[0][src])
    back = [torch.zeros_like(p) for p in pools]
    t_pkv.insert_blocks(back, bset, src, d_pools=[torch.zeros_like(d_pools[0])])
    for p, b in zip(back, before):
        assert torch.equal(p[src], b[src])
    assert (list(bm._free), bm.num_used) == snapshot
    sets = t_pkv.extract_block_sets(pools, [src[:1], [], src], d_pools=d_pools)
    assert [s.n_blocks for s in sets] == [1, 0, 3]
    for a, b in zip(sets[2].payloads, bset.payloads):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        t_pkv.insert_blocks(zero, bset, dst[:2], d_pools=zero_d)
    with pytest.raises(ValueError):
        t_pkv.insert_blocks(zero, bset, dst)                # draft payloads, no d_pools


# -- the engine ----------------------------------------------------------------------

TINY_EOS = 127


@pytest.fixture(scope="module")
def pair():
    """(JAX GPT-2 with eos 127, its params, the port's twin)."""
    return gpt2_pair(num_layers=2, vocab=128, eos_token_id=TINY_EOS, pad_token_id=0)


def _prefix_trace(rng, prefix_len, tails, max_news, vocab=120):
    """Requests sharing one random prefix, with random tails."""
    prefix = rng.randint(1, vocab, (prefix_len,)).astype(np.int32)
    return [(np.concatenate([prefix, rng.randint(1, vocab, (t,)).astype(np.int32)])
             if t else prefix.copy(), m) for t, m in zip(tails, max_news)]


def run_port(model, trace, kws=None, **kw):
    eng = ServeEngine(model, device="cpu", **kw)
    reqs = [eng.submit(p, m, **(kws[i] if kws else {})) for i, (p, m) in enumerate(trace)]
    eng.run()
    return eng, [[int(t) for t in eng.output_ids(r)] for r in reqs]


def run_jax(jmodel, params, trace, **kw):
    """The JAX engine on the gather route, serial, telemetry off."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.serve.engine import (
        ServeEngine as JaxServeEngine,
    )

    kw = {"kernel": "xla", "overlap": "off", "timeline": "off", **kw}
    eng = JaxServeEngine(jmodel, params, **kw)
    reqs = [eng.submit(p, m) for p, m in trace]
    eng.run()
    return eng, [[int(t) for t in eng.output_ids(r)] for r in reqs]


def plain_greedy(model, trace) -> list:
    """The port's ``generate_causal`` per request, cut after the EOS."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.generate import (
        generate_causal,
    )

    out = []
    for prompt, max_new in trace:
        ref = generate_causal(model, torch.from_numpy(prompt)[None],
                              max_new_tokens=max_new)[0].tolist()
        out.append(ref[:ref.index(TINY_EOS) + 1] if TINY_EOS in ref else ref)
    return out


def test_prefix_cache_exact_with_forced_cow(pair):
    """A long-running request and short riders sharing its 12-token prefix,
    admitted while it still holds its blocks: block 4 under chunk 8 puts a
    shared block in the riders' first chunk, so admission copies it first
    (in every pool). Tokens equal the JAX engine's (which copies too) and
    ``generate_causal``; every block comes back free or cached."""
    jmodel, params, model = pair
    trace = _prefix_trace(np.random.RandomState(21), 12, tails=[3, 0, 2, 1, 2],
                          max_news=[14, 2, 4, 3, 4])
    kw = dict(num_slots=2, block_size=4, num_blocks=40, prefill_chunk=8, max_model_len=32)
    eng, got = run_port(model, trace, **kw)
    jeng, want = run_jax(jmodel, params, trace, prefix_cache="on", **kw)
    assert got == want == plain_greedy(model, trace)
    st = eng.stats()
    assert st.prefix_cache and st.cow_copies > 0 and st.cache_hit_rate > 0
    assert st.blocks_shared_peak > 0 and st.prefix_cached_tokens > 0
    assert st.cow_copies == jeng.stats().cow_copies
    assert eng.blocks.num_used == 0
    assert eng.blocks.num_free + eng.blocks.num_cached == eng.blocks.num_blocks - 1


def test_cow_copies_every_pool(pair):
    """``_apply_cow`` copies a block in the K, V, scale and draft pools."""
    _, _, model = pair
    eng = ServeEngine(model, device="cpu", num_blocks=12, block_size=4, max_model_len=32,
                      prefill_chunk=8, kv_cache_dtype="int8", speculate_k=2, draft=1)
    every = eng._kv.all() + eng._dkv.all()
    assert len(every) == 4 * 2 + 4 * 1
    for p in every:
        p[3] = torch.arange(p[3].numel()).reshape(p[3].shape).to(p.dtype)
    slot = eng.sched.slots[0]
    slot.pending_copies = [(3, 7)]
    eng._apply_cow(slot)
    assert slot.pending_copies == []
    for p in every:
        assert torch.equal(p[7], p[3]) and p[7].any()


def test_prefix_cache_exact_under_preemption_of_a_sharing_request(pair):
    """Recompute preemption of a request sharing the prefix releases its
    references only; the folded prompt hits the cache again. Tokens and
    preemptions equal the JAX engine's; nothing leaks."""
    jmodel, params, model = pair
    trace = _prefix_trace(np.random.RandomState(22), 12, tails=[2, 3, 1, 2, 3],
                          max_news=[12] * 5)
    kw = dict(num_slots=4, block_size=4, num_blocks=12, prefill_chunk=8, max_model_len=32)
    eng, got = run_port(model, trace, **kw)
    jeng, want = run_jax(jmodel, params, trace, prefix_cache="on", **kw)
    assert got == want == plain_greedy(model, trace)
    assert eng.stats().preemptions == jeng.stats().preemptions > 0
    assert eng.stats().prefix_cached_tokens > 0
    assert eng.blocks.num_used == 0
    assert eng.blocks.num_free + eng.blocks.num_cached == eng.blocks.num_blocks - 1


def test_prefix_cache_off_matches_on_and_stays_cold(pair):
    """``prefix_cache='off'`` serves the same tokens (sampled streams
    included), never touches the index, the LRU or copy-on-write, and
    frees every block."""
    _, _, model = pair
    trace = _prefix_trace(np.random.RandomState(24), 12, tails=[3, 1, 2, 2],
                          max_news=[8, 6, 7, 5])
    kws = [{}, dict(temperature=0.9, top_k=20, top_p=0.9, seed=7), {},
           dict(temperature=0.7, seed=3)]
    kw = dict(num_slots=3, block_size=4, num_blocks=40, prefill_chunk=8, max_model_len=32)
    eng_on, on = run_port(model, trace, kws, prefix_cache="on", **kw)
    eng_off, off = run_port(model, trace, kws, prefix_cache="off", **kw)
    assert on == off
    assert eng_on.stats().prefix_cached_tokens > 0
    assert not eng_off.prefix_cache and eng_off.blocks.num_cached == 0
    assert eng_off.blocks.cow_copies == 0 and eng_off.blocks.peak_shared_blocks == 0
    assert eng_off.stats().cache_hit_rate is None
    assert eng_off.blocks.num_free == eng_off.blocks.num_blocks - 1
    greedy = [i for i, k in enumerate(kws) if not k]
    assert [on[i] for i in greedy] == plain_greedy(model, [trace[i] for i in greedy])


def test_generated_tail_registers_and_a_resubmit_hits_the_cache(pair):
    """At finish a request's full blocks, its generation included, are
    published: resubmitting prompt + output hits them (the same cached
    tokens as the JAX engine's), tokens unchanged."""
    jmodel, params, model = pair
    prompt = np.random.RandomState(25).randint(1, 120, (6,)).astype(np.int32)
    kw = dict(num_slots=1, block_size=4, num_blocks=20, prefill_chunk=4, max_model_len=32)
    eng = ServeEngine(model, device="cpu", **kw)
    first = eng.submit(prompt, 10)
    eng.run()
    out = [int(t) for t in eng.output_ids(first)]
    follow = np.concatenate([prompt, np.asarray(out, np.int32)])
    again = eng.submit(follow, 3)
    eng.run()
    jeng, _ = run_jax(jmodel, params, [(prompt, 10)], prefix_cache="on", **kw)
    jagain = jeng.submit(follow, 3)
    jeng.run()
    assert again.prefix_cached_tokens == jagain.prefix_cached_tokens > 0
    assert [int(t) for t in eng.output_ids(again)] == plain_greedy(model, [(follow, 3)])[0]
