"""PyTorch port: sampling, chunked prefill and beam search
(``models/generate.py``) against the JAX package's ``models/generate.py``
on the same weights and the same numpy inputs from a seed.

Tolerances: the filters and ``warp_logits_per_slot`` bit for bit (the
kept logits are passed through, so their masks decide); sampled tokens
exact when both packages draw with JAX's own Gumbel noise for the seed
(``_gumbel`` fed the JAX stream); beam tokens exact and scores within
1e-5 absolute; chunked prefill tokens exact against the single pass and
against JAX."""

import json

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs as t_obs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import generate as t_gen
from torch_decode_pairs import (  # noqa: F401  (autouse fixtures)
    detached_compile_trackers,
    feed_noise,
    gpt2_pair,
    jax_gumbel_stream,
    one_torch_thread,
    seq2seq_pair,
    with_eos,
)


def _j():
    from huggingface_sagemaker_tensorflow_distributed_tpu.models import generate as j_gen

    return j_gen


def _same(got: torch.Tensor, want) -> None:
    """Bit-for-bit equality, ``-inf`` included."""
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got.numpy()), np.isneginf(want))
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


# -- the filters -------------------------------------------------------------------

def _rows():
    """Hand-built rows: ties at the k-th value, a probability row whose
    cumulative mass meets top_p exactly at 0.5 + 0.3, a flat row."""
    probs = np.log(np.array([0.5, 0.3, 0.1, 0.05, 0.05], np.float32))
    ties = np.array([3.0, 1.0, 2.0, 2.0, 2.0], np.float32)
    flat = np.zeros(5, np.float32)
    rnd = np.random.RandomState(0).randn(5).astype(np.float32)
    return np.stack([probs, ties, flat, rnd])


@pytest.mark.parametrize("top_k", [0, 1, 2, 3, 5, 9])
def test_filter_top_k_is_bit_exact(top_k):
    x = _rows()
    if top_k == 0:          # 0 disables the filter in _warp_logits
        _same(t_gen._warp_logits(torch.from_numpy(x), 1.0, 0, 0.0),
              _j()._warp_logits(x, 1.0, 0, 0.0))
        return
    got = t_gen._filter_top_k(torch.from_numpy(x), top_k)
    _same(got, _j()._filter_top_k(x, top_k))
    if top_k == 2:          # the ties at the threshold all survive
        assert np.isfinite(got[1].numpy()).sum() == 4


@pytest.mark.parametrize("top_p", [1e-9, 0.5, 0.8, 0.8 + 1e-4, 0.95, 1.0])
def test_filter_top_p_is_bit_exact(top_p):
    x = _rows()
    got = t_gen._filter_top_p(torch.from_numpy(x), top_p)
    _same(got, _j()._filter_top_p(x, top_p))
    kept = np.isfinite(got[0].numpy()).sum()
    # 0.5 + 0.3 meets 0.8 exactly: two tokens, no third leaks in; at 0.95
    # the fourth token's twin (0.05 both) survives with it
    assert kept == {1e-9: 1, 0.5: 1, 0.8: 2, 0.8 + 1e-4: 3, 0.95: 5, 1.0: 5}[top_p]


def test_warp_logits_per_slot_is_bit_exact():
    rng = np.random.RandomState(1)
    x = np.concatenate([_rows(), rng.randn(6, 5).astype(np.float32) * 3])
    temp = np.array([1.0, 0.7, 0.0, 1.3, 0.9, 0.5, 1.0, 2.0, 0.0, 1.0], np.float32)
    top_k = np.array([0, 2, 3, 9, 1, 4, 5, 0, 2, -1], np.int32)
    top_p = np.array([0.8, 0.0, 0.5, 1.0, 0.9, 1e-9, 0.3, 0.99, 0.0, 0.8], np.float32)
    got = t_gen.warp_logits_per_slot(torch.from_numpy(x), torch.from_numpy(temp),
                                     torch.from_numpy(top_k), torch.from_numpy(top_p))
    _same(got, _j().warp_logits_per_slot(x, temp, top_k, top_p))


def test_sample_per_slot_greedy_rows_and_per_row_streams():
    """Greedy rows are the raw argmax; a sampled row's draw depends on its
    (seed, fold) and logits alone: the same row in another batch, at
    another index, gives the same token; another fold or seed redraws."""
    rng = np.random.RandomState(2)
    logits = torch.from_numpy(rng.randn(6, 200).astype(np.float32))
    temp = torch.tensor([0.0, 0.8, 0.8, 0.0, 1.0, 0.8])
    top_k = torch.tensor([0, 20, 0, 5, 0, 20])
    top_p = torch.tensor([0.0, 0.9, 0.0, 0.9, 0.95, 0.9])
    seeds = torch.tensor([1, 2, 3, 4, 5, 2])
    folds = torch.tensor([0, 7, 7, 3, 9, 8])
    got = t_gen.sample_per_slot(logits, temp, top_k, top_p, seeds, folds)
    assert got.dtype == torch.int32
    greedy = temp == 0
    assert torch.equal(got[greedy].long(), logits[greedy].argmax(-1))
    perm = torch.tensor([5, 3, 1, 0, 4, 2])
    again = t_gen.sample_per_slot(logits[perm], temp[perm], top_k[perm], top_p[perm],
                                  seeds[perm], folds[perm])
    assert torch.equal(again, got[perm])
    draws = {int(t_gen.sample_per_slot(logits[1:2], temp[1:2], top_k[1:2], top_p[1:2],
                                       seeds[1:2] + s, folds[1:2] + f)[0])
             for s in range(4) for f in range(4)}
    assert len(draws) > 1
    noise = t_gen._slot_gumbel(torch.tensor([7]), torch.tensor([3]), 100_000)
    # the counter-based draw is a standard Gumbel
    assert abs(float(noise.mean()) - 0.5772) < 0.02 and abs(float(noise.var()) - 1.645) < 0.05


# -- sampled decoding on shared noise -------------------------------------------------

@pytest.mark.parametrize("knobs", [dict(temperature=0.8), dict(temperature=1.0, top_k=5),
                                   dict(temperature=0.7, top_p=0.9, top_k=20)],
                         ids=["temperature", "top_k", "top_k_top_p"])
@pytest.mark.parametrize("left_pad", [False, True])
def test_sampled_generate_causal_matches_jax_on_shared_noise(monkeypatch, knobs, left_pad):
    import jax.numpy as jnp

    jmodel, params, model = gpt2_pair(seed=3)
    rng = np.random.RandomState(4)
    ids = rng.randint(3, 128, (3, 7)).astype(np.int32)
    mask = np.ones_like(ids)
    if left_pad:
        mask[1, :3] = 0
    T = 10
    want = np.asarray(_j().generate_causal(jmodel, params, jnp.asarray(ids), jnp.asarray(mask),
                                           max_new_tokens=T, seed=11, **knobs))
    left = feed_noise(monkeypatch, t_gen, jax_gumbel_stream(11, (3, 128), T))
    got = t_gen.generate_causal(model, ids, mask, max_new_tokens=T, seed=11, **knobs)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and len(left) <= T - 1


def test_sampled_generate_causal_is_seeded():
    _, _, model = gpt2_pair(seed=3)
    ids = np.random.RandomState(5).randint(3, 128, (2, 6))
    kw = dict(max_new_tokens=12, temperature=0.9, top_p=0.95)
    a = t_gen.generate_causal(model, ids, seed=1, **kw)
    assert torch.equal(a, t_gen.generate_causal(model, ids, seed=1, **kw))
    assert not torch.equal(a, t_gen.generate_causal(model, ids, seed=2, **kw))


@pytest.mark.parametrize("variant", ["t5", "bart", "mbart"])
def test_sampled_seq2seq_generate_matches_jax_on_shared_noise(monkeypatch, variant):
    import jax.numpy as jnp

    jmodel, params, model = seq2seq_pair(variant, seed=1)
    rng = np.random.RandomState(6)
    src = rng.randint(3, 96, (3, 9)).astype(np.int32)
    mask = np.ones_like(src)
    mask[2, 6:] = 0
    T, knobs = 8, dict(temperature=0.9, top_k=30, top_p=0.95)
    want = np.asarray(_j().generate(jmodel, params, jnp.asarray(src), jnp.asarray(mask),
                                    max_new_tokens=T, seed=5, **knobs))
    feed_noise(monkeypatch, t_gen, jax_gumbel_stream(5, (3, 96), T))
    got = t_gen.generate(model, src, mask, max_new_tokens=T, seed=5, **knobs)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tuple(got.shape) == (3, T) and got.dtype == torch.int32
    if variant == "mbart":
        assert (got[:, 0] == 7).all()


# -- chunked prefill ---------------------------------------------------------------

@pytest.mark.parametrize("chunk", [4, 8, 10])
def test_chunked_prefill_matches_single_pass(chunk):
    """chunk 10 does not divide the 12-token prompt: the prompt is padded
    to a multiple and the padded slots stay masked."""
    import jax.numpy as jnp

    jmodel, params, model = gpt2_pair(seed=0)
    ids = np.random.RandomState(0).randint(3, 128, (2, 12))
    want = t_gen.generate_causal(model, ids, max_new_tokens=10)
    got = t_gen.generate_causal(model, ids, max_new_tokens=10, prefill_chunk=chunk)
    assert torch.equal(got, want)
    jax_got = _j().generate_causal(jmodel, params, jnp.asarray(ids), max_new_tokens=10,
                                   prefill_chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_got))


@pytest.mark.parametrize("side", ["left", "right"])
def test_chunked_prefill_padded_prompts(side):
    _, _, model = gpt2_pair(seed=1)
    real = np.random.RandomState(1).randint(3, 128, (2, 7))
    ids = np.zeros((2, 12), np.int64)
    mask = np.zeros((2, 12), np.int64)
    cols = slice(5, None) if side == "left" else slice(0, 7)
    ids[:, cols], mask[:, cols] = real, 1
    want = t_gen.generate_causal(model, ids, mask, max_new_tokens=8)
    got = t_gen.generate_causal(model, ids, mask, max_new_tokens=8, prefill_chunk=8)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="prefill_chunk"):
        t_gen.generate_causal(model, ids, mask, max_new_tokens=2, prefill_chunk=-1)


# -- beam search -----------------------------------------------------------------

BEAMS = [(1, 1.0), (2, 0.6), (2, 2.0), (4, 0.6), (4, 1.0), (4, 2.0)]


@pytest.mark.parametrize("num_beams,length_penalty", BEAMS,
                         ids=[f"k{k}-lp{lp}" for k, lp in BEAMS])
def test_beam_search_causal_matches_jax(num_beams, length_penalty):
    """Tokens exact and scores within 1e-5, with EOS set to a token the
    search emits so hypotheses bank mid-search and rows pad."""
    import jax.numpy as jnp

    jmodel, params, model = gpt2_pair(seed=2, vocab=96)
    rng = np.random.RandomState(num_beams)
    ids = rng.randint(3, 96, (3, 6)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[2, :2] = 0
    kw = dict(num_beams=num_beams, max_new_tokens=8, length_penalty=length_penalty,
              return_scores=True)
    jm, model = with_eos(jmodel, model, -1)
    free, _ = t_gen.beam_search_causal(model, ids, mask, **kw)
    jm, model = with_eos(jmodel, model, int(free[0, 2]))
    want, want_s = _j().beam_search_causal(jm, params, jnp.asarray(ids), jnp.asarray(mask),
                                           **kw)
    got, got_s = t_gen.beam_search_causal(model, ids, mask, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=1e-5)
    assert got.dtype == torch.int32


def test_beam_search_causal_banks_eos_mid_search():
    """A prompt whose winning hypothesis ends in EOS before the last step
    (pads after it), token-exact against JAX."""
    import jax.numpy as jnp

    jmodel, params, model = gpt2_pair(seed=4, vocab=96)
    kw = dict(num_beams=4, max_new_tokens=8, length_penalty=0.6)
    for s in range(40):
        ids = np.random.RandomState(100 + s).randint(3, 96, (1, 6)).astype(np.int32)
        jm, model = with_eos(jmodel, model, -1)
        eos = int(t_gen.beam_search_causal(model, ids, **kw)[0, 2])
        jm, model = with_eos(jmodel, model, eos)
        got = t_gen.beam_search_causal(model, ids, **kw)
        row = got[0].tolist()
        if eos in row[:-1]:
            break
    else:
        pytest.fail("no EOS-banking prompt among 40 seeds")
    want = _j().beam_search_causal(jm, params, jnp.asarray(ids), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    stop = row.index(eos)
    assert all(t == model.config.pad_token_id for t in row[stop + 1:])


def test_beam1_matches_greedy():
    _, _, model = gpt2_pair(seed=5)
    ids = np.random.RandomState(3).randint(3, 128, (2, 7))
    want = t_gen.generate_causal(model, ids, max_new_tokens=9)
    assert torch.equal(t_gen.beam_search_causal(model, ids, num_beams=1, max_new_tokens=9),
                       want)


def test_beam_composes_with_int8_kv():
    """The per-step cache gather carries the int8 scale buffers: beam
    search over the int8 cache equals JAX's over its int8 cache, and the
    fp cache's on the tiny model."""
    import dataclasses

    import jax.numpy as jnp

    jmodel, params, model = gpt2_pair(seed=6, vocab=96)
    jq = jmodel.clone(config=dataclasses.replace(jmodel.config, kv_cache_dtype="int8"))
    from torch_decode_pairs import port_of

    model_q = port_of(jq, params)
    ids = np.random.RandomState(9).randint(3, 96, (2, 5)).astype(np.int32)
    got = t_gen.beam_search_causal(model_q, ids, num_beams=3, max_new_tokens=6)
    want = _j().beam_search_causal(jq, params, jnp.asarray(ids), num_beams=3, max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, t_gen.beam_search_causal(model, ids, num_beams=3,
                                                     max_new_tokens=6))


SEQ_BEAMS = [(v, k, lp) for v in ("t5", "bart", "mbart") for k, lp in ((2, 1.0), (4, 0.6))] + [
    ("t5", 4, 2.0), ("bart", 1, 1.0)]


@pytest.mark.parametrize("variant,num_beams,length_penalty", SEQ_BEAMS,
                         ids=[f"{v}-k{k}-lp{lp}" for v, k, lp in SEQ_BEAMS])
def test_beam_search_generate_matches_jax(variant, num_beams, length_penalty):
    import jax.numpy as jnp

    jmodel, params, model = seq2seq_pair(variant, seed=2)
    rng = np.random.RandomState(7)
    src = rng.randint(3, 96, (2, 8)).astype(np.int32)
    mask = np.ones_like(src)
    mask[1, 6:] = 0
    kw = dict(num_beams=num_beams, max_new_tokens=7, length_penalty=length_penalty,
              return_scores=True)
    jm, model = with_eos(jmodel, model, -1)
    free, _ = t_gen.beam_search_generate(model, src, mask, **kw)
    jm, model = with_eos(jmodel, model, int(free[0, 2]))
    want, want_s = _j().beam_search_generate(jm, params, jnp.asarray(src), jnp.asarray(mask),
                                             **kw)
    got, got_s = t_gen.beam_search_generate(model, src, mask, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=1e-5)
    if variant == "mbart":
        assert (got[:, 0] == 7).all()


def test_beam_search_causal_on_experts_raises_the_jax_value_error():
    """The JAX package's refusal, word for word."""
    import jax.numpy as jnp
    from types import SimpleNamespace

    from torch_decode_pairs import llama_pair

    jm, jp, _ = llama_pair(num_experts=2, num_layers=1)
    with pytest.raises(ValueError) as want:
        _j().beam_search_causal(jm, jp, jnp.ones((1, 4), jnp.int32))
    with pytest.raises(ValueError) as got:
        t_gen.beam_search_causal(SimpleNamespace(config=SimpleNamespace(num_experts=2)),
                                 np.ones((1, 4), np.int64))
    assert str(got.value) == str(want.value)


# -- telemetry -------------------------------------------------------------------

def test_decode_telemetry_validates_under_the_jax_schema(tmp_path):
    """With a sink set, the decoders emit their spans and scalars and the
    events file passes the JAX validator; without one, nothing."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import schema as j_schema

    _, _, model = gpt2_pair(seed=0)
    _, _, s2s = seq2seq_pair("t5", seed=0)
    ids = np.random.RandomState(0).randint(3, 96, (2, 6))
    t_obs.reset(str(tmp_path))
    try:
        t_gen.generate_causal(model, ids, max_new_tokens=4, prefill_chunk=4)
        t_gen.generate(s2s, ids, max_new_tokens=3)
        t_gen.beam_search_causal(model, ids, num_beams=2, max_new_tokens=3)
        t_obs.flush()
    finally:
        t_obs.reset(enabled=False)
    n, errors = j_schema.validate_events_file(str(tmp_path / "events.jsonl"))
    assert n > 0 and errors == []
    names = {json.loads(line).get("name") for line in open(tmp_path / "events.jsonl")}
    assert {"generate/causal_ttft_s", "generate/causal_decode_tokens_per_sec",
            "generate/causal/tokens_per_sec", "generate/seq2seq/tokens_per_sec",
            "generate/beam_causal/tokens_per_sec"} <= names
    trace = json.load(open(tmp_path / "trace.json"))
    spans = {e["name"] for e in trace["traceEvents"]}
    assert {"generate/causal_prefill", "generate/causal_decode",
            "generate/seq2seq_dispatch", "generate/beam_causal_dispatch"} <= spans
