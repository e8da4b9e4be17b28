"""Decoding against a dense KV cache: the counterpart of the JAX
package's ``models/generate.py``.

- :func:`generate_causal` (GPT-2, the Llama family): greedy, or temperature / top-k /
  top-p sampling, with an optional chunked prefill; the plain reference
  decode the serving engine's tests compare tokens with. It never touches
  the paged kernel.
- :func:`generate` (T5, BART, mBART): the encoder once, then the decoder a
  token a step from a ``[B, H, max_new_tokens, D]`` dense cache
  (cross-attention recomputes K/V from the encoder output each step, as
  the JAX package's does); greedy or sampled.
- :func:`beam_search_causal` and :func:`beam_search_generate`: HF
  ``BeamSearchScorer`` beam search, beams flattened into the batch.
- :func:`generate_speculative` (a draft model, or :func:`self_draft`'s
  first layers of the target) and :func:`generate_speculative_seq2seq`
  (T5): a draft proposes ``speculate_k`` tokens, the target verifies them
  in one pass; greedy-exact at temperature 0, the target's warped
  distribution exactly (Leviathan rejection) above it.
- :func:`sample_per_slot`: the serving engine's per-row draw, whose
  noise is a pure function of (request seed, token index).

A causal model cut for tensor-parallel serving
(``parallel/sharding.py:shard_for_serving``) runs every function here as it
is, on every rank with the same arguments: each rank's caches hold its
heads, the row-parallel layers sum over ``tensor``, and the replicated head
gives every rank the same logits, so the ranks make the same choices.

Every draw is Gumbel-max, ``argmax(warped + gumbel)`` — what
``jax.random.categorical`` computes — through :func:`_categorical`, with
the noise made apart (:func:`_gumbel` from a ``torch.Generator`` seeded
with ``seed``), so a test can hand both packages the same noise. Random
streams do not match across the two frameworks; the noise tensor does.

The filters' numeric conventions are the JAX package's: top-k of 0 or at
least the vocabulary keeps everything and its threshold is a value (ties
at it all survive); ``top_p >= 1`` is no filter, the nucleus test is the
strict ``cum_before < top_p - 1e-6`` and the argmax always stays. Beam
search's sentinel is ``-1e9`` (not ``-inf``) and its top-k is a stable
descending sort, so equal scores keep ``lax.top_k``'s lowest-index-first
order. Telemetry (spans ``generate/causal_prefill``,
``generate/causal_decode``, ``generate/seq2seq_dispatch``,
``generate/beam_*``; scalars ``generate/causal_ttft_s``,
``generate/causal_decode_tokens_per_sec``, ``generate/*/tokens_per_sec``)
is emitted only when an ``obs`` sink is set, and only then does a call
wait for the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.kv_cache import (
    DenseCache,
)

_NEG = -1e9          # beam search's dead-beam / empty-pool score
_M32 = 0xFFFFFFFF


# -- draws ---------------------------------------------------------------------

def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(u))`` with ``u`` uniform on
    ``[tiny, 1)`` (``jax.random.gumbel``'s formula), fp32."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def _categorical(warped: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """One draw per row from ``softmax(warped)``: the Gumbel-max argmax
    (``jax.random.categorical``). ``-inf`` entries are never drawn."""
    return (noise + warped).argmax(-1)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for ``h`` in [0, 2**32) without a 64-bit
    overflow (two 16-bit halves of ``c``)."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 tensors holding [0, 2**32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _slot_gumbel(seeds: torch.Tensor, folds: torch.Tensor, vocab: int) -> torch.Tensor:
    """``[rows, vocab]`` Gumbel noise that is a pure function of (row's
    seed, row's fold, vocab index): a counter-based draw, an integer hash
    of the three in tensor ops, so a row's noise does not depend on the
    batch it shares or on any generator's state (the role of JAX's
    ``fold_in(PRNGKey(seed), fold)``)."""
    idx = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    h = _mix32((seeds.long() & _M32) ^ 0x9E3779B9)
    h = _mix32(h ^ (folds.long() & _M32))[:, None]
    h = _mix32((h + _mul32(idx[None, :], 0x9E3779B1)) & _M32)
    u = (h.double() + 0.5) / 2.0 ** 32
    return (-torch.log(-torch.log(u))).float()


# -- warping -------------------------------------------------------------------

def _filter_top_k(logits, top_k: int):
    """Keep the ``top_k`` highest logits, the rest to -inf (a ``top_k`` of
    at least the vocabulary keeps everything, HF ``TopKLogitsWarper``)."""
    kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values[..., -1:]
    return torch.where(logits < kth, -torch.inf, logits)


def _filter_top_p(logits, top_p: float):
    """Nucleus filtering: keep the smallest prefix of the sorted
    distribution whose mass reaches ``top_p`` (the first token past the
    threshold kept, HF semantics); ``top_p >= 1`` is no filter."""
    if top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    # strict < with a tolerance: fp32 cumsum rounds exact-boundary sums
    # (0.5 + 0.3 -> 0.79999995), which would leak one extra token
    keep = cum_before < top_p - 1e-6
    keep[..., 0] = True                         # the argmax always stays
    kth = torch.where(keep, sorted_logits, torch.inf).amin(-1, keepdim=True)
    return torch.where(logits < kth, -torch.inf, logits)


def _warp_logits(logits, temperature: float, top_k: int, top_p: float):
    """Temperature, then top-k, then top-p: the one warping shared by
    plain and speculative sampling. Needs ``temperature > 0``."""
    logits = logits / temperature
    if top_k:
        logits = _filter_top_k(logits, top_k)
    if top_p:
        logits = _filter_top_p(logits, top_p)
    return logits


def _sample_next(logits, temperature: float, top_k: int, top_p: float,
                 generator: Optional[torch.Generator]):
    """One decision per row of ``[B, V]`` fp32 logits: the argmax at
    temperature 0, else a draw from the warped distribution."""
    if temperature == 0.0:
        return logits.argmax(-1)
    warped = _warp_logits(logits, temperature, top_k, top_p)
    return _categorical(warped, _gumbel(warped.shape, generator, warped.device))


def warp_logits_per_slot(logits, temperature, top_k, top_p):
    """Per-row warping for a batch whose rows carry their own sampling
    knobs (``[rows]`` tensors): the same temperature -> top-k -> top-p
    sequence and numeric conventions as :func:`_warp_logits`. Rows with
    ``temperature == 0`` pass unwarped (their pick is the raw argmax)."""
    V = logits.shape[-1]
    t = torch.where(temperature > 0, temperature, 1.0)[:, None]
    scaled = logits / t
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = top_k.long().clamp(0, V)
    kth = sorted_desc.gather(-1, (k - 1).clamp(min=0)[:, None])
    k_on = ((k > 0) & (k < V))[:, None]
    filtered = torch.where(k_on & (scaled < kth), -torch.inf, scaled)
    sorted_f = torch.sort(filtered, dim=-1, descending=True).values
    probs = torch.softmax(sorted_f, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    keep = cum_before < top_p[:, None] - 1e-6
    keep[..., 0] = True
    pth = torch.where(keep, sorted_f, torch.inf).amin(-1, keepdim=True)
    p_on = ((top_p > 0.0) & (top_p < 1.0))[:, None]
    return torch.where(p_on & (filtered < pth), -torch.inf, filtered)


def sample_per_slot(logits, temperature, top_k, top_p, seeds, folds):
    """One per-row step for mixed greedy and sampled rows (the serving
    engine's decode and final-prefill picks). ``logits`` ``[rows, V]``
    fp32; ``temperature``, ``top_k``, ``top_p`` ``[rows]``; ``seeds`` the
    requests' seeds and ``folds`` the request-global index of the token
    drawn, ``[rows]`` each. A sampled row's draw depends on (seed, fold)
    and its logits only, so recompute preemption re-derives the same
    token. Greedy rows (``temperature == 0``) return the raw argmax.
    Returns ``[rows]`` int32."""
    greedy = logits.argmax(-1)
    warped = warp_logits_per_slot(logits, temperature, top_k, top_p)
    sampled = _categorical(warped, _slot_gumbel(seeds, folds, logits.shape[-1]))
    return torch.where(temperature > 0, sampled, greedy).to(torch.int32)


# -- helpers -------------------------------------------------------------------

def model_device(model) -> torch.device:
    """The device a model's weights live on (any family)."""
    return next(model.parameters()).device


def _refuse_experts(*models, what: str, why: str) -> None:
    """The JAX package's refusal of MoE models where expert capacity,
    a function of the call's sequence length, would break a decoder's
    token-exactness."""
    if any(getattr(m.config, "num_experts", 0) for m in models):
        raise ValueError(f"{what} does not support MoE models (Mixtral): {why}")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _traced_decode(phase: str, t0: float, out: torch.Tensor) -> torch.Tensor:
    """On instrumented runs (a sink set): wait for ``out`` [B, T] and emit
    ``<phase>/tokens_per_sec``; otherwise return at once."""
    if obs.has_sink():
        with obs.span(f"{phase}/wait"):
            _sync(out.device)
        dt = max(time.perf_counter() - t0, 1e-9)
        obs.scalar(f"{phase}/tokens_per_sec", out.shape[0] * out.shape[1] / dt,
                   args={"batch": int(out.shape[0]), "new_tokens": int(out.shape[1])})
    return out


def _inputs(model_device, input_ids, attention_mask):
    input_ids = torch.as_tensor(input_ids, device=model_device).long()
    if input_ids.ndim == 1:
        input_ids = input_ids[None]
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    return input_ids, torch.as_tensor(attention_mask, device=model_device).long()


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _map_cache(cache: DenseCache, fn) -> DenseCache:
    """``fn`` over every buffer of every layer (scales included) and the
    per-row write index."""
    def each(bufs):
        return None if bufs is None else [fn(b) for b in bufs]

    return DenseCache(each(cache.keys), each(cache.values), each(cache.key_scales),
                      each(cache.value_scales), fn(cache.index))


def _row_put(buf: torch.Tensor, upd: torch.Tensor, start: torch.Tensor) -> None:
    """``buf[b, start[b]:start[b] + w] = upd[b]`` in place, the start
    clamped so the window fits (``lax.dynamic_update_slice``)."""
    w = upd.shape[1]
    start = start.clamp(0, buf.shape[1] - w)
    cols = start[:, None] + torch.arange(w, device=buf.device)[None, :]
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    buf[rows, cols] = upd.to(buf.dtype)


def _force_token(logits, token_id: int):
    """A point mass on ``token_id`` (HF ``forced_bos_token_id``)."""
    forced = torch.full_like(logits, -torch.inf)
    forced[..., token_id] = 0.0
    return forced


# -- causal generation -----------------------------------------------------------

@torch.inference_mode()
def generate_causal(model, input_ids, attention_mask=None,
                    max_new_tokens: int = 64, temperature: float = 0.0,
                    top_k: int = 0, top_p: float = 0.0, seed: int = 0,
                    prefill_chunk: int = 0, output_scores: bool = False):
    """Continuation of ``input_ids`` [B, P] (padding, left or right, marked
    0 in ``attention_mask``): greedy at ``temperature=0``, else sampled
    after temperature, ``top_k`` and ``top_p`` (0 disables each) from a
    generator seeded with ``seed``. One prefill writes the prompt into a
    ``P + max_new_tokens`` cache (``prefill_chunk > 0``: in chunks of that
    many tokens, the prompt right-padded to a chunk multiple; the same
    tokens out), then one token per step. Returns [B, max_new_tokens]
    int32 ids, ``pad_token_id`` after EOS; with ``output_scores`` also the
    fp32 logits each token was picked from, [B, max_new_tokens, vocab]
    (zeros once every row finished)."""
    t0 = time.perf_counter()
    cfg = model.config
    dev = model_device(model)
    input_ids, attention_mask = _inputs(dev, input_ids, attention_mask)
    prefill_chunk = int(prefill_chunk)
    if prefill_chunk < 0:
        raise ValueError(f"prefill_chunk must be >= 0, got {prefill_chunk}")
    if prefill_chunk:
        _refuse_experts(
            model, what="prefill_chunk",
            why="expert capacity is a function of the apply's sequence length, so "
                "chunked prefill could capacity-drop token->expert assignments the "
                "single-pass prefill never drops — the token-identical guarantee "
                "would silently break")
    if prefill_chunk >= input_ids.shape[1]:
        prefill_chunk = 0           # one chunk would only pad: the single pass
    if prefill_chunk:
        short = -input_ids.shape[1] % prefill_chunk
        if short:
            # masked everywhere and never read back, but in-vocab: an
            # out-of-range pad id would not embed
            pad_id = min(int(cfg.pad_token_id), cfg.vocab_size - 1)
            input_ids = F.pad(input_ids, (0, short), value=pad_id)
            attention_mask = F.pad(attention_mask, (0, short))
    B, P = input_ids.shape
    gen = _generator(seed, dev) if temperature > 0 else None
    sink = obs.has_sink()
    with obs.span("generate/causal_prefill",
                  {"prompt_len": P, "prefill_chunk": prefill_chunk} if sink else None):
        cache = model.new_dense_cache(B, P + max_new_tokens)
        valid = torch.cat([attention_mask, torch.zeros(B, max_new_tokens, dtype=torch.long,
                                                       device=dev)], dim=1)
        n_real = attention_mask.sum(1)
        pos = (attention_mask.cumsum(1) - 1).clamp(min=0)
        last_real = P - 1 - attention_mask.flip(1).argmax(1)
        rows = torch.arange(B, device=dev)
        if prefill_chunk:
            C = prefill_chunk
            last = torch.zeros(B, cfg.vocab_size, device=dev)
            for start in range(0, P, C):
                lg = model(input_ids[:, start:start + C], valid, pos[:, start:start + C], cache)
                rel = last_real - start
                hit = (rel >= 0) & (rel < C)
                sel = lg[rows, rel.clamp(0, C - 1)].float()
                last = torch.where(hit[:, None], sel, last)
        else:
            last = model(input_ids, valid, pos, cache)[rows, last_real].float()
        token = _sample_next(last, temperature, top_k, top_p, gen)
        if sink:
            _sync(dev)
            obs.scalar("generate/causal_ttft_s", time.perf_counter() - t0,
                       args={"prompt_len": P, "batch": B})
    t_dec = time.perf_counter()
    with obs.span("generate/causal_decode"):
        finished = token == cfg.eos_token_id
        out = torch.full((B, max_new_tokens), cfg.pad_token_id, dtype=torch.int32,
                         device=dev)
        out[:, 0] = token
        scores = (torch.zeros(B, max_new_tokens, cfg.vocab_size, device=dev)
                  if output_scores else None)
        if output_scores:
            scores[:, 0] = last
        for t in range(max_new_tokens - 1):
            if bool(finished.all()):
                break                # every later token is the pad id
            valid[:, P + t] = 1
            last = model(token[:, None], valid, (n_real + t)[:, None], cache)[:, -1].float()
            nxt = _sample_next(last, temperature, top_k, top_p, gen)
            nxt = torch.where(finished, cfg.pad_token_id, nxt)
            finished = finished | (nxt == cfg.eos_token_id)
            out[:, t + 1] = nxt
            if output_scores:
                scores[:, t + 1] = last
            token = nxt
        if sink:
            _sync(dev)
            obs.scalar("generate/causal_decode_tokens_per_sec",
                       B * max_new_tokens / max(time.perf_counter() - t_dec, 1e-9))
    _traced_decode("generate/causal", t0, out)
    return (out, scores) if output_scores else out


# -- encoder-decoder generation ----------------------------------------------------

@torch.inference_mode()
def generate(model, input_ids, attention_mask=None, max_new_tokens: int = 64,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             seed: int = 0):
    """Output ids of an encoder-decoder ``model`` (T5, BART) for source
    ids ``input_ids`` [B, S] (padding marked 0 in ``attention_mask``):
    greedy at ``temperature=0``, else sampled (temperature, ``top_k``,
    ``top_p``; 0 disables each) from a generator seeded with ``seed``.
    [B, max_new_tokens] int32, ``pad_token_id`` after each row's EOS. The
    first step starts from ``decoder_start_token_id``; a config's
    ``forced_bos_token_id`` (mBART's target language) is the first
    token."""
    t0 = time.perf_counter()
    cfg = model.config
    dev = model.shared.weight.device
    input_ids, attention_mask = _inputs(dev, input_ids, attention_mask)
    B = input_ids.shape[0]
    gen = _generator(seed, dev) if temperature > 0 else None
    forced = getattr(cfg, "forced_bos_token_id", None)
    with obs.span("generate/seq2seq_dispatch"):
        encoder_hidden = model.encode(input_ids, attention_mask)
        cache = model.new_dense_cache(B, max_new_tokens)
        token = torch.full((B, 1), cfg.decoder_start_token_id, dtype=torch.long, device=dev)
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
        out = torch.full((B, max_new_tokens), cfg.pad_token_id, dtype=torch.int32,
                         device=dev)
        for t in range(max_new_tokens):
            if bool(finished.all()):
                break                # every later token is the pad id
            logits = model.decode(token, encoder_hidden, attention_mask,
                                  cache=cache)[:, -1].float()
            if t == 0 and forced is not None:
                logits = _force_token(logits, forced)
            nxt = _sample_next(logits, temperature, top_k, top_p, gen)
            nxt = torch.where(finished, cfg.pad_token_id, nxt)
            finished = finished | (nxt == cfg.eos_token_id)
            out[:, t] = nxt
            token = nxt[:, None]
    return _traced_decode("generate/seq2seq", t0, out)


# -- beam search -------------------------------------------------------------------

def _top_k_stable(x, k: int):
    """``lax.top_k`` over the last axis: the ``k`` largest, equal values
    lowest index first."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _pool_merge(K: int, fin_scores, fin_tok, cand_scores, cand_tok):
    """The best ``K`` of (finished pool) + (candidates): the one
    finished-hypothesis merge both beam searches share."""
    all_scores = torch.cat([fin_scores, cand_scores], dim=1)
    all_tok = torch.cat([fin_tok, cand_tok], dim=1)
    new_scores, idx = _top_k_stable(all_scores, K)
    return new_scores, all_tok.gather(1, idx[:, :, None].expand(-1, -1, all_tok.shape[2]))


class _Beams:
    """The beam state of ``B`` rows of ``K`` beams over ``T`` tokens:
    live and finished (length-penalized) pools, each row's HF ``is_done``."""

    def __init__(self, B: int, K: int, T: int, V: int, pad: int, eos: int,
                 length_penalty: float, device):
        self.B, self.K, self.T, self.V, self.eos = B, K, T, V, eos
        self.lp = torch.tensor(length_penalty, dtype=torch.float32)
        # beam 0 starts live, 1..K-1 at the sentinel: step 0 fans out from
        # one root instead of K identical copies
        self.live_scores = torch.full((B, K), _NEG, device=device)
        self.live_scores[:, 0] = 0.0
        self.live_tok = torch.full((B, K, T), pad, dtype=torch.int32, device=device)
        self.fin_scores = torch.full((B, K), _NEG, device=device)
        self.fin_tok = torch.full((B, K, T), pad, dtype=torch.int32, device=device)
        self.done = torch.zeros(B, dtype=torch.bool, device=device)

    def _penalty(self, length: int) -> float:
        return float(torch.tensor(float(length), dtype=torch.float32) ** self.lp)

    def select(self, t: int, logp: torch.Tensor):
        """One round of HF candidate selection and banking at emitted-token
        index ``t`` (hypothesis length ``t + 1``) from ``logp`` [B, K, V].
        Returns the tokens the live beams emit ``[B*K]`` and the parent
        row each live beam continues ``[B*K]``."""
        B, K, V = self.B, self.K, self.V
        cand = self.live_scores[:, :, None] + logp
        top2k, flat = _top_k_stable(cand.reshape(B, K * V), 2 * K)
        parent = flat // V
        tok2k = (flat % V).to(torch.int32)
        is_eos = tok2k == self.eos
        seq2k = self.live_tok.gather(1, parent[:, :, None].expand(-1, -1, self.T)).clone()
        seq2k[:, :, t] = tok2k
        pen = self._penalty(t + 1)
        rank_ok = torch.arange(2 * K, device=logp.device)[None, :] < K
        eos_norm = torch.where(is_eos & rank_ok & ~self.done[:, None], top2k / pen,
                               torch.full_like(top2k, _NEG))
        self.fin_scores, self.fin_tok = _pool_merge(K, self.fin_scores, self.fin_tok,
                                                    eos_norm, seq2k)
        live_cand = torch.where(is_eos, torch.full_like(top2k, _NEG), top2k)
        self.live_scores, keep = _top_k_stable(live_cand, K)
        emit = tok2k.gather(1, keep)
        self.live_tok = seq2k.gather(1, keep[:, :, None].expand(-1, -1, self.T))
        parent_k = parent.gather(1, keep)
        rows = (torch.arange(B, device=logp.device)[:, None] * K + parent_k).reshape(-1)
        attainable = top2k[:, 0] / pen
        self.done = self.done | (self.fin_scores.amin(1) >= attainable)
        return emit.reshape(-1), rows

    def finalize(self):
        """HF ``finalize``: rows not done bank their live beams at length
        ``T``; the best pooled hypothesis of each row wins. Returns (ids
        [B, T] int32, scores [B])."""
        live_norm = torch.where(self.done[:, None], torch.full_like(self.live_scores, _NEG),
                                self.live_scores / self._penalty(self.T))
        fin_scores, fin_tok = _pool_merge(self.K, self.fin_scores, self.fin_tok,
                                          live_norm, self.live_tok)
        best = fin_scores.argmax(1)
        rows = torch.arange(self.B, device=best.device)
        return fin_tok[rows, best], fin_scores[rows, best]


@torch.inference_mode()
def beam_search_causal(model, input_ids, attention_mask=None, num_beams: int = 4,
                       max_new_tokens: int = 64, length_penalty: float = 1.0,
                       return_scores: bool = False):
    """Beam search for GPT-2 (HF ``BeamSearchScorer`` semantics, the JAX
    ``beam_search_causal``): the first candidates come from the prefill's
    last-real-token logits; the prefill runs once per input row at [B]
    and its cache is repeated across the beams; every step one decoder
    call over [B*K] rows, then the top 2K of the K x V grid, EOS
    candidates ranked within the top K banked with their length penalty
    (generated length), the best K others continuing, the cache (every
    layer's K/V, int8 scales, the per-row index) gathered by parent.
    Returns [B, max_new_tokens] int32 ids (pad after EOS); with
    ``return_scores`` also the winners' length-penalized scores."""
    _refuse_experts(
        model, what="beam_search_causal",
        why="expert capacity depends on the apply's sequence length, so beam "
            "prefill vs single-token steps could route differently")
    t0 = time.perf_counter()
    cfg = model.config
    dev = model_device(model)
    input_ids, attention_mask = _inputs(dev, input_ids, attention_mask)
    B, P = input_ids.shape
    K, V, T = int(num_beams), cfg.vocab_size, int(max_new_tokens)
    with obs.span("generate/beam_causal_dispatch"):
        cache = model.new_dense_cache(B, P + T)
        valid_row = torch.cat([attention_mask, torch.zeros(B, T, dtype=torch.long,
                                                           device=dev)], dim=1)
        pos = (attention_mask.cumsum(1) - 1).clamp(min=0)
        last_real = P - 1 - attention_mask.flip(1).argmax(1)
        logits = model(input_ids, valid_row, pos, cache)
        logp = torch.log_softmax(logits[torch.arange(B, device=dev), last_real].float(), -1)
        logp = logp[:, None, :].expand(B, K, V)
        cache = _map_cache(cache, lambda x: x.repeat_interleave(K, dim=0))
        valid = valid_row.repeat_interleave(K, dim=0)
        n_real = attention_mask.sum(1).repeat_interleave(K)
        beams = _Beams(B, K, T, V, cfg.pad_token_id, cfg.eos_token_id, length_penalty, dev)
        for t in range(T):
            if t:
                # the token emitted at t - 1 writes slot P + t - 1 at
                # logical position n_real + t - 1
                valid[:, P + t - 1] = 1
                logits = model(token[:, None], valid, (n_real + t - 1)[:, None], cache)
                logp = torch.log_softmax(logits[:, -1].float(), -1).reshape(B, K, V)
            token, parents = beams.select(t, logp)
            if bool(beams.done.all()):
                break                # no row banks again: the pools are final
            cache = _map_cache(cache, lambda x: x.index_select(0, parents))
        ids, scores = beams.finalize()
    _traced_decode("generate/beam_causal", t0, ids)
    return (ids, scores) if return_scores else ids


@torch.inference_mode()
def beam_search_generate(model, input_ids, attention_mask=None, num_beams: int = 4,
                         max_new_tokens: int = 64, length_penalty: float = 1.0,
                         return_scores: bool = False):
    """Beam search for T5, BART and mBART (the JAX ``beam_search_generate``):
    the encoder once, its output repeated across the beams, then the
    decoder over [B*K] rows a step, selected and banked as in
    :func:`beam_search_causal` (mBART: the forced BOS on every beam at
    step 0). Returns [B, max_new_tokens] int32 ids (pad after EOS); with
    ``return_scores`` also the winners' length-penalized scores."""
    t0 = time.perf_counter()
    cfg = model.config
    dev = model.shared.weight.device
    input_ids, attention_mask = _inputs(dev, input_ids, attention_mask)
    B = input_ids.shape[0]
    K, V, T = int(num_beams), cfg.vocab_size, int(max_new_tokens)
    forced = getattr(cfg, "forced_bos_token_id", None)
    with obs.span("generate/beam_dispatch"):
        enc = model.encode(input_ids, attention_mask).repeat_interleave(K, dim=0)
        enc_mask = attention_mask.repeat_interleave(K, dim=0)
        cache = model.new_dense_cache(B * K, T)
        token = torch.full((B * K,), cfg.decoder_start_token_id, dtype=torch.long, device=dev)
        beams = _Beams(B, K, T, V, cfg.pad_token_id, cfg.eos_token_id, length_penalty, dev)
        for t in range(T):
            logits = model.decode(token[:, None], enc, enc_mask, cache=cache)[:, -1]
            logp = torch.log_softmax(logits.float(), -1).reshape(B, K, V)
            if t == 0 and forced is not None:
                logp = _force_token(logp, forced)
            token, parents = beams.select(t, logp)
            if bool(beams.done.all()):
                break
            cache = _map_cache(cache, lambda x: x.index_select(0, parents))
        ids, scores = beams.finalize()
    _traced_decode("generate/beam", t0, ids)
    return (ids, scores) if return_scores else ids


# -- speculative decoding ------------------------------------------------------------

def speculative_accept_greedy(t_pred, drafts):
    """Greedy acceptance for a batch of verify windows: ``t_pred`` [B, k+1]
    the target's argmax at every window position, ``drafts`` [B, k] the
    draft's proposals. Returns ``(n_acc, bonus)``: the longest prefix of
    drafts matching the target's choices, and the target's choice at the
    first miss (the k+1-th when all match) — so ``drafts[:n_acc] +
    [bonus]`` is the target's own greedy continuation."""
    B, k = drafts.shape
    match = (drafts == t_pred[:, :k]).to(torch.int32)
    n_acc = torch.cat([match, match.new_zeros(B, 1)], dim=1).argmin(1)
    bonus = t_pred.gather(1, n_acc[:, None])[:, 0]
    return n_acc, bonus


def _speculative_accept(p, q, drafts, u, noise_res, noise_bonus):
    """Speculative sampling's acceptance (Leviathan et al. 2023) for a
    batch of windows, the draws passed in: draft ``d_i ~ q_i`` is kept
    when ``u_i · q_i(d_i) < p_i(d_i)``; at the first rejection the
    replacement is drawn from the residual ``max(p_i - q_i, 0)``
    (``noise_res``), and if every draft survives the bonus from ``p_k``
    (``noise_bonus``). Each emitted token's marginal is the target's
    ``p``. ``p`` [B, k+1, V] and ``q`` [B, k, V] probabilities, ``drafts``
    [B, k], ``u`` [B, k] uniforms, the noises [B, V] Gumbel. Returns
    ``(n_acc, next_token)``."""
    B, k = drafts.shape
    d = drafts.long()[:, :, None]
    p_d = p[:, :k].gather(2, d)[..., 0]
    q_d = q.gather(2, d)[..., 0]
    accept = (u * q_d < p_d).to(torch.int32)
    n_acc = torch.cat([accept, accept.new_zeros(B, 1)], dim=1).argmin(1)
    rows = torch.arange(B, device=p.device)
    res = (p[rows, n_acc] - q[rows, n_acc.clamp(max=k - 1)]).clamp(min=0.0)
    # an all-zero residual means p == q there (never rejected); guard anyway
    res = torch.where(res.sum(-1, keepdim=True) > 0, res, p[rows, n_acc])
    resampled = _categorical(torch.log(res + 1e-30), noise_res)
    bonus = _categorical(torch.log(p[:, k] + 1e-30), noise_bonus)
    return n_acc, torch.where(n_acc == k, bonus, resampled).to(torch.int32)


def _spec_emit(drafts, n_acc, bonus, active, finished, pad: int, eos_id: int):
    """One iteration's emitted window [B, k+1]: the accepted drafts, the
    extra token at ``n_acc``, pads after the first EOS and for inactive
    rows. Returns (emit, n_new, finished)."""
    B, k = drafts.shape
    idx = torch.arange(k + 1, device=drafts.device)[None]
    emit = torch.where(idx < n_acc[:, None], torch.cat([drafts, drafts[:, -1:]], dim=1),
                       torch.full_like(idx, pad))
    emit = torch.where(idx == n_acc[:, None], bonus[:, None].to(emit.dtype), emit)
    n_new = torch.where(active, n_acc + 1, torch.zeros_like(n_acc))
    is_eos = (emit == eos_id) & (idx < n_new[:, None])
    after = (is_eos.long().cumsum(1) - is_eos.long()) > 0
    emit = torch.where(after | ~active[:, None], torch.full_like(emit, pad), emit)
    return emit, n_new, finished | is_eos.any(1)


def _spec_stats(n_out, iters: int, act_win: int, T: int, k: int) -> dict:
    """``return_stats``: the first token comes from the prefill, so a
    row's window tokens are ``n_out - 1`` (raw, the last window may
    overshoot ``T``), over the active (row, window) pairs."""
    produced = n_out.tolist()
    per_window = float(sum(produced) - len(produced)) / max(int(act_win), 1)
    return {"iterations": int(iters),
            "tokens_generated": [min(n, T) for n in produced],
            "accepted_per_window": round(per_window, 3),
            "window_ceiling": int(k) + 1}


def _check_spec_knobs(speculate_k: int, temperature: float) -> None:
    if speculate_k < 1:
        raise ValueError("speculate_k must be >= 1")
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")


@torch.inference_mode()
def generate_speculative(model, draft_model, input_ids, attention_mask=None,
                         max_new_tokens: int = 64, speculate_k: int = 4,
                         temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                         seed: int = 0, return_stats: bool = False):
    """Speculative decoding (the JAX ``generate_speculative``): the draft
    proposes ``speculate_k`` tokens a token at a time, the target scores
    the window ``[last, d_0 .. d_{k-1}]`` in one pass, and each row keeps
    a prefix plus one token of the target's. At ``temperature=0`` the
    output is ``generate_causal``'s greedy continuation token for token,
    for any draft; above it each emitted token follows the target's
    warped distribution (temperature, ``top_k``, ``top_p``, applied to
    the draft too) exactly. Prompts are right-padded (``attention_mask``
    marks the real tokens). Cache slots run over the padded width,
    logical positions come from the mask, the room is ``P + T + k + 1``;
    each row's ``DenseCache.index`` is set per window (stale K/V past it
    stays, hidden by the step mask). With ``return_stats`` also the
    iterations and the tokens accepted per window."""
    cfg = model.config
    dev = model_device(model)
    input_ids, mask = _inputs(dev, input_ids, attention_mask)
    if bool((mask[:, :-1] < mask[:, 1:]).any()):
        raise ValueError(
            "generate_speculative requires RIGHT-padded prompts "
            "(attention_mask must be non-increasing per row): real "
            "tokens first, pads after")
    if bool((mask.sum(1) < 1).any()):
        raise ValueError("every prompt row needs at least one real token")
    if cfg.vocab_size != draft_model.config.vocab_size:
        raise ValueError(
            "draft and target must share a vocabulary (got "
            f"{draft_model.config.vocab_size} vs {cfg.vocab_size})")
    _refuse_experts(
        model, draft_model, what="generate_speculative",
        why="expert capacity is a function of the apply's sequence length, so "
            "the (k+1)-token verify window could capacity-drop token->expert "
            "assignments that generate_causal's single-token steps never drop — "
            "the greedy-exact guarantee would silently break")
    _check_spec_knobs(speculate_k, temperature)
    if (top_k or top_p) and temperature == 0.0:
        raise ValueError(
            "top_k/top_p warping requires temperature > 0 (greedy "
            "speculation is argmax, which filtering cannot change)")
    k, T = int(speculate_k), int(max_new_tokens)
    B, P = input_ids.shape
    pad, eos = int(cfg.pad_token_id), int(cfg.eos_token_id)
    gen = _generator(seed, dev) if temperature > 0 else None
    t_cache = model.new_dense_cache(B, P + T + k + 1)
    d_cache = draft_model.new_dense_cache(B, P + T + k + 1)
    valid = torch.cat([mask, torch.zeros(B, T + k + 1, dtype=torch.long, device=dev)], dim=1)
    n_real = mask.sum(1)
    pos = (mask.cumsum(1) - 1).clamp(min=0)
    rows = torch.arange(B, device=dev)
    last_logits = model(input_ids, valid, pos, t_cache)[rows, n_real - 1].float()
    draft_model(input_ids, valid, pos, d_cache)
    first = _sample_next(last_logits, temperature, top_k, top_p, gen)
    out = torch.full((B, T + k + 1), pad, dtype=torch.int32, device=dev)
    out[:, 0] = first
    n_out = torch.ones(B, dtype=torch.long, device=dev)
    n_ctx = torch.full((B,), P, dtype=torch.long, device=dev)      # cache slots
    n_pos = n_real.clone()                                         # logical positions
    last, finished = first, first == eos
    offs = torch.arange(k + 1, device=dev)
    iters = act_win = 0
    while True:
        active = (n_out < T) & ~finished
        if not bool(active.any()):
            break
        # rows done decoding keep running at slot and position 0, where
        # their writes land in room nothing reads again
        ctx = torch.where(active, n_ctx, 0)
        at = torch.where(active, n_pos, 0)
        # 1. the draft's k proposals (greedy, or sampled from its warped q)
        d_cache.index = ctx.clone()
        vld = valid.clone()
        tok, drafts, qs = last, [], []
        for t in range(k):
            _row_put(vld, torch.ones(B, 1, device=dev), ctx + t)
            lg = draft_model(tok[:, None], vld, (at + t)[:, None], d_cache)[:, -1].float()
            if temperature == 0.0:
                tok = lg.argmax(-1)
            else:
                warped = _warp_logits(lg, temperature, top_k, top_p)
                qs.append(torch.softmax(warped, -1))
                tok = _categorical(warped, _gumbel(warped.shape, gen, dev))
            drafts.append(tok)
        drafts = torch.stack(drafts, 1)
        # 2. one target pass verifies the window
        verify_in = torch.cat([last[:, None].long(), drafts], dim=1)
        vwin = valid.clone()
        _row_put(vwin, torch.ones(B, k + 1, device=dev), ctx)
        vpos = at[:, None] + offs[None]
        t_cache.index = ctx.clone()
        lg = model(verify_in, vwin, vpos, t_cache).float()
        if temperature == 0.0:
            n_acc, bonus = speculative_accept_greedy(lg.argmax(-1), drafts)
        else:
            p = torch.softmax(_warp_logits(lg, temperature, top_k, top_p), -1)
            V = p.shape[-1]
            n_acc, bonus = _speculative_accept(
                p, torch.stack(qs, 1), drafts,
                torch.rand(B, k, generator=gen, device=dev),
                _gumbel((B, V), gen, dev), _gumbel((B, V), gen, dev))
        emit, n_new, finished = _spec_emit(drafts, n_acc, bonus, active, finished, pad, eos)
        _row_put(out, emit, n_out.clamp(max=T))
        # commit: accepted slots become valid, rejected ones stay 0
        _row_put(valid, (offs[None] < n_new[:, None]).long(), ctx)
        # 3. the draft's cache replays the verified window (its own scan
        # never wrote the last slot); both indices are set next window
        d_cache.index = ctx.clone()
        draft_model(verify_in, vwin, vpos, d_cache)
        last = torch.where(active, bonus.to(last.dtype), last)
        n_out, n_ctx, n_pos = n_out + n_new, n_ctx + n_new, n_pos + n_new
        iters += 1
        act_win += int(active.sum())
    tokens = out[:, :T]
    return (tokens, _spec_stats(n_out, iters, act_win, T, k)) if return_stats else tokens


def self_draft(model, num_layers: int):
    """A layer-skip draft of a decoder ``model`` (GPT-2's ``h``, the Llama
    family's ``layers``): its first ``num_layers`` blocks with its
    embeddings, final norm and head — the module holds references to the
    target's tensors and copies nothing, so the draft costs no weight
    memory. :func:`generate_speculative` keeps the target's exact greedy
    output whatever the draft accepts."""
    cfg = model.config
    if not 1 <= num_layers < cfg.num_layers:
        raise ValueError(
            f"self_draft num_layers must be in [1, {cfg.num_layers - 1}] "
            f"(target has {cfg.num_layers}), got {num_layers}")
    with torch.device("meta"):
        draft = type(model)(dataclasses.replace(cfg, num_layers=num_layers))
    for name, child in model.backbone.named_children():
        if isinstance(child, nn.ModuleList):            # the block stack
            child = nn.ModuleList(list(child)[:num_layers])
        setattr(draft.backbone, name, child)
    for name, child in model.named_children():
        if name != "backbone":                           # an untied head
            setattr(draft, name, child)
    if getattr(model, "serve_shard", None) is not None:
        # the blocks are the target's shards: the draft's caches hold the
        # same local heads
        draft.serve_shard = model.serve_shard
    return draft.train(model.training)


@torch.inference_mode()
def generate_speculative_seq2seq(model, draft_model, input_ids, attention_mask=None,
                                 max_new_tokens: int = 64, speculate_k: int = 4,
                                 temperature: float = 0.0, seed: int = 0,
                                 return_stats: bool = False):
    """Speculative decoding for T5 (the JAX
    ``generate_speculative_seq2seq``): each model encodes the source once,
    then the draft-window / one-pass-verify / per-row-rewind loop of
    :func:`generate_speculative` runs on the decoders (slot 0 is
    ``decoder_start``, so slots are positions and no validity mask rides
    along). ``temperature=0`` is token-exact against greedy
    :func:`generate`; above it the rejection sampling keeps the target's
    tempered distribution. BART and mBART are refused, as in the JAX
    package."""
    for m, tag in ((model, "target"), (draft_model, "draft")):
        name = type(m.config).__name__
        if name != "T5Config":
            raise ValueError(
                f"generate_speculative_seq2seq supports the T5 family "
                f"only ({tag} has {name}): BART's absolute decoder "
                "positions live in a shared scalar that per-row cache "
                "rewinds would corrupt")
    cfg = model.config
    if getattr(cfg, "forced_bos_token_id", None) is not None:
        raise ValueError("forced_bos_token_id is not supported under "
                         "speculative decoding")
    if cfg.vocab_size != draft_model.config.vocab_size:
        raise ValueError("draft and target must share a vocabulary")
    _check_spec_knobs(speculate_k, temperature)
    dev = model.shared.weight.device
    input_ids, mask = _inputs(dev, input_ids, attention_mask)
    k, T = int(speculate_k), int(max_new_tokens)
    B = input_ids.shape[0]
    pad, eos = int(cfg.pad_token_id), int(cfg.eos_token_id)
    gen = _generator(seed, dev) if temperature > 0 else None
    enc_t = model.encode(input_ids, mask)
    enc_d = draft_model.encode(input_ids, mask)
    t_cache = model.new_dense_cache(B, T + k + 2)
    d_cache = draft_model.new_dense_cache(B, T + k + 2)
    start = torch.full((B, 1), cfg.decoder_start_token_id, dtype=torch.long, device=dev)
    lg = model.decode(start, enc_t, mask, cache=t_cache)[:, -1].float()
    draft_model.decode(start, enc_d, mask, cache=d_cache)
    first = _sample_next(lg, temperature, 0, 0.0, gen)
    out = torch.full((B, T + k + 1), pad, dtype=torch.int32, device=dev)
    out[:, 0] = first
    n_out = torch.ones(B, dtype=torch.long, device=dev)   # also the slots filled
    last, finished = first, first == eos
    iters = act_win = 0
    while True:
        active = (n_out < T) & ~finished
        if not bool(active.any()):
            break
        at = torch.where(active, n_out, 0)
        d_cache.index = at.clone()
        tok, drafts, qs = last, [], []
        for _ in range(k):
            lg = draft_model.decode(tok[:, None].long(), enc_d, mask,
                                    cache=d_cache)[:, -1].float()
            if temperature == 0.0:
                tok = lg.argmax(-1)
            else:
                warped = lg / temperature
                qs.append(torch.softmax(warped, -1))
                tok = _categorical(warped, _gumbel(warped.shape, gen, dev))
            drafts.append(tok)
        drafts = torch.stack(drafts, 1)
        verify_in = torch.cat([last[:, None].long(), drafts], dim=1)
        t_cache.index = at.clone()
        lg = model.decode(verify_in, enc_t, mask, cache=t_cache).float()
        if temperature == 0.0:
            n_acc, bonus = speculative_accept_greedy(lg.argmax(-1), drafts)
        else:
            p = torch.softmax(lg / temperature, -1)
            V = p.shape[-1]
            n_acc, bonus = _speculative_accept(
                p, torch.stack(qs, 1), drafts,
                torch.rand(B, k, generator=gen, device=dev),
                _gumbel((B, V), gen, dev), _gumbel((B, V), gen, dev))
        emit, n_new, finished = _spec_emit(drafts, n_acc, bonus, active, finished, pad, eos)
        _row_put(out, emit, n_out.clamp(max=T))
        d_cache.index = at.clone()
        draft_model.decode(verify_in, enc_d, mask, cache=d_cache)
        last = torch.where(active, bonus.to(last.dtype), last)
        n_out = n_out + n_new
        iters += 1
        act_win += int(active.sum())
    tokens = out[:, :T]
    return (tokens, _spec_stats(n_out, iters, act_win, T, k)) if return_stats else tokens
