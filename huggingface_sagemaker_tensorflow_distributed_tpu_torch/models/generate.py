"""Greedy decoding against a dense KV cache: the counterparts of the JAX
package's ``models/generate.py::generate_causal`` and ``generate`` (the
encoder-decoder one), greedy paths only.

``generate_causal`` is the plain reference decode of the port: the oracle
the serving engine's tests compare tokens with, and the path
``chip_smoke.py`` holds the kernel path against on the card. It never
touches the paged kernel. ``generate`` runs a T5 or BART encoder once and
its decoder a token a step from a ``[B, H, max_new_tokens, D]`` dense
cache (cross-attention recomputes K/V from the encoder output each step,
as the JAX package's does). Sampling, beam search and speculative
decoding are not ported and raise.
"""

from __future__ import annotations

import torch


@torch.inference_mode()
def generate_causal(model, input_ids, attention_mask=None,
                    max_new_tokens: int = 64, output_scores: bool = False):
    """Greedy continuation of ``input_ids`` [B, P] (left padding marked
    0 in ``attention_mask``). One prefill pass writes the prompt into a
    ``P + max_new_tokens`` cache, then one token per step. Returns
    [B, max_new_tokens] int32 ids, ``pad_token_id`` after EOS; with
    ``output_scores`` also the fp32 logits each token was picked from,
    [B, max_new_tokens, vocab] (zeros once every row finished)."""
    cfg = model.config
    dev = model.backbone.wte.weight.device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    attention_mask = torch.as_tensor(attention_mask, device=dev).long()
    B, P = input_ids.shape
    total = P + max_new_tokens
    cache = model.new_dense_cache(B, total)
    valid = torch.cat([attention_mask,
                       torch.zeros(B, max_new_tokens, dtype=torch.long,
                                   device=dev)], dim=1)
    n_real = attention_mask.sum(1)
    pos = (attention_mask.cumsum(1) - 1).clamp(min=0)
    last_real = P - 1 - attention_mask.flip(1).argmax(1)
    logits = model(input_ids, valid, pos, cache)
    last = logits[torch.arange(B, device=dev), last_real]
    token = last.argmax(-1)
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
        logits = model(token[:, None], valid, (n_real + t)[:, None], cache)
        last = logits[:, -1]
        nxt = last.argmax(-1)
        nxt = torch.where(finished, cfg.pad_token_id, nxt)
        finished = finished | (nxt == cfg.eos_token_id)
        out[:, t + 1] = nxt
        if output_scores:
            scores[:, t + 1] = last
        token = nxt
    return (out, scores) if output_scores else out


def _unported_decoding(what: str):
    raise NotImplementedError(f"{what} is not ported to the PyTorch package yet: "
                              "ROADMAP queue 1, item 8 (decoding)")


@torch.inference_mode()
def generate(model, input_ids, attention_mask=None, max_new_tokens: int = 64,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0):
    """Greedy output ids of an encoder-decoder ``model`` (T5, BART) for
    source ids ``input_ids`` [B, S] (padding marked 0 in
    ``attention_mask``): [B, max_new_tokens] int32, ``pad_token_id`` after
    each row's EOS. The first step starts from ``decoder_start_token_id``;
    a config's ``forced_bos_token_id`` (mBART's target language) is the
    first token. ``temperature > 0``, ``top_k`` and ``top_p`` raise."""
    if temperature > 0 or top_k or top_p:
        _unported_decoding("sampling (temperature, top_k, top_p)")
    cfg = model.config
    dev = model.shared.weight.device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    attention_mask = torch.as_tensor(attention_mask, device=dev).long()
    B = input_ids.shape[0]
    encoder_hidden = model.encode(input_ids, attention_mask)
    cache = model.new_dense_cache(B, max_new_tokens)
    token = torch.full((B, 1), cfg.decoder_start_token_id, dtype=torch.long, device=dev)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    out = torch.full((B, max_new_tokens), cfg.pad_token_id, dtype=torch.int32, device=dev)
    forced = getattr(cfg, "forced_bos_token_id", None)
    for t in range(max_new_tokens):
        if bool(finished.all()):
            break                # every later token is the pad id
        logits = model.decode(token, encoder_hidden, attention_mask, cache=cache)[:, -1]
        nxt = (torch.full_like(finished, forced, dtype=torch.long)
               if t == 0 and forced is not None else logits.argmax(-1))
        nxt = torch.where(finished, cfg.pad_token_id, nxt)
        finished = finished | (nxt == cfg.eos_token_id)
        out[:, t] = nxt
        token = nxt[:, None]
    return out


def beam_search_generate(*args, **kwargs):
    """Beam search for encoder-decoders (JAX ``beam_search_generate``)."""
    _unported_decoding("beam_search_generate")


def generate_speculative_seq2seq(*args, **kwargs):
    """Speculative encoder-decoder decoding (JAX
    ``generate_speculative_seq2seq``)."""
    _unported_decoding("generate_speculative_seq2seq")
