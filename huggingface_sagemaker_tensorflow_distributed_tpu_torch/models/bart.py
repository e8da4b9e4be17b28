"""BART and mBART as ``nn.Module``s: the post-LN encoder-decoder LM of the
JAX package's ``models/bart.py`` (HF ``BartForConditionalGeneration``).

- the shared token embedding (times ``sqrt(d_model)`` with
  ``scale_embedding``) plus learned positions with BART's offset of 2
  (``embed_positions`` has ``max_position_embeddings + 2`` rows), then
  each stack's ``layernorm_embedding`` (``embed_ln``) and dropout;
- post-LN layers: ``ln(x + dropout(sublayer(x)))`` for self-attention,
  (decoder) cross-attention and the FFN, with activation dropout inside
  the FFN; mBART (``normalize_before``, ``stack_final_ln``) normalizes
  before each sublayer and after each stack instead;
- attention with biased q/k/v/out projections, q scaled by
  ``head_dim**-0.5`` before the product, the plain attention; in
  training with ``attention_dropout > 0`` the probabilities take dropout
  (the JAX package's unfused branch);
- the LM head tied to ``shared``; HF's ``final_logits_bias`` (zeros in
  every published checkpoint) is not modelled, as in the JAX package.

Module names follow the JAX parameter tree (``encoder/layer_0/self_attn/
query`` becomes ``encoder.layer.0.self_attn.query``). ``encode`` and
``decode`` (with a :class:`~.kv_cache.DenseCache` for the incremental
decoder, positions counted from the cache's index) are T5's interface,
so ``models/generate.py`` drives both. ``remat`` recomputes each layer in
backward under ``remat_policy`` (``models/layers.py:remat_policy``). With
``weight_quant='int8'`` every projection and FFN dense is
``models/quant.py``'s ``Int8Linear``. ``attention_impl='ring'`` is the
plain attention, as in the JAX package (BART has no ring site; the Trainer
refuses it under ``sp > 1``); pipeline stages raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch import nn

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.kv_cache import (
    DenseCache,
    write_kv_cache,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.layers import (
    ACT2FN,
    Embed,
    LayerNorm,
    raise_unported,
    remat_call,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.quant import make_dense
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.attention import (
    make_attention_mask,
    make_decoder_mask,
    make_step_mask,
    xla_attention,
)

POS_OFFSET = 2        # BartLearnedPositionalEmbedding's legacy offset
LN_EPS = 1e-5


@dataclass(frozen=True)
class BartConfig:
    """BART hyperparameters (the JAX ``BartConfig``'s fields)."""

    vocab_size: int = 50265
    d_model: int = 768
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_attention_heads: int = 12
    decoder_attention_heads: int = 12
    encoder_ffn_dim: int = 3072
    decoder_ffn_dim: int = 3072
    activation_function: str = "gelu"
    dropout: float = 0.1
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    max_position_embeddings: int = 1024
    init_std: float = 0.02
    scale_embedding: bool = False
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
    decoder_start_token_id: int = 2
    forced_bos_token_id: Optional[int] = None
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    attention_impl: str = "xla"          # xla | flash: both the plain attention
    remat: bool = False
    remat_policy: str = "full"
    normalize_before: bool = False       # mBART: pre-LN layers
    stack_final_ln: bool = False         # mBART: a final LN per stack
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0
    weight_quant: str = "none"

    def __post_init__(self):
        if self.attention_impl not in ("xla", "flash", "ring"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        if self.weight_quant not in ("none", "int8"):
            raise ValueError(f"unknown weight_quant {self.weight_quant!r} (none | int8)")
        raise_unported([
            (self.pipeline_stages != 0, "BART pipeline_stages", "11 (pipeline stages)")])


def bart_config_from_hf(hf_config: dict, **overrides) -> BartConfig:
    """An HF BART ``config.json`` as a :class:`BartConfig` (the JAX
    ``bart_config_from_hf``)."""
    kw = dict(
        vocab_size=hf_config["vocab_size"], d_model=hf_config["d_model"],
        encoder_layers=hf_config["encoder_layers"],
        decoder_layers=hf_config["decoder_layers"],
        encoder_attention_heads=hf_config["encoder_attention_heads"],
        decoder_attention_heads=hf_config["decoder_attention_heads"],
        encoder_ffn_dim=hf_config["encoder_ffn_dim"],
        decoder_ffn_dim=hf_config["decoder_ffn_dim"],
        activation_function=hf_config.get("activation_function", "gelu"),
        dropout=hf_config.get("dropout", 0.1),
        attention_dropout=hf_config.get("attention_dropout", 0.0),
        activation_dropout=hf_config.get("activation_dropout", 0.0),
        max_position_embeddings=hf_config.get("max_position_embeddings", 1024),
        init_std=hf_config.get("init_std", 0.02),
        scale_embedding=hf_config.get("scale_embedding", False),
        pad_token_id=hf_config.get("pad_token_id", 1),
        bos_token_id=hf_config.get("bos_token_id", 0),
        eos_token_id=hf_config.get("eos_token_id", 2),
        decoder_start_token_id=(hf_config["decoder_start_token_id"]
                                if hf_config.get("decoder_start_token_id") is not None
                                else hf_config.get("eos_token_id", 2)),
        forced_bos_token_id=hf_config.get("forced_bos_token_id"),
    )
    kw.update(overrides)
    kw.pop("use_pooler", None)
    return BartConfig(**kw)


def mbart_config_from_hf(hf_config: dict, **overrides) -> BartConfig:
    """mBART: BART's fields with pre-LN layers and a final LN per stack
    (HF hardcodes both in the modeling class, not in ``config.json``)."""
    return bart_config_from_hf(hf_config, **{"normalize_before": True,
                                             "stack_final_ln": True, **overrides})


def bart_config_to_hf(c: BartConfig, model_type: str = "bart") -> dict:
    """The ``config.json`` the JAX package exports for a BART or mBART."""
    arch = "MBartForConditionalGeneration" if model_type == "mbart" else \
        "BartForConditionalGeneration"
    return {
        "model_type": model_type, "architectures": [arch],
        "vocab_size": c.vocab_size, "d_model": c.d_model,
        "encoder_layers": c.encoder_layers, "decoder_layers": c.decoder_layers,
        "encoder_attention_heads": c.encoder_attention_heads,
        "decoder_attention_heads": c.decoder_attention_heads,
        "encoder_ffn_dim": c.encoder_ffn_dim, "decoder_ffn_dim": c.decoder_ffn_dim,
        "activation_function": c.activation_function,
        "dropout": c.dropout, "attention_dropout": c.attention_dropout,
        "activation_dropout": c.activation_dropout,
        "max_position_embeddings": c.max_position_embeddings,
        "init_std": c.init_std, "scale_embedding": c.scale_embedding,
        "pad_token_id": c.pad_token_id, "bos_token_id": c.bos_token_id,
        "eos_token_id": c.eos_token_id,
        "decoder_start_token_id": c.decoder_start_token_id,
        "forced_bos_token_id": c.forced_bos_token_id,
    }


class BartAttention(nn.Module):
    """Biased-projection attention, q pre-scaled; the decoder's
    self-attention writes the dense decode cache."""

    def __init__(self, cfg: BartConfig, num_heads: int, layer: int = 0):
        super().__init__()
        self.cfg, self.num_heads, self.layer = cfg, num_heads, layer
        d = cfg.d_model
        self.query = make_dense(cfg, d, d)
        self.key = make_dense(cfg, d, d)
        self.value = make_dense(cfg, d, d)
        self.attention_out = make_dense(cfg, d, d)
        self.attn_dropout = nn.Dropout(cfg.attention_dropout)

    def forward(self, hidden, kv_hidden=None, mask=None, cache=None):
        cfg = self.cfg
        B, S, d = hidden.shape
        hd = d // self.num_heads
        source = hidden if kv_hidden is None else kv_hidden

        def split(x):
            return x.reshape(B, x.shape[1], self.num_heads, hd).transpose(1, 2)

        q = split(self.query(hidden)) * hd ** -0.5
        k, v = split(self.key(source)), split(self.value(source))
        if cache is not None and kv_hidden is None:
            k, v = write_kv_cache(cache, self.layer, k, v, cfg.dtype)
        dropout = (self.attn_dropout if cfg.attention_dropout > 0 and self.training
                   else None)
        ctx = xla_attention(q, k, v, mask=mask, scale=1.0, dropout=dropout)
        return self.attention_out(ctx.transpose(1, 2).reshape(B, S, d))


class BartLayer(nn.Module):
    """One encoder or decoder layer, post-LN (BART) or pre-LN (mBART)."""

    def __init__(self, cfg: BartConfig, is_decoder: bool, layer: int):
        super().__init__()
        self.pre = cfg.normalize_before
        self.is_decoder = is_decoder
        heads = cfg.decoder_attention_heads if is_decoder else cfg.encoder_attention_heads
        ffn = cfg.decoder_ffn_dim if is_decoder else cfg.encoder_ffn_dim
        self.self_attn = BartAttention(cfg, heads, layer)
        self.self_attn_ln = LayerNorm(cfg, cfg.d_model, eps=LN_EPS)
        if is_decoder:
            self.cross_attn = BartAttention(cfg, heads)
            self.cross_ln = LayerNorm(cfg, cfg.d_model, eps=LN_EPS)
        self.fc1 = make_dense(cfg, cfg.d_model, ffn)
        self.fc2 = make_dense(cfg, ffn, cfg.d_model)
        self.ffn_ln = LayerNorm(cfg, cfg.d_model, eps=LN_EPS)
        self.act = ACT2FN[cfg.activation_function]
        self.dropout = nn.Dropout(cfg.dropout)
        self.act_dropout = nn.Dropout(cfg.activation_dropout)

    def _sublayer(self, hidden, ln, fn):
        x = fn(ln(hidden) if self.pre else hidden)
        hidden = hidden + self.dropout(x)
        return hidden if self.pre else ln(hidden)

    def forward(self, hidden, attn_mask=None, enc_hidden=None, enc_mask=None, cache=None):
        hidden = self._sublayer(hidden, self.self_attn_ln,
                                lambda x: self.self_attn(x, mask=attn_mask, cache=cache))
        if self.is_decoder:
            hidden = self._sublayer(hidden, self.cross_ln,
                                    lambda x: self.cross_attn(x, kv_hidden=enc_hidden,
                                                              mask=enc_mask))
        return self._sublayer(hidden, self.ffn_ln,
                              lambda x: self.fc2(self.act_dropout(self.act(self.fc1(x)))))


class BartStack(nn.Module):
    """Offset-2 learned positions and ``embed_ln`` over the (shared) token
    embeddings, then the layers (and mBART's final LN)."""

    def __init__(self, cfg: BartConfig, is_decoder: bool = False):
        super().__init__()
        self.cfg = cfg
        self.embed_positions = Embed(cfg, cfg.max_position_embeddings + POS_OFFSET,
                                     cfg.d_model)
        self.embed_ln = LayerNorm(cfg, cfg.d_model, eps=LN_EPS)
        n = cfg.decoder_layers if is_decoder else cfg.encoder_layers
        self.layer = nn.ModuleList(BartLayer(cfg, is_decoder, i) for i in range(n))
        if cfg.stack_final_ln:
            self.final_ln = LayerNorm(cfg, cfg.d_model, eps=LN_EPS)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, embeds, attn_mask=None, enc_hidden=None, enc_mask=None, cache=None):
        S = embeds.shape[1]
        pos = torch.arange(S, device=embeds.device)[None, :] + POS_OFFSET
        if cache is not None:
            pos = pos + cache.index[:, None]
            step = make_step_mask(cache.index, S, cache.keys[0].shape[2])
            attn_mask = step if attn_mask is None else attn_mask + step
        x = self.dropout(self.embed_ln(embeds + self.embed_positions(pos)))
        remat = self.cfg.remat and cache is None and torch.is_grad_enabled()
        for layer in self.layer:
            if remat:
                x = remat_call(layer, x, attn_mask, enc_hidden, enc_mask,
                               policy=self.cfg.remat_policy)
            else:
                x = layer(x, attn_mask, enc_hidden, enc_mask, cache)
        if cache is not None:
            cache.index = cache.index + S
        return self.final_ln(x) if self.cfg.stack_final_ln else x


class BartForConditionalGeneration(nn.Module):
    """The encoder-decoder LM with the head tied to ``shared``; fp32
    logits; the same ``encode``/``decode`` interface as T5."""

    is_encoder_decoder = True

    def __init__(self, cfg: BartConfig):
        super().__init__()
        self.config = cfg
        self.shared = Embed(cfg, cfg.vocab_size, cfg.d_model)
        self.encoder = BartStack(cfg, is_decoder=False)
        self.decoder = BartStack(cfg, is_decoder=True)

    def _embed_tokens(self, ids):
        cfg = self.config
        return self.shared(ids) * (cfg.d_model ** 0.5 if cfg.scale_embedding else 1.0)

    def encode(self, input_ids, attention_mask=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        return self.encoder(self._embed_tokens(input_ids),
                            attn_mask=make_attention_mask(attention_mask))

    def _decoder_hidden(self, decoder_input_ids, encoder_hidden, encoder_attention_mask,
                        decoder_attention_mask, cache):
        self_mask = (None if cache is not None
                     else make_decoder_mask(decoder_input_ids, decoder_attention_mask))
        enc_mask = (None if encoder_attention_mask is None
                    else make_attention_mask(encoder_attention_mask))
        x = self.decoder(self._embed_tokens(decoder_input_ids), attn_mask=self_mask,
                         enc_hidden=encoder_hidden, enc_mask=enc_mask, cache=cache)
        return x.to(self.config.dtype)

    def decode(self, decoder_input_ids, encoder_hidden, encoder_attention_mask=None,
               decoder_attention_mask=None, cache: Optional[DenseCache] = None):
        x = self._decoder_hidden(decoder_input_ids, encoder_hidden, encoder_attention_mask,
                                 decoder_attention_mask, cache)
        return torch.matmul(x, self.shared.weight.to(self.config.dtype).t()).float()

    def forward(self, input_ids, attention_mask=None, decoder_input_ids=None,
                decoder_attention_mask=None):
        enc = self.encode(input_ids, attention_mask)
        return self.decode(decoder_input_ids, enc, attention_mask, decoder_attention_mask)

    def seq2seq_hidden_and_embedding(self, input_ids, attention_mask=None,
                                     decoder_input_ids=None, decoder_attention_mask=None):
        """``(decoder hidden [B, T, H] in the compute dtype, tied embedding
        [V, H] in the param dtype)``: the fused vocab-CE path."""
        enc = self.encode(input_ids, attention_mask)
        return (self._decoder_hidden(decoder_input_ids, enc, attention_mask,
                                     decoder_attention_mask, None), self.shared.weight)

    def new_dense_cache(self, batch: int, max_len: int) -> DenseCache:
        cfg = self.config
        heads = cfg.decoder_attention_heads
        return DenseCache.empty(cfg.decoder_layers, batch, heads, max_len,
                                cfg.d_model // heads, cfg.dtype, self.shared.weight.device)
