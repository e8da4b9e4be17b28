"""T5 as ``nn.Module``s: the encoder-decoder LM of the JAX package's
``models/t5.py`` (HF ``T5ForConditionalGeneration`` architecture).

- RMS layer norms (no mean subtraction, no bias) with fp32 statistics,
  output in the compute dtype;
- pre-LN blocks: ``x + attn(ln(x))``, in the decoder ``x +
  cross(ln(x), encoder)``, then ``x + ffn(ln(x))``, dropout on each
  output, on the embeddings and after the final norm;
- attention without biases and without the ``d**-0.5`` scale, with the
  relative-position bias that the first block of each stack computes
  (bidirectional in the encoder, causal in the decoder) and threads down
  the stack; the additive ``-1e9`` masks; no probability dropout;
- a ReLU FFN (v1.0) or a gated-GeLU one (v1.1, ``feed_forward_proj
  'gated-gelu'``, tanh GeLU);
- the LM head tied to ``shared`` with the hidden scaled by
  ``d_model**-0.5`` (v1.0), or an untied ``lm_head`` (v1.1).

Attention is the plain ``ops.attention.xla_attention`` on every device,
as the JAX package runs T5 (the flash kernels take no ``[B, H, Q, K]``
bias). Module names follow the JAX parameter tree (``encoder/block_0/
self_attn/query`` becomes ``encoder.block.0.self_attn.query``;
``rel_bias`` lives on block 0 of each stack only), so
``convert.params_from_jax`` carries weights across by name.

``decode`` with a :class:`~.kv_cache.DenseCache` is the incremental
decoder of ``models/generate.py``: each block's self-attention K/V is
written at each row's ``cache.index`` and the queries attend over the
whole buffer under the step mask ``key <= index + query offset``; the
relative-position bias is offset by the index. With ``remat`` each block
of a training forward is recomputed in backward
(``torch.utils.checkpoint``). With ``weight_quant='int8'`` the attention
and FFN denses are ``models/quant.py``'s ``Int8Linear`` (the head stays
full precision). The remat policy is ``remat_policy``
(``models/layers.py:remat_policy``). With ``attention_impl='ring'`` the
encoder's self-attention takes the raw ``[num_buckets, heads]`` bias table
and the ring re-tiles it per step from global positions
(``parallel/ring_attention.py``); under a mesh whose ``seq`` axis is active
the encoder runs on this rank's block of tokens and its output is gathered
back whole, so the decoder, its cross-attention and the head stay whole on
every rank. The parameters are the same in every mode. Pipeline stages
raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.kv_cache import (
    DenseCache,
    write_kv_cache,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.layers import (
    Dense,
    Embed,
    raise_unported,
    remat_call,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.quant import make_dense
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.attention import (
    make_attention_mask,
    make_decoder_mask,
    make_step_mask,
    relative_position_bias,
    xla_attention,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.ring_attention import (
    model_seq_shard,
    ring_attention_or_fallback,
)

_ACTS = {"relu": F.relu, "gelu": lambda x: F.gelu(x, approximate="tanh"), "silu": F.silu}


@dataclass(frozen=True)
class T5Config:
    """T5 hyperparameters (the JAX ``T5Config``'s fields)."""

    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_decoder_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"      # relu (v1.0) | gated-gelu (v1.1)
    tie_word_embeddings: bool = True
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0
    initializer_factor: float = 1.0
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    remat: bool = False
    remat_policy: str = "full"
    attention_impl: str = "xla"          # xla | flash: the plain attention; ring
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0
    weight_quant: str = "none"

    def __post_init__(self):
        if self.attention_impl not in ("xla", "flash", "ring"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        if self.weight_quant not in ("none", "int8"):
            raise ValueError(f"unknown weight_quant {self.weight_quant!r} (none | int8)")
        if self.feed_forward_proj.split("-")[-1] not in _ACTS:
            raise ValueError(f"unknown feed_forward_proj {self.feed_forward_proj!r}")
        raise_unported([
            (self.pipeline_stages != 0, "T5 pipeline_stages", "11 (pipeline stages)")])

    @property
    def is_gated_act(self) -> bool:
        return self.feed_forward_proj.startswith("gated-")

    @property
    def act_fn(self):
        return _ACTS[self.feed_forward_proj.split("-")[-1]]


def t5_config_from_hf(hf_config: dict, **overrides) -> T5Config:
    """An HF T5 ``config.json`` as a :class:`T5Config` (the JAX
    ``t5_config_from_hf``)."""
    ff_proj = hf_config.get("feed_forward_proj", "relu")
    if hf_config.get("is_gated_act") and not ff_proj.startswith("gated-"):
        ff_proj = "gated-" + ff_proj
    kw = dict(
        vocab_size=hf_config["vocab_size"], d_model=hf_config["d_model"],
        d_kv=hf_config["d_kv"], d_ff=hf_config["d_ff"],
        num_layers=hf_config["num_layers"],
        num_decoder_layers=hf_config.get("num_decoder_layers", hf_config["num_layers"]),
        num_heads=hf_config["num_heads"],
        relative_attention_num_buckets=hf_config.get("relative_attention_num_buckets", 32),
        relative_attention_max_distance=hf_config.get("relative_attention_max_distance", 128),
        dropout_rate=hf_config.get("dropout_rate", 0.1),
        layer_norm_epsilon=hf_config.get("layer_norm_epsilon", 1e-6),
        feed_forward_proj=ff_proj,
        tie_word_embeddings=hf_config.get("tie_word_embeddings", True),
        pad_token_id=hf_config.get("pad_token_id", 0),
        eos_token_id=hf_config.get("eos_token_id", 1),
        decoder_start_token_id=hf_config.get("decoder_start_token_id", 0),
        initializer_factor=hf_config.get("initializer_factor", 1.0),
    )
    kw.update(overrides)
    return T5Config(**kw)


def t5_config_to_hf(c: T5Config) -> dict:
    """The ``config.json`` the JAX package exports for a T5."""
    return {
        "model_type": "t5", "architectures": ["T5ForConditionalGeneration"],
        "vocab_size": c.vocab_size, "d_model": c.d_model, "d_kv": c.d_kv,
        "d_ff": c.d_ff, "num_layers": c.num_layers,
        "num_decoder_layers": c.num_decoder_layers, "num_heads": c.num_heads,
        "relative_attention_num_buckets": c.relative_attention_num_buckets,
        "relative_attention_max_distance": c.relative_attention_max_distance,
        "dropout_rate": c.dropout_rate, "layer_norm_epsilon": c.layer_norm_epsilon,
        "feed_forward_proj": c.feed_forward_proj,
        "tie_word_embeddings": c.tie_word_embeddings,
        "pad_token_id": c.pad_token_id, "eos_token_id": c.eos_token_id,
        "decoder_start_token_id": c.decoder_start_token_id,
        "initializer_factor": c.initializer_factor,
    }


class RMSNorm(nn.Module):
    """Scale-only RMS normalization, fp32 statistics, output in ``dtype``;
    ``weight`` is flax's ``scale``."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(cfg.d_model, dtype=cfg.param_dtype))
        self.eps = cfg.layer_norm_epsilon
        self.compute_dtype = cfg.dtype

    def forward(self, x):
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps)
        return (x32 * self.weight.float()).to(self.compute_dtype)


class T5Attention(nn.Module):
    """Bias-free, unscaled multi-head attention with an optional
    relative-position bias (``rel_bias``, block 0 only) and the dense
    decode cache."""

    def __init__(self, cfg: T5Config, causal: bool = False, has_rel_bias: bool = False,
                 layer: int = 0):
        super().__init__()
        self.cfg, self.causal, self.layer = cfg, causal, layer
        inner = cfg.num_heads * cfg.d_kv
        self.query = make_dense(cfg, cfg.d_model, inner, bias=False)
        self.key = make_dense(cfg, cfg.d_model, inner, bias=False)
        self.value = make_dense(cfg, cfg.d_model, inner, bias=False)
        self.attention_out = make_dense(cfg, inner, cfg.d_model, bias=False)
        self.rel_bias = (nn.Embedding(cfg.relative_attention_num_buckets, cfg.num_heads,
                                      dtype=cfg.param_dtype) if has_rel_bias else None)

    def position_bias(self, q_len: int, kv_len: int, offset=None):
        """``[1, H, q, kv]`` fp32 bias from the bucketed relative positions;
        a per-row ``offset`` ``[B]`` (the cached decode's write index)
        shifts the queries and gives ``[B, H, q, kv]``."""
        cfg = self.cfg
        dev = self.rel_bias.weight.device
        q_pos = torch.arange(q_len, device=dev)[:, None]
        if offset is not None:
            q_pos = q_pos[None] + offset.to(dev)[:, None, None]
        return relative_position_bias(
            self.rel_bias.weight, q_pos, torch.arange(kv_len, device=dev)[None, :],
            bidirectional=not self.causal,
            num_buckets=cfg.relative_attention_num_buckets,
            max_distance=cfg.relative_attention_max_distance)

    def forward(self, hidden, kv_hidden=None, mask=None, position_bias=None, cache=None):
        """``(output, position_bias)``: the bias this block computed (block
        0) or was handed, for the next block."""
        cfg = self.cfg
        B, S, _ = hidden.shape
        source = hidden if kv_hidden is None else kv_hidden

        def split(x):
            return x.reshape(B, x.shape[1], cfg.num_heads, cfg.d_kv).transpose(1, 2)

        q, k, v = split(self.query(hidden)), split(self.key(source)), split(self.value(source))
        offset = None
        if cache is not None and kv_hidden is None:
            k, v = write_kv_cache(cache, self.layer, k, v, cfg.dtype)
            offset = cache.index
        if (cfg.attention_impl == "ring" and kv_hidden is None and cache is None
                and not self.causal):
            # the encoder's self-attention: the raw table threads down the
            # stack, and the ring (or its plain fallback) tiles the bias
            if position_bias is None and self.rel_bias is not None:
                position_bias = self.rel_bias.weight
            spec = (True, cfg.relative_attention_num_buckets,
                    cfg.relative_attention_max_distance)
            ctx = ring_attention_or_fallback(
                q, k, v, mask=mask, scale=1.0, rel_bias_table=position_bias,
                rel_bias_spec=spec if position_bias is not None else None)
            return self.attention_out(ctx.transpose(1, 2).reshape(B, S, -1)), position_bias
        if position_bias is None and self.rel_bias is not None:
            position_bias = self.position_bias(S, k.shape[2], offset)
        bias = position_bias if mask is None else (
            mask if position_bias is None else position_bias + mask)
        ctx = xla_attention(q, k, v, mask=bias, scale=1.0)
        out = self.attention_out(ctx.transpose(1, 2).reshape(B, S, -1))
        return out, position_bias


class T5FeedForward(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.act = cfg.act_fn
        self.gated = cfg.is_gated_act
        if self.gated:
            self.wi_0 = make_dense(cfg, cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = make_dense(cfg, cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = make_dense(cfg, cfg.d_model, cfg.d_ff, bias=False)
        self.wo = make_dense(cfg, cfg.d_ff, cfg.d_model, bias=False)
        self.dropout = nn.Dropout(cfg.dropout_rate)

    def forward(self, x):
        if self.gated:
            x = self.act(self.wi_0(x)) * self.wi_1(x)
        else:
            x = self.act(self.wi(x))
        return self.wo(self.dropout(x))


class T5Block(nn.Module):
    """Pre-LN block: self-attention (+ cross-attention in the decoder) and
    the FFN."""

    def __init__(self, cfg: T5Config, is_decoder: bool, layer: int):
        super().__init__()
        self.is_decoder = is_decoder
        self.attn_ln = RMSNorm(cfg)
        self.self_attn = T5Attention(cfg, causal=is_decoder, has_rel_bias=layer == 0,
                                     layer=layer)
        if is_decoder:
            self.cross_ln = RMSNorm(cfg)
            self.cross_attn = T5Attention(cfg)
        self.ffn_ln = RMSNorm(cfg)
        self.ffn = T5FeedForward(cfg)
        self.dropout = nn.Dropout(cfg.dropout_rate)

    def forward(self, hidden, attn_mask, enc_hidden, enc_mask, position_bias, cache=None):
        attn, position_bias = self.self_attn(self.attn_ln(hidden), mask=attn_mask,
                                             position_bias=position_bias, cache=cache)
        hidden = hidden + self.dropout(attn)
        if self.is_decoder:
            cross, _ = self.cross_attn(self.cross_ln(hidden), kv_hidden=enc_hidden,
                                       mask=enc_mask)
            hidden = hidden + self.dropout(cross)
        hidden = hidden + self.dropout(self.ffn(self.ffn_ln(hidden)))
        return hidden, position_bias


class T5Stack(nn.Module):
    """The encoder or decoder blocks over embedded inputs, then the final
    RMS norm."""

    def __init__(self, cfg: T5Config, is_decoder: bool = False):
        super().__init__()
        self.cfg = cfg
        n = cfg.num_decoder_layers if is_decoder else cfg.num_layers
        self.block = nn.ModuleList(T5Block(cfg, is_decoder, i) for i in range(n))
        self.final_ln = RMSNorm(cfg)
        self.dropout = nn.Dropout(cfg.dropout_rate)

    def forward(self, embeds, attn_mask=None, enc_hidden=None, enc_mask=None, cache=None):
        if cache is not None:
            step = make_step_mask(cache.index, embeds.shape[1], cache.keys[0].shape[2])
            attn_mask = step if attn_mask is None else attn_mask + step
        hidden = self.dropout(embeds)
        remat = self.cfg.remat and cache is None and torch.is_grad_enabled()
        position_bias = None
        for block in self.block:
            if remat:
                hidden, position_bias = remat_call(block, hidden, attn_mask, enc_hidden,
                                                   enc_mask, position_bias,
                                                   policy=self.cfg.remat_policy)
            else:
                hidden, position_bias = block(hidden, attn_mask, enc_hidden, enc_mask,
                                              position_bias, cache)
        if cache is not None:
            cache.index = cache.index + embeds.shape[1]
        return self.dropout(self.final_ln(hidden))


class T5ForConditionalGeneration(nn.Module):
    """The encoder-decoder LM. ``encode`` and ``decode`` are separate so
    that generation runs the encoder once; logits are fp32."""

    is_encoder_decoder = True

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.config = cfg
        self.shared = Embed(cfg, cfg.vocab_size, cfg.d_model)
        self.encoder = T5Stack(cfg, is_decoder=False)
        self.decoder = T5Stack(cfg, is_decoder=True)
        if not cfg.tie_word_embeddings:
            self.lm_head = Dense(cfg, cfg.d_model, cfg.vocab_size, bias=False)

    def encode(self, input_ids, attention_mask=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        embeds, mask = self.shared(input_ids), make_attention_mask(attention_mask)
        seq = model_seq_shard(self.config.attention_impl)
        if seq is None:
            return self.encoder(embeds, attn_mask=mask)
        return seq.gather(self.encoder(seq.local(embeds), attn_mask=seq.local_mask(mask)))

    def _decoder_hidden(self, decoder_input_ids, encoder_hidden, encoder_attention_mask,
                        decoder_attention_mask, cache):
        self_mask = (None if cache is not None
                     else make_decoder_mask(decoder_input_ids, decoder_attention_mask))
        enc_mask = (None if encoder_attention_mask is None
                    else make_attention_mask(encoder_attention_mask))
        return self.decoder(self.shared(decoder_input_ids), attn_mask=self_mask,
                            enc_hidden=encoder_hidden, enc_mask=enc_mask, cache=cache)

    def _head(self, hidden):
        """(hidden the head multiplies, the head's weight [V, H] as stored)."""
        if self.config.tie_word_embeddings:
            return hidden * (self.config.d_model ** -0.5), self.shared.weight
        return hidden, self.lm_head.effective_weight()

    def decode(self, decoder_input_ids, encoder_hidden, encoder_attention_mask=None,
               decoder_attention_mask=None, cache: Optional[DenseCache] = None):
        """Decoder forward to fp32 vocab logits; with ``cache`` the step
        mask comes from the cache and ``decoder_attention_mask`` is
        unused."""
        hidden, weight = self._head(self._decoder_hidden(
            decoder_input_ids, encoder_hidden, encoder_attention_mask,
            decoder_attention_mask, cache))
        dt = self.config.dtype
        return torch.matmul(hidden.to(dt), weight.to(dt).t()).float()

    def forward(self, input_ids, attention_mask=None, decoder_input_ids=None,
                decoder_attention_mask=None):
        enc = self.encode(input_ids, attention_mask)
        return self.decode(decoder_input_ids, enc, attention_mask, decoder_attention_mask)

    def seq2seq_hidden_and_embedding(self, input_ids, attention_mask=None,
                                     decoder_input_ids=None, decoder_attention_mask=None):
        """``(decoder hidden [B, T, H] in the compute dtype, tied head
        scaling applied, LM weight [V, H] in the param dtype)``: the fused
        vocab-CE path; ``hidden·Wᵀ`` is ``forward``'s logits without the
        [B, T, V] tensor. The untied head hands ``lm_head.weight``."""
        enc = self.encode(input_ids, attention_mask)
        return self._head(self._decoder_hidden(decoder_input_ids, enc, attention_mask,
                                               decoder_attention_mask, None))

    def new_dense_cache(self, batch: int, max_len: int) -> DenseCache:
        """Zeroed ``[B, H, max_len, d_kv]`` self-attention buffers for every
        decoder block, on the model's device."""
        cfg = self.config
        return DenseCache.empty(cfg.num_decoder_layers, batch, cfg.num_heads, max_len,
                                cfg.d_kv, cfg.dtype, self.shared.weight.device)
