"""DeBERTa-v2/v3: disentangled-attention encoders and their task heads
(counterpart of the JAX package's ``models/deberta.py``; HF
``DebertaV2Model`` architecture).

- **Disentangled attention**: content-to-content scores plus
  content-to-position (c2p) and position-to-content (p2c) terms from a
  shared relative-position table over log-bucketed distances
  (:func:`make_log_bucket_position`), every term divided by
  ``sqrt(head_dim * (1 + |pos_att_type|))``; c2p gathers along the key
  axis at ``clip(rel + span)``, p2c at ``clip(-rel + span)`` and is then
  transposed. v3 reuses the content query and key projections for the
  position terms (``share_att_key``), so they see the same (under LoRA,
  merged) weights.
- **The mask is a ``where``** over a query-and-key mask: a padded query's
  row is uniform, not a softmax of its scores, as in the JAX package.
- Embeddings: word (+ absolute positions when ``position_biased_input``,
  + token types when ``type_vocab_size > 0``), ``embed_proj`` when
  ``embedding_size`` differs from ``hidden_size``, layer norm, pads zeroed.
  The encoder-level ``rel_embeddings`` table is cast to the compute dtype
  and layer-normed when ``norm_rel_ebd`` says so; only its first
  ``2 * span`` rows are used. An optional ``ConvLayer`` (deberta-v2-xlarge)
  merges into the first layer's output; flax's ``padding="SAME"`` is
  ``Conv1d(padding=(K - 1) // 2)`` for odd K only, so an even K raises.
- The ``[B, H, S, S]`` fp32 scores with two gathers a layer are the plain
  attention's: this family runs no flash kernel, whatever
  ``attention_impl`` says, as in the JAX package. The fused MLM loss (K2)
  serves its masked-LM head like any encoder's.

Module names mirror the flax tree (``backbone.layer.<i>.attention.query``
is ``backbone/layer_<i>/attention/query``), so ``convert.params_from_jax``
carries weights across; the conv kernel's ``.T`` is ``Conv1d``'s
``[out, in / groups, K]``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.layers import (
    ACT2FN,
    Dense,
    Embed,
    LayerNorm,
    MlmHead,
    remat_call,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.lora import lora_delta

NEG_INF = -1e9


@dataclass(frozen=True)
class DebertaV2Config:
    vocab_size: int = 128100
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 0
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-7
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    pooler_dropout: float = 0.0
    pooler_hidden_act: str = "gelu"
    classifier_dropout: Optional[float] = None   # HF cls_dropout
    initializer_range: float = 0.02
    pad_token_id: int = 0
    embedding_size: Optional[int] = None
    position_biased_input: bool = True
    relative_attention: bool = True
    position_buckets: int = 256
    max_relative_positions: int = -1             # -1: max_position_embeddings
    share_att_key: bool = True
    pos_att_type: tuple = ("c2p", "p2c")
    norm_rel_ebd: str = "layer_norm"
    conv_kernel_size: int = 0                    # 0: no ConvLayer
    conv_act: str = "tanh"
    conv_groups: int = 1
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    attention_impl: str = "xla"                  # disentangled: the plain attention only
    remat: bool = False
    remat_policy: str = "full"

    def __post_init__(self):
        if self.conv_kernel_size and self.conv_kernel_size % 2 == 0:
            raise ValueError(
                f"conv_kernel_size={self.conv_kernel_size}: flax SAME padding equals "
                "Conv1d(padding=(K-1)//2) only for an odd kernel")

    @property
    def pos_ebd_size(self) -> int:
        maxp = (self.max_relative_positions if self.max_relative_positions > 0
                else self.max_position_embeddings)
        return self.position_buckets if self.position_buckets > 0 else maxp


def deberta_config_from_hf(hf_config: dict, **overrides) -> DebertaV2Config:
    """Map an HF DebertaV2Config dict (config.json) to a DebertaV2Config;
    the hub's string ``pos_att_type`` (``"p2c|c2p"``) is split."""
    pat = hf_config.get("pos_att_type") or ()
    kw = dict(
        vocab_size=hf_config["vocab_size"],
        hidden_size=hf_config["hidden_size"],
        num_layers=hf_config["num_hidden_layers"],
        num_heads=hf_config["num_attention_heads"],
        intermediate_size=hf_config["intermediate_size"],
        max_position_embeddings=hf_config["max_position_embeddings"],
        type_vocab_size=hf_config.get("type_vocab_size", 0),
        hidden_act=hf_config.get("hidden_act", "gelu"),
        layer_norm_eps=hf_config.get("layer_norm_eps", 1e-7),
        hidden_dropout=hf_config.get("hidden_dropout_prob", 0.1),
        attention_dropout=hf_config.get("attention_probs_dropout_prob", 0.1),
        pooler_dropout=hf_config.get("pooler_dropout", 0.0),
        pooler_hidden_act=hf_config.get("pooler_hidden_act", "gelu"),
        classifier_dropout=hf_config.get("cls_dropout"),
        initializer_range=hf_config.get("initializer_range", 0.02),
        pad_token_id=hf_config.get("pad_token_id", 0),
        embedding_size=hf_config.get("embedding_size"),
        position_biased_input=hf_config.get("position_biased_input", True),
        relative_attention=hf_config.get("relative_attention", False),
        position_buckets=hf_config.get("position_buckets", -1),
        max_relative_positions=hf_config.get("max_relative_positions", -1),
        share_att_key=hf_config.get("share_att_key", False),
        pos_att_type=(tuple(x.strip() for x in pat.split("|")) if isinstance(pat, str)
                      else tuple(pat)),
        norm_rel_ebd=hf_config.get("norm_rel_ebd", "none"),
        conv_kernel_size=hf_config.get("conv_kernel_size", 0) or 0,
        conv_act=hf_config.get("conv_act", "tanh"),
        conv_groups=hf_config.get("conv_groups", 1),
    )
    kw.update(overrides)
    kw.pop("use_pooler", None)
    return DebertaV2Config(**kw)


def deberta_config_to_hf(c: DebertaV2Config) -> dict:
    """The ``config.json`` the JAX package exports for a DeBERTa-v2."""
    return {
        "model_type": "deberta-v2",
        "architectures": ["DebertaV2ForSequenceClassification"],
        "vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
        "num_hidden_layers": c.num_layers, "num_attention_heads": c.num_heads,
        "intermediate_size": c.intermediate_size,
        "max_position_embeddings": c.max_position_embeddings,
        "type_vocab_size": c.type_vocab_size, "hidden_act": c.hidden_act,
        "layer_norm_eps": c.layer_norm_eps,
        "hidden_dropout_prob": c.hidden_dropout,
        "attention_probs_dropout_prob": c.attention_dropout,
        "pooler_dropout": c.pooler_dropout,
        "pooler_hidden_act": c.pooler_hidden_act,
        "pooler_hidden_size": c.hidden_size,
        "pad_token_id": c.pad_token_id,
        "initializer_range": c.initializer_range,
        "embedding_size": c.embedding_size or c.hidden_size,
        "position_biased_input": c.position_biased_input,
        "relative_attention": c.relative_attention,
        "position_buckets": c.position_buckets,
        "max_relative_positions": c.max_relative_positions,
        "share_att_key": c.share_att_key,
        "pos_att_type": list(c.pos_att_type),
        "norm_rel_ebd": c.norm_rel_ebd,
        **({"conv_kernel_size": c.conv_kernel_size, "conv_act": c.conv_act,
            "conv_groups": c.conv_groups} if c.conv_kernel_size else {}),
    }


def make_log_bucket_position(rel: torch.Tensor, bucket_size: int,
                             max_position: int) -> torch.Tensor:
    """HF ``make_log_bucket_position`` as the JAX package computes it, in
    fp32 with ``ceil``: linear within ±bucket/2, log-spaced beyond."""
    sign = torch.sign(rel)
    mid = bucket_size // 2
    abs_pos = torch.where((rel < mid) & (rel > -mid), torch.full_like(rel, mid - 1),
                          rel.abs()).float()
    log_pos = torch.ceil(torch.log(abs_pos / mid)
                         / torch.tensor(math.log((max_position - 1) / mid), dtype=torch.float32)
                         * (mid - 1)) + mid
    return torch.where(abs_pos <= mid, rel.float(), log_pos * sign).to(torch.int32)


def build_relative_position(q_len: int, k_len: int, bucket_size: int, max_position: int,
                            device=None) -> torch.Tensor:
    """``[q_len, k_len]`` int32 relative positions ``q - k`` (bucketed when
    enabled)."""
    rel = (torch.arange(q_len, device=device)[:, None]
           - torch.arange(k_len, device=device)[None, :])
    if bucket_size > 0 and max_position > 0:
        rel = make_log_bucket_position(rel, bucket_size, max_position)
    return rel.to(torch.int32)


class DisentangledSelfAttention(nn.Module):
    """HF ``DisentangledSelfAttention`` (self-attention form)."""

    def __init__(self, cfg: DebertaV2Config):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.query = Dense(cfg, h, h)
        self.key = Dense(cfg, h, h)
        self.value = Dense(cfg, h, h)
        if cfg.relative_attention and cfg.pos_att_type and not cfg.share_att_key:
            if "c2p" in cfg.pos_att_type:
                self.pos_key = Dense(cfg, h, h)
            if "p2c" in cfg.pos_att_type:
                self.pos_query = Dense(cfg, h, h)
        self.rel_dropout = nn.Dropout(cfg.hidden_dropout)
        self.dropout = nn.Dropout(cfg.attention_dropout)

    def forward(self, hidden, qk_mask, rel_embeddings, rel_pos):
        cfg = self.cfg
        heads = cfg.num_heads
        head_dim = cfg.hidden_size // heads
        B, S, _ = hidden.shape

        def split(x, length, batch=B):
            return x.reshape(batch, length, heads, head_dim).transpose(1, 2)

        q = split(self.query(hidden), S)
        k = split(self.key(hidden), S)
        v = split(self.value(hidden), S)
        scale = math.sqrt(head_dim * (1 + len(cfg.pos_att_type)))
        scores = torch.matmul(q, k.transpose(-1, -2)).float() / scale
        if cfg.relative_attention and cfg.pos_att_type:
            span = cfg.pos_ebd_size
            rel = self.rel_dropout(rel_embeddings)[: span * 2][None]      # [1, 2s, H]
            idx_shape = (B, heads, S, S)
            if "c2p" in cfg.pos_att_type:
                pk = split(self.key(rel) if cfg.share_att_key else self.pos_key(rel),
                           2 * span, 1)                                   # [1, h, 2s, d]
                c2p = torch.matmul(q, pk.transpose(-1, -2)).float()      # [B, h, S, 2s]
                idx = torch.clamp(rel_pos + span, 0, span * 2 - 1).long()
                c2p = torch.gather(c2p, -1, idx[None, None].expand(idx_shape))
                scores = scores + c2p / scale
            if "p2c" in cfg.pos_att_type:
                pq = split(self.query(rel) if cfg.share_att_key else self.pos_query(rel),
                           2 * span, 1)
                p2c = torch.matmul(k, pq.transpose(-1, -2)).float()      # [B, h, S(k), 2s]
                idx = torch.clamp(-rel_pos + span, 0, span * 2 - 1).long()
                p2c = torch.gather(p2c, -1, idx[None, None].expand(idx_shape))
                scores = scores + p2c.transpose(-1, -2) / scale
        scores = scores.masked_fill(~qk_mask, NEG_INF)
        probs = self.dropout(torch.softmax(scores, dim=-1).to(v.dtype))
        ctx = torch.matmul(probs, v)
        return ctx.transpose(1, 2).reshape(B, S, heads * head_dim)


class DebertaLayer(nn.Module):
    """Post-LN layer: disentangled attention + FFN (HF DebertaV2Layer)."""

    def __init__(self, cfg: DebertaV2Config):
        super().__init__()
        h = cfg.hidden_size
        self.attention = DisentangledSelfAttention(cfg)
        self.attention_out = Dense(cfg, h, h)
        self.attention_ln = LayerNorm(cfg, h)
        self.intermediate = Dense(cfg, h, cfg.intermediate_size)
        self.ffn_out = Dense(cfg, cfg.intermediate_size, h)
        self.ffn_ln = LayerNorm(cfg, h)
        self.act = ACT2FN[cfg.hidden_act]
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, hidden, qk_mask, rel_embeddings, rel_pos):
        attn = self.attention(hidden, qk_mask, rel_embeddings, rel_pos)
        hidden = self.attention_ln(hidden + self.dropout(self.attention_out(attn)))
        x = self.dropout(self.ffn_out(self.act(self.intermediate(hidden))))
        return self.ffn_ln(hidden + x)


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` in ``param_dtype`` computing in ``dtype``, its kernel
    merged with its LoRA adapters when they are attached (``lora``)."""

    lora = None

    def __init__(self, cfg: DebertaV2Config, channels: int, kernel: int, groups: int):
        super().__init__(channels, channels, kernel, padding=(kernel - 1) // 2,
                         groups=groups, dtype=cfg.param_dtype)
        self.compute_dtype = cfg.dtype

    def forward(self, x):
        weight = self.weight
        if self.lora is not None:
            a, b, scaling = self.lora
            weight = lora_delta(a, b, weight, scaling)
        dt = self.compute_dtype
        return F.conv1d(x.to(dt), weight.to(dt), self.bias.to(dt), padding=self.padding,
                        groups=self.groups)


class DebertaConv(nn.Module):
    """HF ``ConvLayer``: a conv over the tokens merged into the first
    layer's output through a layer-norm residual."""

    def __init__(self, cfg: DebertaV2Config):
        super().__init__()
        self.conv = Conv1d(cfg, cfg.hidden_size, cfg.conv_kernel_size, cfg.conv_groups)
        self.conv_ln = LayerNorm(cfg, cfg.hidden_size)
        self.act = ACT2FN[cfg.conv_act]
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, initial, layer0_out, input_mask):
        m = input_mask[..., None]
        conv = self.conv(initial.transpose(1, 2)).transpose(1, 2)
        conv = self.act(self.dropout(conv * m.to(conv.dtype)))
        out = self.conv_ln(layer0_out + conv)
        return out * m.to(out.dtype)


class DebertaBackbone(nn.Module):
    """Embeddings + disentangled encoder; returns the final hidden states."""

    def __init__(self, cfg: DebertaV2Config):
        super().__init__()
        self.cfg = cfg
        emb = cfg.embedding_size or cfg.hidden_size
        self.word_embeddings = Embed(cfg, cfg.vocab_size, emb)
        if cfg.position_biased_input:
            self.position_embeddings = Embed(cfg, cfg.max_position_embeddings, emb)
        if cfg.type_vocab_size > 0:
            self.token_type_embeddings = Embed(cfg, cfg.type_vocab_size, emb)
        if emb != cfg.hidden_size:
            self.embed_proj = Dense(cfg, emb, cfg.hidden_size, bias=False)
        self.embeddings_ln = LayerNorm(cfg, cfg.hidden_size)
        self.dropout = nn.Dropout(cfg.hidden_dropout)
        if cfg.relative_attention:
            self.rel_embeddings = Embed(cfg, cfg.pos_ebd_size * 2, cfg.hidden_size)
            if "layer_norm" in cfg.norm_rel_ebd:
                self.rel_ln = LayerNorm(cfg, cfg.hidden_size)
        self.layer = nn.ModuleList(DebertaLayer(cfg) for _ in range(cfg.num_layers))
        if cfg.conv_kernel_size > 0:
            self.conv = DebertaConv(cfg)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        cfg = self.cfg
        B, S = input_ids.shape
        dev = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        x = self.word_embeddings(input_ids)
        if cfg.position_biased_input:
            x = x + self.position_embeddings(torch.arange(S, device=dev)[None, :])
        if cfg.type_vocab_size > 0:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + self.token_type_embeddings(token_type_ids)
        if hasattr(self, "embed_proj"):
            x = self.embed_proj(x)
        x = self.embeddings_ln(x)
        x = self.dropout(x * attention_mask[..., None].to(x.dtype))
        rel = rel_pos = None
        if cfg.relative_attention:
            rel = self.rel_embeddings.weight.to(cfg.dtype)
            if hasattr(self, "rel_ln"):
                rel = self.rel_ln(rel)
            maxp = (cfg.max_relative_positions if cfg.max_relative_positions > 0
                    else cfg.max_position_embeddings)
            rel_pos = build_relative_position(S, S, cfg.position_buckets, maxp, device=dev)
        m = attention_mask.bool()
        qk_mask = m[:, None, None, :] & m[:, None, :, None]
        initial = x
        remat = cfg.remat and torch.is_grad_enabled()
        for i, layer in enumerate(self.layer):
            if remat:
                x = remat_call(layer, x, qk_mask, rel, rel_pos, policy=cfg.remat_policy)
            else:
                x = layer(x, qk_mask, rel, rel_pos)
            if i == 0 and hasattr(self, "conv"):
                x = self.conv(initial, x, attention_mask)
        return x


def _head_dropout(cfg: DebertaV2Config) -> float:
    return cfg.classifier_dropout if cfg.classifier_dropout is not None else cfg.hidden_dropout


class DebertaV2ForSequenceClassification(nn.Module):
    """ContextPooler (CLS, dropout, dense, activation) + classifier."""

    def __init__(self, config: DebertaV2Config, num_labels: int = 2):
        super().__init__()
        self.config = config
        self.num_labels = num_labels
        self.backbone = DebertaBackbone(config)
        self.pooler_dropout = nn.Dropout(config.pooler_dropout)
        self.pooler = Dense(config, config.hidden_size, config.hidden_size)
        self.act = ACT2FN[config.pooler_hidden_act]
        self.dropout = nn.Dropout(_head_dropout(config))
        self.classifier = Dense(config, config.hidden_size, num_labels)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        x = self.backbone(input_ids, attention_mask, token_type_ids)[:, 0]
        x = self.act(self.pooler(self.pooler_dropout(x)))
        return self.classifier(self.dropout(x))


class DebertaV2ForTokenClassification(nn.Module):
    def __init__(self, config: DebertaV2Config, num_labels: int = 9):
        super().__init__()
        self.config = config
        self.num_labels = num_labels
        self.backbone = DebertaBackbone(config)
        self.dropout = nn.Dropout(config.hidden_dropout)
        self.classifier = Dense(config, config.hidden_size, num_labels)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        seq = self.backbone(input_ids, attention_mask, token_type_ids)
        return self.classifier(self.dropout(seq))


class DebertaV2ForMaskedLM(nn.Module):
    """The legacy HF ``DebertaV2ForMaskedLM`` (BERT's ``cls.predictions``
    layout): :class:`~.layers.MlmHead` tied to the word embeddings;
    ``return_fused_inputs`` hands ``(x, table, bias)`` to the fused loss."""

    def __init__(self, config: DebertaV2Config):
        super().__init__()
        self.config = config
        self.backbone = DebertaBackbone(config)
        self.mlm_head = MlmHead(config)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                return_fused_inputs: bool = False):
        seq = self.backbone(input_ids, attention_mask, token_type_ids)
        table = self.backbone.word_embeddings.weight
        if return_fused_inputs:
            x, bias = self.mlm_head(seq, table, return_transform=True)
            return x, table, bias
        return self.mlm_head(seq, table)


class DebertaV2ForQuestionAnswering(nn.Module):
    def __init__(self, config: DebertaV2Config):
        super().__init__()
        self.config = config
        self.backbone = DebertaBackbone(config)
        self.qa_outputs = Dense(config, config.hidden_size, 2)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        logits = self.qa_outputs(self.backbone(input_ids, attention_mask, token_type_ids))
        return logits[..., 0], logits[..., 1]
