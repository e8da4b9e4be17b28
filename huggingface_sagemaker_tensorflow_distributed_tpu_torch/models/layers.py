"""Transformer building blocks shared by the port's models (counterpart of
the JAX package's ``models/layers.py``): the activation table and the
BERT-family encoder, with RoBERTa's mask-counted position ids
(``position_offset``), DistilBERT's missing token types
(``use_token_type=False``) and ELECTRA's factorized embeddings
(``embedding_size`` below ``hidden_size``, projected up in the backbone),
the MoE placement (:func:`is_moe_layer`: with ``num_experts`` every
``moe_every``-th layer's FFN is ``models/moe.py``'s expert bank), the
masked-LM head every family shares (:class:`MlmHead`), and the remat
policies every family's per-layer checkpoint takes (:func:`remat_policy`).

Module names mirror the flax names, so carrying weights across is a
rename (``backbone.encoder.layer.<i>.attention.query`` is flax's
``backbone/encoder/layer_<i>/attention/query``). The dtype discipline is
the JAX package's, written out rather than left to ``torch.autocast``:
parameters live in ``param_dtype``; dense and embedding layers compute in
``dtype`` with input, weight and bias cast to it; layer-norm statistics
and attention logits and softmax are fp32. As in the JAX package, encoder
attention applies no dropout to the attention probabilities.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.lora import lora_delta
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.attention import (
    dot_product_attention,
    make_attention_mask,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.ring_attention import (
    model_seq_shard,
)

ACT2FN: dict[str, Callable] = {
    "gelu": lambda x: F.gelu(x, approximate="none"),   # HF "gelu" is erf-exact
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
    "tanh": torch.tanh,
}


def raise_unported(items) -> None:
    """Raise ``NotImplementedError`` naming its ROADMAP queue 1 item for
    the first ``(hit, what, item)`` of ``items`` that is hit."""
    for hit, what, item in items:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported to the PyTorch package yet: "
                f"ROADMAP queue 1, item {item}")


# the products each remat policy saves: JAX's ``checkpoint_dots`` keeps the
# output of every ``dot_general``, ``checkpoint_dots_with_no_batch_dims``
# of those without batch dimensions. A Linear on [B, S, H] is an mm/addmm
# on the flattened rows (a dot_general without batch dims in JAX); the
# attention einsums are bmm (batched over B and H)
_SAVED_PRODUCTS = {
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default),
    "dots_no_batch": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default),
}


def remat_policy(name: str, marked: Optional[list] = None) -> Callable:
    """The ``context_fn`` of ``torch.utils.checkpoint.checkpoint(...,
    use_reentrant=False)`` for a remat policy (the JAX package's
    ``remat_policy``): ``full`` saves nothing (the classic checkpoint);
    ``dots`` saves the output of every matrix product (``mm``, ``addmm``,
    ``bmm``, ``baddbmm``) and ``dots_no_batch`` of those without a batch
    dimension (``mm``, ``addmm``), through selective activation
    checkpointing; everything else is recomputed in backward. The recompute
    replays the forward's dropout draws (the checkpoint restores the
    generators' state first, and no saved op draws). A kernel launched
    through ``ctypes`` inside an ``autograd.Function`` (K1) is no product
    the policy can see: under any policy its forward runs again in the
    recompute, as the ``pallas_call`` does under JAX's policies. With
    ``marked`` a list, each product the forward marks is appended to it."""
    if name == "full":
        return noop_context_fn
    if name not in _SAVED_PRODUCTS:
        raise ValueError(f"unknown remat_policy {name!r} (full | dots | dots_no_batch)")
    saved = _SAVED_PRODUCTS[name]

    def policy(ctx, op, *args, **kwargs):
        if op in saved:
            if marked is not None and not ctx.is_recompute:
                marked.append(op)
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


def remat_call(fn, *args, policy: str = "full"):
    """``fn(*args)`` under ``torch.utils.checkpoint`` with the remat
    ``policy`` (:func:`remat_policy`)."""
    return checkpoint(fn, *args, use_reentrant=False, context_fn=remat_policy(policy))


@dataclass(frozen=True)
class EncoderConfig:
    """Architecture hyperparameters shared by the BERT-family encoders
    (the JAX package's fields). What the port does not run yet raises
    ``NotImplementedError`` at construction. With ``remat`` each layer is
    recomputed in backward under ``remat_policy`` (:func:`remat_policy`)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    embedding_size: Optional[int] = None
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    classifier_dropout: Optional[float] = None
    pad_token_id: int = 0
    position_offset: int = 0
    use_token_type: bool = True
    use_pooler: bool = True
    initializer_range: float = 0.02
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    attention_impl: str = "xla"        # xla | flash | ring
    remat: bool = False                # torch.utils.checkpoint per layer
    remat_policy: str = "full"
    num_experts: int = 0
    expert_top_k: int = 2
    expert_capacity_factor: float = 1.25
    moe_every: int = 2
    router_aux_coef: float = 0.01
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0
    # recompute the plain attention core in backward instead of keeping
    # its fp32 [B, H, S, S] softmax; no effect on the flash path, which
    # keeps no such residual
    remat_attention: bool = True

    def __post_init__(self):
        if self.attention_impl not in ("xla", "flash", "ring"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        raise_unported([(self.pipeline_stages > 0, "pipeline_stages>0", "11")])


class Dense(nn.Linear):
    """``nn.Linear`` with the weight in ``param_dtype`` that computes in
    ``dtype`` (flax ``nn.Dense(dtype=..., param_dtype=...)``); T5's
    projections take ``bias=False``. With LoRA adapters attached
    (``models/lora.py``: ``lora`` holds ``(A, B, scaling)``) it computes
    with the merged weight."""

    lora = None

    def __init__(self, cfg: EncoderConfig, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias=bias, dtype=cfg.param_dtype)
        self.compute_dtype = cfg.dtype

    def effective_weight(self):
        """The weight this layer computes with: the merged one under LoRA."""
        if self.lora is None:
            return self.weight
        a, b, scaling = self.lora
        return lora_delta(a, b, self.weight, scaling)

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.effective_weight().to(dt), bias)


class Embed(nn.Embedding):
    """Embedding table in ``param_dtype``, rows returned in ``dtype``."""

    def __init__(self, cfg: EncoderConfig, num: int, dim: int):
        super().__init__(num, dim, dtype=cfg.param_dtype)
        self.compute_dtype = cfg.dtype

    def forward(self, ids):
        return F.embedding(ids, self.weight).to(self.compute_dtype)


class LayerNorm(nn.Module):
    """Layer norm with fp32 statistics, output in ``dtype`` (flax
    ``nn.LayerNorm(dtype=...)``); ``weight`` is flax's ``scale``; ``eps``
    defaults to the config's ``layer_norm_eps``."""

    def __init__(self, cfg: EncoderConfig, dim: int, eps: Optional[float] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=cfg.param_dtype))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=cfg.param_dtype))
        self.eps = cfg.layer_norm_eps if eps is None else eps
        self.compute_dtype = cfg.dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


class Embeddings(nn.Module):
    """Word + learned-position (+ token-type) embeddings at
    ``embedding_size`` (``hidden_size`` when unset), layer norm, dropout.

    With ``position_offset`` and a mask, positions count the mask's ones
    from ``position_offset`` and pads take ``pad_token_id`` (the JAX
    package's RoBERTa rule: the mask decides, not ``input_ids != pad``);
    without a mask they run from ``position_offset``."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        emb = cfg.embedding_size or cfg.hidden_size
        self.word_embeddings = Embed(cfg, cfg.vocab_size, emb)
        self.position_embeddings = Embed(cfg, cfg.max_position_embeddings, emb)
        if cfg.use_token_type:
            self.token_type_embeddings = Embed(cfg, cfg.type_vocab_size, emb)
        self.embeddings_ln = LayerNorm(cfg, emb)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        cfg = self.cfg
        if position_ids is None:
            if cfg.position_offset and attention_mask is not None:
                mask = attention_mask.long()
                position_ids = torch.cumsum(mask, dim=-1) * mask + cfg.position_offset - 1
                position_ids = position_ids * mask + cfg.pad_token_id * (1 - mask)
            else:
                seq = input_ids.shape[-1]
                position_ids = torch.arange(cfg.position_offset, seq + cfg.position_offset,
                                            device=input_ids.device)[None, :]
        x = self.word_embeddings(input_ids) + self.position_embeddings(position_ids)
        if cfg.use_token_type:
            if token_type_ids is None or cfg.type_vocab_size == 1:
                # one token type (RoBERTa): every token takes its row, as the
                # JAX package's clamping lookup gives any type id
                token_type_ids = torch.zeros_like(input_ids)
            x = x + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.embeddings_ln(x))


class SelfAttention(nn.Module):
    """Multi-head self-attention (the post-LN residual is the caller's)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.query = Dense(cfg, h, h)
        self.key = Dense(cfg, h, h)
        self.value = Dense(cfg, h, h)
        self.attention_out = Dense(cfg, h, h)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, hidden, attn_mask=None):
        cfg = self.cfg
        b, s, _ = hidden.shape
        head_dim = cfg.hidden_size // cfg.num_heads

        def split(x):
            # the heads this rank holds: all of them, or H / tp under a
            # tensor-parallel plan (parallel/sharding.py)
            return x.view(b, s, -1, head_dim).transpose(1, 2)

        q, k, v = split(self.query(hidden)), split(self.key(hidden)), split(self.value(hidden))
        if (cfg.remat_attention and cfg.attention_impl == "xla"
                and torch.is_grad_enabled() and hidden.requires_grad):
            ctx = checkpoint(dot_product_attention, q, k, v, attn_mask, None, "xla",
                             use_reentrant=False)
        else:
            ctx = dot_product_attention(q, k, v, mask=attn_mask, impl=cfg.attention_impl)
        ctx = ctx.transpose(1, 2).reshape(b, s, -1)
        return self.dropout(self.attention_out(ctx))


class FeedForward(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.intermediate = Dense(cfg, cfg.hidden_size, cfg.intermediate_size)
        self.ffn_out = Dense(cfg, cfg.intermediate_size, cfg.hidden_size)
        self.act = ACT2FN[cfg.hidden_act]
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, hidden):
        return self.dropout(self.ffn_out(self.act(self.intermediate(hidden))))


class EncoderLayer(nn.Module):
    """Post-LN transformer layer (BERT ordering); ``use_moe`` swaps the
    dense FFN for the token-routed expert bank (``models/moe.py``)."""

    def __init__(self, cfg: EncoderConfig, use_moe: bool = False):
        super().__init__()
        self.attention = SelfAttention(cfg)
        self.attention_ln = LayerNorm(cfg, cfg.hidden_size)
        if use_moe:
            from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.moe import (
                MoeFeedForward,
            )

            self.moe = MoeFeedForward(cfg)
        else:
            self.ffn = FeedForward(cfg)
        self.ffn_ln = LayerNorm(cfg, cfg.hidden_size)

    def forward(self, hidden, attn_mask=None):
        hidden = self.attention_ln(hidden + self.attention(hidden, attn_mask))
        ffn = self.moe if hasattr(self, "moe") else self.ffn
        return self.ffn_ln(hidden + ffn(hidden))


def is_moe_layer(cfg, layer_index: int) -> bool:
    """GShard placement: every ``moe_every``-th layer, starting with the
    ``moe_every``-th (index 1 when ``moe_every=2``)."""
    return (cfg.num_experts > 0
            and layer_index % cfg.moe_every == cfg.moe_every - 1)


class Encoder(nn.Module):
    """Stack of encoder layers; ``remat`` recomputes each layer in
    backward (``torch.utils.checkpoint`` under ``remat_policy``)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.layer = nn.ModuleList(EncoderLayer(cfg, use_moe=is_moe_layer(cfg, i))
                                   for i in range(cfg.num_layers))

    def forward(self, hidden, attn_mask=None):
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self.layer:
            if remat:
                hidden = remat_call(layer, hidden, attn_mask, policy=self.cfg.remat_policy)
            else:
                hidden = layer(hidden, attn_mask)
        return hidden


class Pooler(nn.Module):
    """CLS-token pooler (tanh dense), as in HF BERT."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.pooler = Dense(cfg, cfg.hidden_size, cfg.hidden_size)

    def forward(self, hidden):
        return torch.tanh(self.pooler(hidden[:, 0]))


class MlmHead(nn.Module):
    """Masked-LM prediction head: ``transform`` dense to the embedding
    table's width, the activation (``act`` overrides the config's: ELECTRA's
    generator is always exact GeLU), layer norm, then a decoder tied to the
    word-embedding table the family model passes in, plus an fp32 output
    ``bias [V]`` (HF ``BertLMPredictionHead``, ``RobertaLMHead``,
    DistilBERT's ``vocab_transform``/``vocab_projector``, ``AlbertMLMHead``,
    ELECTRA's generator head). The logits come out fp32, computed in
    ``dtype`` as in the JAX package."""

    def __init__(self, cfg: EncoderConfig, act: Optional[str] = None):
        super().__init__()
        width = cfg.embedding_size or cfg.hidden_size
        self.transform = Dense(cfg, cfg.hidden_size, width)
        self.act = ACT2FN[act or cfg.hidden_act]
        self.ln = LayerNorm(cfg, width)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size, dtype=cfg.param_dtype))
        self.compute_dtype = cfg.dtype

    def forward(self, hidden, embedding_table, return_transform: bool = False):
        """``[B, S, V]`` fp32 logits; with ``return_transform`` the
        post-transform activations ``[B, S, E]`` and the bias instead, for
        the fused loss that never makes the logits."""
        x = self.ln(self.act(self.transform(hidden)))
        if return_transform:
            return x, self.bias
        dt = self.compute_dtype
        logits = torch.matmul(x, embedding_table.to(dt).t())
        return (logits + self.bias.to(dt)).float()


def head_dropout_rate(cfg: EncoderConfig) -> float:
    """Dropout rate of a task head: ``classifier_dropout``, falling back to
    ``hidden_dropout`` (HF semantics; ALBERT's heads read it)."""
    return cfg.classifier_dropout if cfg.classifier_dropout is not None else cfg.hidden_dropout


class EncoderBackbone(nn.Module):
    """Embeddings (+ ELECTRA's ``embeddings_project`` when
    ``embedding_size`` differs from ``hidden_size``) + encoder (+ pooler):
    the shared trunk for all heads. Returns ``(sequence_output, pooled or
    None)``.

    With ``attention_impl='ring'`` under a mesh whose ``seq`` axis is
    active (``parallel/ring_attention.py``) the positions, the mask and the
    embeddings are made on the whole row, the encoder runs on this rank's
    block of tokens, and its output is gathered back whole before the
    pooler and every head."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        if cfg.embedding_size and cfg.embedding_size != cfg.hidden_size:
            self.embeddings_project = Dense(cfg, cfg.embedding_size, cfg.hidden_size)
        self.encoder = Encoder(cfg)
        if cfg.use_pooler:
            self.pooler = Pooler(cfg)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, segment_ids=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        additive_mask = make_attention_mask(attention_mask, segment_ids=segment_ids)
        x = self.embeddings(input_ids, token_type_ids, position_ids, attention_mask)
        if hasattr(self, "embeddings_project"):
            x = self.embeddings_project(x)
        seq = model_seq_shard(self.cfg.attention_impl)
        if seq is None:
            x = self.encoder(x, additive_mask)
        else:
            x = seq.gather(self.encoder(seq.local(x), seq.local_mask(additive_mask)))
        pooled = self.pooler(x) if self.cfg.use_pooler else None
        return x, pooled
