"""GPT-2 as ``nn.Module``s: the decoder-only causal LM of the JAX
package's ``models/gpt2.py`` (HF ``GPT2LMHeadModel`` architecture).

- learned token (``wte``) and position (``wpe``) embeddings, embedding
  dropout;
- pre-LN blocks: ``x + attn(ln_1(x))`` then ``x + mlp(ln_2(x))``, with
  residual dropout on the attention and MLP outputs;
- a fused qkv projection, a gelu_new MLP, a final ``ln_f``, and the LM
  head tied to ``wte``; logits are fp32. With ``weight_quant='int8'`` the
  four denses of each block are ``models/quant.py``'s ``Int8Linear``
  (built through ``make_dense``; loaded by ``quantize_for_generation``).

The dtype discipline is the JAX package's (``models/layers.py``'s
``Dense``, ``Embed`` and ``LayerNorm``): parameters in ``param_dtype``,
compute in ``dtype``, layer-norm statistics and attention softmax in fp32.
Module names follow the JAX parameter tree (``backbone/h_<i>/attention/
qkv`` becomes ``backbone.h.<i>.attention.qkv``), which is what lets
``convert.params_from_jax`` carry weights across by name.

The forward has three call forms, chosen by ``cache``:

- ``None``: the full causal forward (``attention_mask`` [B, S] marks
  padding; ``segment_ids``, a packed batch's, make it the block-diagonal
  ``[B, 1, S, S]`` mask, which the flash wrapper sends to the plain
  attention), through ``ops.attention.dot_product_attention(causal=True)``
  with ``attention_impl`` (``flash``: the CUDA kernels on the card). In
  training with ``attention_dropout > 0`` the attention is the unfused
  softmax with dropout on the probabilities instead, as in the JAX
  package (the flash kernels have no dropout hook);
- a :class:`~.kv_cache.DenseCache`: the cached chunk forward. The chunk's
  K/V is written at each row's ``cache.index``, queries attend over the
  whole buffer masked by ``attention_mask`` [B, max_len] (kv validity)
  plus the step mask ``key <= index + query offset``;
- a :class:`~.kv_cache.PagedCache`: the single-token paged decode of the
  serving engine. The new K/V is scattered into the pools and attention
  runs through ``ops.attention.paged_attention`` (the CUDA kernel on the
  card).

:meth:`Gpt2LMHeadModel.hidden_and_embedding` hands the pre-head hidden
states and the tied embedding to the fused vocab cross-entropy. With
``remat`` each block of a training forward (no cache, grad enabled) is
recomputed in backward under ``remat_policy`` (``torch.utils.checkpoint``,
the JAX package's ``nn.remat`` per block with its policy,
``models/layers.py:remat_policy``; the dropout draws are replayed, so the
step is the same bit for bit). With ``num_experts`` every
``moe_every``-th block's MLP is ``models/moe.py``'s expert bank. With
``attention_impl='ring'`` under a mesh whose ``seq`` axis is active
(``parallel/ring_attention.py``) the full forward embeds the whole row, runs
the blocks on this rank's block of tokens with ring attention, and gathers
the final hidden states back whole before the head; as in the JAX package
it refuses ``attention_dropout > 0`` in training. Pipeline stages are not
ported and raise.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch import nn

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.kv_cache import (
    DenseCache,
    PagedCache,
    local_heads,
    write_kv_cache,
    write_paged_kv,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.layers import (
    ACT2FN,
    Embed,
    LayerNorm,
    is_moe_layer,
    raise_unported,
    remat_call,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.moe import MoeFeedForward
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.quant import make_dense
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.attention import (
    dot_product_attention,
    make_attention_mask,
    make_step_mask,
    paged_attention,
    xla_attention,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.ring_attention import (
    model_seq_shard,
)

_flash_dropout_warned = False


def _warn_flash_dropout_fallback():
    """One-time warning: ``attention_impl='flash'`` with
    ``attention_dropout > 0`` in training takes the unfused softmax (the
    flash kernels have no probability-dropout hook)."""
    global _flash_dropout_warned
    if not _flash_dropout_warned:
        _flash_dropout_warned = True
        logging.getLogger(__name__).warning(
            "gpt2: attention_impl='flash' requested but attention_dropout "
            "> 0 in training has no flash hook — using the unfused O(S^2) "
            "softmax for this step. Set attention_dropout=0.0 to keep the "
            "flash kernel (HF fine-tunes commonly do).")


@dataclass(frozen=True)
class Gpt2Config:
    vocab_size: int = 50257
    max_position_embeddings: int = 1024   # HF n_positions
    hidden_size: int = 768                # n_embd
    num_layers: int = 12                  # n_layer
    num_heads: int = 12                   # n_head
    intermediate_size: int = 3072         # n_inner (4*n_embd default)
    hidden_act: str = "gelu_new"
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1           # resid_pdrop
    embd_dropout: float = 0.1             # embd_pdrop
    attention_dropout: float = 0.1        # attn_pdrop
    initializer_range: float = 0.02
    bos_token_id: int = 50256
    eos_token_id: int = 50256
    pad_token_id: int = 50256             # GPT-2 has no pad; HF uses eos
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    attention_impl: str = "xla"           # xla | flash | ring
    remat: bool = False
    remat_policy: str = "full"
    num_experts: int = 0
    expert_top_k: int = 2
    moe_every: int = 2
    expert_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0
    weight_quant: str = "none"
    kv_cache_dtype: str = "fp"            # fp | int8

    def __post_init__(self):
        if self.weight_quant not in ("none", "int8"):
            raise ValueError(f"unknown weight_quant {self.weight_quant!r} (none | int8)")
        if self.kv_cache_dtype not in ("fp", "int8"):
            raise ValueError(
                f"unknown kv_cache_dtype {self.kv_cache_dtype!r} "
                "(fp | int8)")
        if self.attention_impl not in ("xla", "flash", "ring"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r} "
                             "(xla | flash | ring)")
        raise_unported([
            (self.pipeline_stages != 0, "pipeline_stages", "11 (pipeline stages)"),
        ])
        if not (isinstance(self.dtype, torch.dtype)
                and isinstance(self.param_dtype, torch.dtype)):
            raise ValueError("dtype and param_dtype must be torch dtypes")


def gpt2_config_from_hf(hf_config: dict, **overrides) -> Gpt2Config:
    kw = dict(
        vocab_size=hf_config["vocab_size"],
        max_position_embeddings=hf_config.get("n_positions", 1024),
        hidden_size=hf_config["n_embd"],
        num_layers=hf_config["n_layer"],
        num_heads=hf_config["n_head"],
        intermediate_size=hf_config.get("n_inner") or 4 * hf_config["n_embd"],
        hidden_act=hf_config.get("activation_function", "gelu_new"),
        layer_norm_eps=hf_config.get("layer_norm_epsilon", 1e-5),
        hidden_dropout=hf_config.get("resid_pdrop", 0.1),
        embd_dropout=hf_config.get("embd_pdrop", 0.1),
        attention_dropout=hf_config.get("attn_pdrop", 0.1),
        initializer_range=hf_config.get("initializer_range", 0.02),
        bos_token_id=hf_config.get("bos_token_id", 50256),
        eos_token_id=hf_config.get("eos_token_id", 50256),
        # explicit pad id 0 is valid — only None falls back to EOS
        pad_token_id=(hf_config["pad_token_id"]
                      if hf_config.get("pad_token_id") is not None
                      else hf_config.get("eos_token_id", 50256)),
    )
    kw.update(overrides)
    kw.pop("use_pooler", None)
    return Gpt2Config(**kw)


def gpt2_config_to_hf(c: Gpt2Config) -> dict:
    """The ``config.json`` the JAX package exports for a GPT-2."""
    return {
        "model_type": "gpt2", "architectures": ["GPT2LMHeadModel"],
        "vocab_size": c.vocab_size, "n_positions": c.max_position_embeddings,
        "n_embd": c.hidden_size, "n_layer": c.num_layers,
        "n_head": c.num_heads, "n_inner": c.intermediate_size,
        "activation_function": c.hidden_act,
        "layer_norm_epsilon": c.layer_norm_eps,
        "resid_pdrop": c.hidden_dropout, "embd_pdrop": c.embd_dropout,
        "attn_pdrop": c.attention_dropout,
        "bos_token_id": c.bos_token_id, "eos_token_id": c.eos_token_id,
        "pad_token_id": c.pad_token_id,
        "initializer_range": c.initializer_range,
    }


class Gpt2Attention(nn.Module):
    """Fused-qkv causal self-attention over one of the three cache forms."""

    def __init__(self, cfg: Gpt2Config, layer: int):
        super().__init__()
        self.cfg, self.layer = cfg, layer
        H = cfg.hidden_size
        self.qkv = make_dense(cfg, H, 3 * H)
        self.attn_out = make_dense(cfg, H, H)
        self.attn_dropout = nn.Dropout(cfg.attention_dropout)
        self.resid_dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, hidden, mask, cache):
        cfg = self.cfg
        B, S, H = hidden.shape
        D = H // cfg.num_heads

        def split_heads(x):
            return x.reshape(B, S, -1, D).transpose(1, 2)

        # [q | k | v] of the heads this rank holds: all of them, or under a
        # tensor-parallel plan its head group's (parallel/sharding.py
        # permutes the fused weight so that each rank's slice is that)
        qkv = self.qkv(hidden)
        q, k, v = (split_heads(x) for x in qkv.split(qkv.shape[-1] // 3, dim=-1))
        if isinstance(cache, PagedCache):
            if S != 1:
                raise ValueError("paged decode is single-token (got q_len "
                                 f"{S})")
            write_paged_kv(cache, self.layer, k, v)
            int8 = cache.key_scale_pools is not None
            ctx = paged_attention(
                q[:, :, 0, :].contiguous(), cache.key_pools[self.layer],
                cache.value_pools[self.layer], cache.block_tables,
                cache.context_lens + 1,
                k_scale_pool=cache.key_scale_pools[self.layer] if int8 else None,
                v_scale_pool=cache.value_scale_pools[self.layer] if int8 else None)
            return self.resid_dropout(self.attn_out(ctx.to(hidden.dtype).reshape(B, 1, -1)))
        if isinstance(cache, DenseCache):
            k, v = write_kv_cache(cache, self.layer, k, v, cfg.dtype)
            ctx = xla_attention(q, k, v, mask=mask)
        elif cfg.attention_dropout > 0 and self.training:
            if cfg.attention_impl == "ring":
                # ring attention has no probability-dropout hook, and the
                # unfused softmax would attend within a sequence shard only
                raise ValueError(
                    "attention_dropout > 0 cannot combine with "
                    "attention_impl='ring' (sequence parallelism): set "
                    "attention_dropout=0.0 for sp training")
            # probability dropout: the unfused softmax, as the JAX package does
            if cfg.attention_impl == "flash":
                _warn_flash_dropout_fallback()
            ctx = dot_product_attention(q, k, v, mask=mask, impl="xla", causal=True,
                                        dropout=self.attn_dropout)
        else:
            ctx = dot_product_attention(q, k, v, mask=mask, impl=cfg.attention_impl,
                                        causal=True)
        return self.resid_dropout(self.attn_out(ctx.transpose(1, 2).reshape(B, S, -1)))


class Gpt2Mlp(nn.Module):
    def __init__(self, cfg: Gpt2Config):
        super().__init__()
        self.act = ACT2FN[cfg.hidden_act]
        self.fc_in = make_dense(cfg, cfg.hidden_size, cfg.intermediate_size)
        self.fc_out = make_dense(cfg, cfg.intermediate_size, cfg.hidden_size)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, x):
        return self.dropout(self.fc_out(self.act(self.fc_in(x))))


class Gpt2Block(nn.Module):
    """Pre-LN transformer block (GPT-2 ordering). On an MoE placement
    (``is_moe_layer``) the MLP is the token-routed expert bank with
    position-major slot priority, its ``wo`` at the residual-flow init."""

    def __init__(self, cfg: Gpt2Config, layer: int):
        super().__init__()
        self.ln_1 = LayerNorm(cfg, cfg.hidden_size)
        self.attention = Gpt2Attention(cfg, layer)
        self.ln_2 = LayerNorm(cfg, cfg.hidden_size)
        if is_moe_layer(cfg, layer):
            self.moe = MoeFeedForward(
                cfg, causal=True,
                out_init_std=cfg.initializer_range / (2 * cfg.num_layers) ** 0.5)
        else:
            self.mlp = Gpt2Mlp(cfg)

    def forward(self, hidden, mask, cache):
        hidden = hidden + self.attention(self.ln_1(hidden), mask, cache)
        mlp = self.moe if hasattr(self, "moe") else self.mlp
        return hidden + mlp(self.ln_2(hidden))


class Gpt2Model(nn.Module):
    """Embeddings, blocks and the final LN; returns the hidden states in
    the compute dtype."""

    def __init__(self, cfg: Gpt2Config):
        super().__init__()
        self.cfg = cfg
        self.wte = Embed(cfg, cfg.vocab_size, cfg.hidden_size)
        self.wpe = Embed(cfg, cfg.max_position_embeddings, cfg.hidden_size)
        self.dropout = nn.Dropout(cfg.embd_dropout)
        self.h = nn.ModuleList(Gpt2Block(cfg, i) for i in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg, cfg.hidden_size)

    def forward(self, input_ids, attention_mask=None, position_ids=None,
                cache=None, segment_ids=None):
        B, S = input_ids.shape
        dev = input_ids.device
        offsets = torch.arange(S, device=dev)[None, :]
        mask = None
        if isinstance(cache, DenseCache):
            if position_ids is None:
                position_ids = cache.index[:, None] + offsets
            # the chunk's step mask: key slot <= write index + query offset
            mask = make_step_mask(cache.index, S, cache.keys[0].shape[2])
            if attention_mask is not None:
                mask = make_attention_mask(attention_mask) + mask
        elif cache is None:
            if position_ids is None:
                position_ids = offsets
            # [B, 1, 1, S] padding, or with segment_ids (packed rows) the
            # block-diagonal [B, 1, S, S] mask; causality is the attention's
            if attention_mask is not None or segment_ids is not None:
                mask = make_attention_mask(attention_mask, segment_ids=segment_ids)
        elif position_ids is None:                   # paged decode
            position_ids = cache.context_lens.long()[:, None]
        x = self.dropout(self.wte(input_ids) + self.wpe(position_ids))
        seq = model_seq_shard(self.cfg.attention_impl) if cache is None else None
        if seq is not None:
            # this rank's tokens through the blocks, ring attention between
            x, mask = seq.local(x), seq.local_mask(mask)
        remat = self.cfg.remat and cache is None and torch.is_grad_enabled()
        for block in self.h:
            if remat:
                x = remat_call(block, x, mask, None, policy=self.cfg.remat_policy)
            else:
                x = block(x, mask, cache)
        if isinstance(cache, DenseCache):
            cache.index = cache.index + S
        x = self.ln_f(x)
        return x if seq is None else seq.gather(x)


class Gpt2LMHeadModel(nn.Module):
    """GPT-2 with the LM head tied to the token embedding; fp32 logits."""

    def __init__(self, cfg: Gpt2Config):
        super().__init__()
        self.config = cfg
        self.backbone = Gpt2Model(cfg)

    def forward(self, input_ids, attention_mask=None, position_ids=None,
                cache=None, segment_ids=None):
        hidden = self.backbone(input_ids, attention_mask, position_ids, cache,
                               segment_ids=segment_ids)
        embedding = self.backbone.wte.weight.to(self.config.dtype)
        return torch.matmul(hidden, embedding.t()).float()

    def hidden_and_embedding(self, input_ids, attention_mask=None,
                             position_ids=None, segment_ids=None):
        """``(hidden [B, S, H] in the compute dtype, tied embedding [V, H]
        in the param dtype)``: the fused vocab-CE path, which never makes
        the [B, S, V] logits. The embedding is not cast (the JAX
        ``hidden_and_embedding`` returns it as stored)."""
        return (self.backbone(input_ids, attention_mask, position_ids,
                              segment_ids=segment_ids),
                self.backbone.wte.weight)

    def new_dense_cache(self, batch: int, max_len: int,
                        index: Optional[torch.Tensor] = None) -> DenseCache:
        """Zeroed dense per-row KV buffers for every layer on the model's
        device, in the config's KV storage (this rank's heads on a model cut
        for tensor-parallel serving)."""
        cfg = self.config
        return DenseCache.empty(
            cfg.num_layers, batch, local_heads(self, cfg.num_heads), max_len,
            cfg.hidden_size // cfg.num_heads, cfg.dtype,
            self.backbone.wte.weight.device,
            int8=cfg.kv_cache_dtype == "int8", index=index)
