"""The Llama family as ``nn.Module``s (counterpart of the JAX package's
``models/llama.py``): Llama 1/2/3/3.1 with RoPE scaling, Mistral's
sliding window, Qwen2's q/k/v biases and per-layer window start, Gemma's
head width, unit-offset norm and embedding scale, and Mixtral's expert
bank (``models/moe.py``).

- token embeddings only (positions live in RoPE), no dropout; pre-norm
  blocks ``x + attn(rms(x))`` then ``x + mlp(rms(x))``; RoPE in HF's
  rotate-half layout on q and k after the head split;
- grouped-query attention: ``num_kv_heads`` K/V heads, cached before the
  repeat (the serving engine's pools hold ``num_kv_heads``; the paged
  kernel groups the queries per K/V head), repeated to the query heads
  for the full forward's attention (``flash``: the CUDA kernels on the
  card; the dense cache's plain attention);
- the SwiGLU MLP ``down(act(gate(x)) * up(x))``, bias-free; RMSNorm with
  fp32 statistics and the weight applied after the cast (Gemma: ``1 + w``
  in fp32 before it); an untied ``lm_head`` or the tied embedding, fp32
  logits.

The forward has the three call forms of ``models/gpt2.py``, chosen by
``cache``: ``None`` (the full causal forward; the window goes through the
attention kernel's band on default positions, through a banded
``[B, 1, S, S]`` mask from the positions otherwise), a
:class:`~.kv_cache.DenseCache` (the cached chunk forward; the window is
counted in logical positions, the cumulative sum of ``attention_mask``,
so padded prompts window right) and a :class:`~.kv_cache.PagedCache`
(the serving engine's single-token decode through
``ops.attention.paged_attention`` with the window: K3 on the card, which
bands in slots; serve contexts are contiguous, so slots are positions).

Module names follow the JAX parameter tree (``backbone/layers_<i>/
self_attn/q_proj`` is ``backbone.layers.<i>.self_attn.q_proj``), so
``convert.params_from_jax`` carries weights across. With
``attention_impl='ring'`` under a mesh whose ``seq`` axis is active
(``parallel/ring_attention.py``) the full forward makes the positions, masks
and embeddings on the whole row, runs the blocks on this rank's block of
tokens (its RoPE rows, its queries' rows of a banded mask) with ring
attention, the K/V heads travelling un-repeated, and gathers the final
hidden states back whole before the head; the window then goes through the
banded mask (the ring has no band), which takes the gathered route.
Pipeline stages are not ported and raise.
"""

from __future__ import annotations

import math
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
    Dense,
    Embed,
    is_moe_layer,
    raise_unported,
    remat_call,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.moe import MixtralMoeBlock
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.quant import make_dense
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.attention import (
    NEG,
    dot_product_attention,
    make_attention_mask,
    make_step_mask,
    paged_attention,
    xla_attention,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.ring_attention import (
    model_seq_shard,
)

_ARCHITECTURES = {"llama": "LlamaForCausalLM", "mistral": "MistralForCausalLM",
                  "qwen2": "Qwen2ForCausalLM", "gemma": "GemmaForCausalLM",
                  "mixtral": "MixtralForCausalLM"}


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32                   # num_hidden_layers
    num_heads: int = 32                    # num_attention_heads
    num_kv_heads: int = 32                 # num_key_value_heads (GQA)
    intermediate_size: int = 11008
    max_position_embeddings: int = 2048
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    hidden_act: str = "silu"
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: int = 0
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    attention_impl: str = "xla"            # xla | flash | ring
    remat: bool = False
    remat_policy: str = "full"
    weight_quant: str = "none"             # none | int8
    # Mistral: attend to the last N key positions (None: full causal)
    sliding_window: Optional[int] = None
    # the first layer the window applies to (Qwen2's max_window_layers)
    sliding_window_start_layer: int = 0
    qkv_bias: bool = False                 # Qwen2
    head_dim: Optional[int] = None         # Gemma: independent of hidden/heads
    rms_unit_offset: bool = False          # Gemma: (1 + w) in fp32
    embed_scale: bool = False              # Gemma: embeddings * sqrt(hidden)
    # HF rope_scaling as a sorted item tuple (hashable); rope types
    # "llama3" (NTK-by-parts) and "linear"
    rope_scaling: Optional[tuple] = None
    kv_cache_dtype: str = "fp"             # fp | int8
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0
    # Mixtral: every moe_every-th block's MLP is the SwiGLU expert bank
    num_experts: int = 0                   # num_local_experts
    expert_top_k: int = 2                  # num_experts_per_tok
    moe_every: int = 1
    expert_capacity_factor: float = 1.25
    router_aux_coef: float = 0.02          # router_aux_loss_coef
    # the HF model_type this config round-trips as
    model_type: str = "llama"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def rope_scaling_dict(self) -> Optional[dict]:
        return dict(self.rope_scaling) if self.rope_scaling else None

    def __post_init__(self):
        if self.kv_cache_dtype not in ("fp", "int8"):
            raise ValueError(f"unknown kv_cache_dtype {self.kv_cache_dtype!r} "
                             "(fp | int8)")
        if self.weight_quant not in ("none", "int8"):
            raise ValueError(f"unknown weight_quant {self.weight_quant!r} (none | int8)")
        if self.attention_impl not in ("xla", "flash", "ring"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r} "
                             "(xla | flash | ring)")
        if not (isinstance(self.dtype, torch.dtype)
                and isinstance(self.param_dtype, torch.dtype)):
            raise ValueError("dtype and param_dtype must be torch dtypes")
        if self.num_experts and self.model_type != "mixtral":
            # only HF Mixtral's layout carries the expert bank: the
            # layout-compatible variants export as Mixtral, the others
            # cannot
            if self.model_type in ("llama", "mistral"):
                object.__setattr__(self, "model_type", "mixtral")
            else:
                raise ValueError(
                    f"num_experts > 0 is not supported for model_type "
                    f"{self.model_type!r}: the MoE export layout is HF "
                    "Mixtral's, which cannot express qkv biases / Gemma "
                    "norm semantics — upcycle a llama or mistral "
                    "checkpoint")
        if self.pipeline_stages > 0 and self.attention_impl == "ring":
            raise ValueError(
                "pipeline_stages cannot combine with attention_impl="
                "'ring' (sequence parallelism): scale long sequences "
                "with sp OR pipeline with pp, not both")
        raise_unported([
            (self.pipeline_stages > 0, "pipeline_stages>0", "11 (pipeline stages)"),
        ])


def llama_config_from_hf(hf_config: dict, **overrides) -> LlamaConfig:
    """The JAX ``llama_config_from_hf``: rope types default, linear and
    llama3 (their keys required), biased projections refused, Qwen2's
    hardcoded q/k/v biases and per-layer window, Gemma's defaults,
    Mixtral's expert fields (a missing aux coefficient is HF's 0.001)."""
    scaling = hf_config.get("rope_scaling")
    rope_scaling = None
    if scaling:
        rope_type = scaling.get("rope_type", scaling.get("type"))
        if rope_type == "default":
            pass
        elif rope_type in ("linear", "llama3"):
            required = (("factor",) if rope_type == "linear" else
                        ("factor", "low_freq_factor", "high_freq_factor",
                         "original_max_position_embeddings"))
            missing = [k for k in required if k not in scaling]
            if missing:
                raise ValueError(
                    f"rope_scaling type {rope_type!r} is missing required "
                    f"keys {missing}: {scaling!r}")
            rope_scaling = tuple(sorted(scaling.items()))
        else:
            raise ValueError(
                f"rope_scaling type {rope_type!r} is not implemented "
                "(supported: default, linear, llama3 — the Llama-3.1+ "
                f"long-context scaling): {scaling!r}")
    mt = hf_config.get("model_type", "llama")
    window_start = 0
    extra = {}
    if mt == "gemma":
        extra = dict(rms_unit_offset=True, embed_scale=True)
    if mt == "qwen2":
        qkv_bias = True
        if hf_config.get("use_sliding_window"):
            window = hf_config.get("sliding_window")
            window_start = hf_config.get("max_window_layers", 28)
        else:
            window = None
    else:
        qkv_bias = False
        window = (hf_config.get("sliding_window")
                  if mt in ("mistral", "mixtral") else None)
    if mt == "mixtral":
        extra = dict(
            num_experts=hf_config["num_local_experts"],
            expert_top_k=hf_config.get("num_experts_per_tok", 2),
            moe_every=hf_config.get("moe_every", 1),
            router_aux_coef=hf_config.get("router_aux_loss_coef", 0.001),
            expert_capacity_factor=hf_config.get("expert_capacity_factor", 1.25))
    if hf_config.get("attention_bias") or hf_config.get("mlp_bias"):
        raise ValueError(
            "attention_bias/mlp_bias=true (biased projections under "
            f"model_type {mt!r}) is not supported: the modules are "
            "bias-free (Qwen2's hardcoded q/k/v biases ARE supported "
            "via model_type 'qwen2') and the checkpoint's biases would "
            "be silently dropped")
    kw = dict(
        model_type=mt, sliding_window=window, qkv_bias=qkv_bias,
        sliding_window_start_layer=window_start, rope_scaling=rope_scaling,
        **extra,
        vocab_size=hf_config["vocab_size"],
        hidden_size=hf_config["hidden_size"],
        num_layers=hf_config["num_hidden_layers"],
        num_heads=hf_config["num_attention_heads"],
        num_kv_heads=hf_config.get("num_key_value_heads",
                                   hf_config["num_attention_heads"]),
        intermediate_size=hf_config["intermediate_size"],
        max_position_embeddings=hf_config.get("max_position_embeddings", 2048),
        rope_theta=hf_config.get("rope_theta", 10000.0),
        rms_norm_eps=hf_config.get("rms_norm_eps", 1e-5),
        # Gemma's MLP takes gelu_pytorch_tanh when hidden_activation is
        # absent or null
        hidden_act=(hf_config.get("hidden_activation")
                    or ("gelu_pytorch_tanh" if mt == "gemma"
                        else hf_config.get("hidden_act", "silu"))),
        head_dim=hf_config.get("head_dim"),
        initializer_range=hf_config.get("initializer_range", 0.02),
        # Gemma's class default is tied
        tie_word_embeddings=hf_config.get("tie_word_embeddings", mt == "gemma"),
        bos_token_id=hf_config.get("bos_token_id", 1),
        eos_token_id=hf_config.get("eos_token_id", 2),
        pad_token_id=(hf_config["pad_token_id"]
                      if hf_config.get("pad_token_id") is not None
                      else hf_config.get("eos_token_id", 2)),
    )
    kw.update(overrides)
    kw.pop("use_pooler", None)
    return LlamaConfig(**kw)


def llama_config_to_hf(c: LlamaConfig) -> dict:
    """The ``config.json`` the JAX package exports for a Llama-family
    config (its ``model_type``'s HF class and fields)."""
    return {
        "model_type": c.model_type,
        "architectures": [_ARCHITECTURES[c.model_type]],
        "vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
        "num_hidden_layers": c.num_layers,
        "num_attention_heads": c.num_heads,
        "num_key_value_heads": c.num_kv_heads,
        "intermediate_size": c.intermediate_size,
        "max_position_embeddings": c.max_position_embeddings,
        "rope_theta": c.rope_theta, "rms_norm_eps": c.rms_norm_eps,
        "hidden_act": c.hidden_act,
        "tie_word_embeddings": c.tie_word_embeddings,
        "bos_token_id": c.bos_token_id, "eos_token_id": c.eos_token_id,
        "pad_token_id": c.pad_token_id,
        "initializer_range": c.initializer_range,
        **({"sliding_window": c.sliding_window} if c.model_type == "mistral" else {}),
        **({"sliding_window": c.sliding_window,
            "num_local_experts": c.num_experts,
            "num_experts_per_tok": c.expert_top_k,
            "router_aux_loss_coef": c.router_aux_coef,
            "moe_every": c.moe_every,
            "expert_capacity_factor": c.expert_capacity_factor}
           if c.model_type == "mixtral" else {}),
        **({"sliding_window": c.sliding_window or 4096,
            "use_sliding_window": c.sliding_window is not None,
            "max_window_layers": c.sliding_window_start_layer}
           if c.model_type == "qwen2" else {}),
        **({"head_dim": c.resolved_head_dim, "hidden_activation": c.hidden_act}
           if c.model_type == "gemma" else {}),
        **({"rope_scaling": c.rope_scaling_dict} if c.rope_scaling else {}),
        **({"head_dim": c.head_dim} if c.head_dim is not None
           and c.model_type != "gemma" else {}),
    }


class LlamaRMSNorm(nn.Module):
    """HF ``LlamaRMSNorm``: fp32 mean-square, the weight multiplied after
    the cast to the compute dtype; Gemma's ``(1 + w)`` in fp32 before it.
    ``weight`` is the JAX ``scale``."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        init = torch.zeros if cfg.rms_unit_offset else torch.ones
        self.weight = nn.Parameter(init(cfg.hidden_size, dtype=cfg.param_dtype))
        self.cfg = cfg

    def forward(self, x):
        cfg = self.cfg
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + cfg.rms_norm_eps)
        if cfg.rms_unit_offset:
            return (x32 * (1.0 + self.weight.float())).to(cfg.dtype)
        return x32.to(cfg.dtype) * self.weight.to(cfg.dtype)


def _scaled_inv_freq(inv_freq, scaling: Optional[dict]):
    """HF rope_scaling on the base inverse frequencies: ``linear`` divides
    by the factor; ``llama3`` interpolates the wavelengths past the
    original context by the factor, keeps the short ones, and blends the
    band between ``low_freq_factor`` and ``high_freq_factor``."""
    if not scaling:
        return inv_freq
    rope_type = scaling.get("rope_type", scaling.get("type"))
    factor = scaling["factor"]
    if rope_type == "linear":
        return inv_freq / factor
    low_f, high_f = scaling["low_freq_factor"], scaling["high_freq_factor"]
    old_len = scaling["original_max_position_embeddings"]
    wavelen = 2.0 * math.pi / inv_freq
    scaled = torch.where(wavelen > old_len / low_f, inv_freq / factor, inv_freq)
    smooth = (old_len / wavelen - low_f) / (high_f - low_f)
    smoothed = (1.0 - smooth) * scaled / factor + smooth * scaled
    mid = (wavelen >= old_len / high_f) & (wavelen <= old_len / low_f)
    return torch.where(mid, smoothed, scaled)


def rope_tables(position_ids, head_dim: int, theta: float,
                scaling: Optional[dict] = None):
    """``(cos, sin)`` ``[B, 1, S, D]`` fp32 in HF's duplicated-half layout,
    computed once a forward from the positions."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                              device=position_ids.device) / head_dim))
    inv_freq = _scaled_inv_freq(inv_freq, scaling)
    angles = position_ids.float()[:, :, None] * inv_freq
    cos = torch.cat([torch.cos(angles)] * 2, dim=-1)[:, None]
    sin = torch.cat([torch.sin(angles)] * 2, dim=-1)[:, None]
    return cos, sin


def apply_rope(x, rope):
    """HF rotate-half RoPE on ``[B, H, S, D]``, in fp32, cast back."""
    cos, sin = rope
    d = x.shape[-1]
    rotated = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


class LlamaAttention(nn.Module):
    """GQA self-attention with RoPE over one of the three cache forms;
    ``use_window`` applies the config's window to this layer."""

    def __init__(self, cfg: LlamaConfig, layer: int, use_window: bool):
        super().__init__()
        self.cfg, self.layer, self.use_window = cfg, layer, use_window
        D = cfg.resolved_head_dim
        H = cfg.hidden_size
        self.q_proj = make_dense(cfg, H, cfg.num_heads * D, bias=cfg.qkv_bias)
        self.k_proj = make_dense(cfg, H, cfg.num_kv_heads * D, bias=cfg.qkv_bias)
        self.v_proj = make_dense(cfg, H, cfg.num_kv_heads * D, bias=cfg.qkv_bias)
        self.o_proj = make_dense(cfg, cfg.num_heads * D, H, bias=False)

    def forward(self, hidden, masks, rope, cache, kernel_window: bool):
        cfg = self.cfg
        B, S, _ = hidden.shape
        D = cfg.resolved_head_dim

        def split(x):
            # the heads this rank holds: all of them, or num_heads / tp and
            # num_kv_heads / tp under a tensor-parallel plan
            return x.reshape(B, S, -1, D).transpose(1, 2)

        q = apply_rope(split(self.q_proj(hidden)), rope)
        k = apply_rope(split(self.k_proj(hidden)), rope)
        v = split(self.v_proj(hidden))
        plain, windowed = masks
        mask = windowed if (self.use_window and windowed is not None) else plain
        if isinstance(cache, PagedCache):
            if S != 1:
                raise ValueError("paged decode is single-token (the fused kernel "
                                 f"takes one query per slot, got q_len {S})")
            write_paged_kv(cache, self.layer, k, v)
            int8 = cache.key_scale_pools is not None
            ctx = paged_attention(
                q[:, :, 0, :].contiguous(), cache.key_pools[self.layer],
                cache.value_pools[self.layer], cache.block_tables,
                cache.context_lens + 1,
                window=cfg.sliding_window if self.use_window else None,
                k_scale_pool=cache.key_scale_pools[self.layer] if int8 else None,
                v_scale_pool=cache.value_scale_pools[self.layer] if int8 else None)
            return self.o_proj(ctx.to(cfg.dtype).reshape(B, 1, -1))
        if isinstance(cache, DenseCache):
            k, v = write_kv_cache(cache, self.layer, k, v, cfg.dtype)
        ring = cfg.attention_impl == "ring" and cache is None
        if cfg.num_kv_heads != cfg.num_heads and not ring:
            # (the ring repeats the K/V heads where it uses them: they travel
            # round it un-repeated)
            rep = q.shape[1] // k.shape[1]
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        if isinstance(cache, DenseCache):
            ctx = xla_attention(q, k, v, mask=mask)          # the step mask is causality
        else:
            window = cfg.sliding_window if (self.use_window and kernel_window) else None
            ctx = dot_product_attention(q, k, v, mask=mask, impl=cfg.attention_impl,
                                        causal=True, window=window)
        return self.o_proj(ctx.transpose(1, 2).reshape(B, S, -1))


class LlamaMlp(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.act = ACT2FN[cfg.hidden_act]
        self.gate_proj = make_dense(cfg, cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.up_proj = make_dense(cfg, cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.down_proj = make_dense(cfg, cfg.intermediate_size, cfg.hidden_size, bias=False)

    def forward(self, x):
        return self.down_proj(self.act(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, layer: int):
        super().__init__()
        windowed = (cfg.sliding_window is not None
                    and layer >= cfg.sliding_window_start_layer)
        self.input_ln = LlamaRMSNorm(cfg)
        self.self_attn = LlamaAttention(cfg, layer, windowed)
        self.post_attn_ln = LlamaRMSNorm(cfg)
        if is_moe_layer(cfg, layer):
            self.moe = MixtralMoeBlock(cfg)
        else:
            self.mlp = LlamaMlp(cfg)

    def forward(self, hidden, masks, rope, cache, kernel_window: bool = False):
        hidden = hidden + self.self_attn(self.input_ln(hidden), masks, rope, cache,
                                         kernel_window)
        mlp = self.moe if hasattr(self, "moe") else self.mlp
        return hidden + mlp(self.post_attn_ln(hidden))


class LlamaModel(nn.Module):
    """Embeddings, blocks and the final RMSNorm; returns the hidden states
    in the compute dtype."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embed(cfg, cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaBlock(cfg, i) for i in range(cfg.num_layers))
        self.final_ln = LlamaRMSNorm(cfg)

    def _masks(self, attention_mask, position_ids, cache, S: int, default_positions: bool):
        """``(plain, windowed)`` additive masks for this call and whether
        the full forward's window runs through the attention's band."""
        cfg = self.cfg
        win = cfg.sliding_window
        if isinstance(cache, PagedCache):
            return (None, None), False
        if isinstance(cache, DenseCache):
            L = cache.keys[0].shape[2]
            plain = make_step_mask(cache.index, S, L)
            if attention_mask is not None:
                plain = make_attention_mask(attention_mask) + plain
            windowed = None
            if win is not None:
                # the window in logical positions: a valid slot's is its
                # rank among the valid slots, a query's its position id
                if attention_mask is not None:
                    key_logical = torch.cumsum((attention_mask > 0).long(), dim=-1) - 1
                else:
                    key_logical = torch.arange(L, device=plain.device)[None, :]
                in_win = (key_logical[:, None, None, :]
                          > position_ids[:, None, :, None] - win)
                windowed = plain + torch.where(in_win, 0.0, NEG)
            return (plain, windowed), False
        plain = make_attention_mask(attention_mask) if attention_mask is not None else None
        # the ring has no band: it takes the banded mask (the gathered route)
        kernel_window = win is not None and default_positions and cfg.attention_impl != "ring"
        windowed = None
        if win is not None and not kernel_window:
            # a band from the positions: key allowed iff 0 <= pq - pk < window
            pq = position_ids[:, None, :, None]
            pk = position_ids[:, None, None, :]
            band = torch.where((pq - pk < win) & (pq >= pk), 0.0, NEG)
            windowed = band if plain is None else plain + band
        return (plain, windowed), kernel_window

    def forward(self, input_ids, attention_mask=None, position_ids=None, cache=None):
        cfg = self.cfg
        B, S = input_ids.shape
        dev = input_ids.device
        default_positions = position_ids is None
        if position_ids is None:
            if isinstance(cache, DenseCache):
                if cfg.sliding_window is not None and attention_mask is not None:
                    raise ValueError(
                        "decode with sliding_window and an attention_mask "
                        "requires explicit position_ids (logical query "
                        "positions, e.g. mask.cumsum(-1) - 1 at each "
                        "step): defaulted buffer-slot positions would "
                        "mis-window padded prompts")
                position_ids = cache.index[:, None] + torch.arange(S, device=dev)[None, :]
            elif isinstance(cache, PagedCache):
                position_ids = cache.context_lens.long()[:, None]
            else:
                position_ids = torch.arange(S, device=dev)[None, :].expand(B, S)
        masks, kernel_window = self._masks(attention_mask, position_ids, cache, S,
                                           default_positions)
        rope = rope_tables(position_ids, cfg.resolved_head_dim, cfg.rope_theta,
                           cfg.rope_scaling_dict)
        x = self.embed_tokens(input_ids)
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype)
        seq = model_seq_shard(cfg.attention_impl) if cache is None else None
        if seq is not None:
            # this rank's tokens, their RoPE rows and mask rows or columns
            x = seq.local(x)
            rope = tuple(seq.local(t, 2) for t in rope)
            masks = tuple(seq.local_mask(m) for m in masks)
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for block in self.layers:
            if remat:
                x = remat_call(block, x, masks, rope, None, kernel_window,
                               policy=cfg.remat_policy)
            else:
                x = block(x, masks, rope, cache, kernel_window)
        if isinstance(cache, DenseCache):
            cache.index = cache.index + S
        x = self.final_ln(x)
        return x if seq is None else seq.gather(x)


class LlamaForCausalLM(nn.Module):
    """HF ``LlamaForCausalLM``'s function with ``Gpt2LMHeadModel``'s call
    signature (the causal-LM losses, ``generate_causal``, the serving
    engine and ``predict`` drive either); fp32 logits."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.config = cfg
        self.backbone = LlamaModel(cfg)
        if not cfg.tie_word_embeddings:
            # a plain fp dense: the head stays full precision under int8
            self.lm_head = Dense(cfg, cfg.hidden_size, cfg.vocab_size, bias=False)

    def forward(self, input_ids, attention_mask=None, position_ids=None, cache=None):
        hidden = self.backbone(input_ids, attention_mask, position_ids, cache)
        if self.config.tie_word_embeddings:
            w = self.backbone.embed_tokens.weight.to(self.config.dtype)
            return torch.matmul(hidden, w.t()).float()
        return self.lm_head(hidden).float()

    def hidden_and_embedding(self, input_ids, attention_mask=None, position_ids=None):
        """``(hidden [B, S, H] in the compute dtype, head weight [V, H] as
        stored)``: the tied embedding or ``lm_head``'s weight, for the
        fused vocab cross-entropy."""
        hidden = self.backbone(input_ids, attention_mask, position_ids)
        if self.config.tie_word_embeddings:
            return hidden, self.backbone.embed_tokens.weight
        return hidden, self.lm_head.weight

    def new_dense_cache(self, batch: int, max_len: int,
                        index: Optional[torch.Tensor] = None) -> DenseCache:
        """Zeroed dense per-row KV buffers (``num_kv_heads`` heads, this
        rank's ``num_kv_heads / tp`` on a model cut for tensor-parallel
        serving) for every layer on the model's device, in the config's KV
        storage."""
        cfg = self.config
        return DenseCache.empty(
            cfg.num_layers, batch, local_heads(self, cfg.num_kv_heads), max_len,
            cfg.resolved_head_dim,
            cfg.dtype, self.backbone.embed_tokens.weight.device,
            int8=cfg.kv_cache_dtype == "int8", index=index)
