"""Analytic model-FLOPs accounting and the card's peak, for MFU (the
port's copy of the JAX package's ``obs/flops.py``; the FLOPs model is
the same, line for line, so the two packages' MFU figures agree).

One convention, used by the trainer's per-window MFU series: matmul
FLOPs only, training = 3x forward (fwd + dX + dW), recompute excluded,
embedding lookups / layernorms / softmax excluded (~2% at the shapes the
port runs). "Model FLOPs" counts USEFUL work: multiply by REAL token
counts (attention-mask sums), not padded widths; padded tokens burn
hardware FLOPs but do no model work, so they depress MFU as they should.

Peak FLOP/s comes from a table keyed on ``torch.cuda.get_device_name()``
(NVIDIA's published dense bf16 tensor-core rates) with an
``HSTD_PEAK_TFLOPS`` env override for cards the table does not know,
including CPU runs, where the override is the only way to get an MFU at
all. Stdlib only: callers pass the device name as a string.
"""

from __future__ import annotations

import os
from typing import Optional

ENV_PEAK = "HSTD_PEAK_TFLOPS"

# dense bf16 tensor-core TFLOP/s per card, by lowercase substring of
# torch.cuda.get_device_name() (NVIDIA's data sheets, without sparsity).
# Order matters: the PCIe and NVL parts before the bare "h100" of the
# SXM part ("NVIDIA H100 80GB HBM3").
PEAK_TFLOPS_TABLE = (
    ("h100 pcie", 756.0),
    ("h100 nvl", 835.0),
    ("h100", 989.0),
)


def env_peak_tflops() -> Optional[float]:
    """``HSTD_PEAK_TFLOPS`` as a float (None = unset; malformed values
    disable the override rather than kill the run)."""
    raw = os.environ.get(ENV_PEAK, "").strip()
    try:
        value = float(raw) if raw else None
    except ValueError:
        return None
    return value if value and value > 0 else None


def peak_tflops(device_kind: Optional[str]) -> Optional[float]:
    """Peak bf16 matmul TFLOP/s for one card: the env override wins,
    then the device-name table; None when neither knows the card (MFU
    is then unreportable, not guessed)."""
    override = env_peak_tflops()
    if override is not None:
        return override
    if not device_kind:
        return None
    low = device_kind.lower()
    for marker, peak in PEAK_TFLOPS_TABLE:
        if marker in low:
            return peak
    return None


# ---------------------------------------------------------------------------
# Analytic per-token FLOPs. All figures are FORWARD matmul FLOPs for ONE
# token; training multiplies by TRAIN_FACTOR.
# ---------------------------------------------------------------------------

TRAIN_FACTOR = 3.0     # fwd + dX + dW (the standard model-FLOPs convention)
MLM_MASK_FRACTION = 0.15   # fraction of tokens carrying an LM-head label


def _layer_fwd_flops_per_token(hidden: int, intermediate: int, kv_len: int,
                               kv_ratio: float = 1.0,
                               gated: bool = False) -> float:
    """One DENSE transformer layer, per token at context length
    ``kv_len``: QKVO projections (K/V scaled by the GQA ratio),
    QK^T + PV scores, and the MLP (2 matmuls, or 3 for gated SwiGLU).
    Sparse-MoE extra is layered on by :func:`_moe_extra_fwd`."""
    qkvo = 2 * hidden * hidden * (2 + 2 * kv_ratio)   # q,o full; k,v scaled
    attn = 4 * kv_len * hidden                        # QK^T + PV
    mlp = (6 if gated else 4) * hidden * intermediate
    return qkvo + attn + mlp


def _moe_extra_fwd(cfg, args: dict, layers: int) -> float:
    """Routed-MoE forward surcharge per token: every ``moe_every``-th
    layer runs ``expert_top_k`` expert MLPs instead of one dense MLP —
    (top_k − 1) extra MLP units on ``layers // moe_every`` layers (the
    JAX package's convention)."""
    experts = int(getattr(cfg, "num_experts", 0) or 0)
    if not experts:
        return 0.0
    top_k = int(getattr(cfg, "expert_top_k", 0) or 2)
    moe_every = max(int(getattr(cfg, "moe_every", 1) or 1), 1)
    n_moe = layers // moe_every
    mlp_unit = (6 if args["gated"] else 4) \
        * args["hidden"] * args["intermediate"]
    return n_moe * (top_k - 1) * mlp_unit


def _cfg_layer_args(cfg) -> dict:
    """The per-layer figures a model config implies, across this repo's
    config dialects: BERT/GPT-2 family (``hidden_size`` /
    ``intermediate_size``), T5 (``d_model``/``d_ff``; gated MLP when
    ``feed_forward_proj`` starts with "gated"), BART (``d_model``/
    ``encoder_ffn_dim``). ``num_kv_heads`` marks the Llama family
    (GQA + gated SwiGLU MLP); sparse MoE's routed surcharge is handled
    separately by :func:`_moe_extra_fwd`. Raises AttributeError for
    configs without transformer dims."""
    hidden = (getattr(cfg, "hidden_size", None)
              or getattr(cfg, "d_model", None))
    intermediate = (getattr(cfg, "intermediate_size", None)
                    or getattr(cfg, "d_ff", None)
                    or getattr(cfg, "encoder_ffn_dim", None))
    if not hidden or not intermediate:
        raise AttributeError("config carries no transformer dimensions")
    heads = int(getattr(cfg, "num_heads", 0)
                or getattr(cfg, "encoder_attention_heads", 0) or 1)
    kv_heads = int(getattr(cfg, "num_kv_heads", 0) or heads)
    gated = (hasattr(cfg, "num_kv_heads")
             or str(getattr(cfg, "feed_forward_proj",
                            "")).startswith("gated"))
    return {
        "hidden": int(hidden),
        "intermediate": int(intermediate),
        "kv_ratio": kv_heads / heads,
        "gated": gated,
    }


def _cfg_layers(cfg) -> tuple[int, int]:
    """(encoder/stack layers, decoder layers) across config dialects."""
    enc = int(getattr(cfg, "num_layers", 0)
              or getattr(cfg, "encoder_layers", 0))
    dec = int(getattr(cfg, "num_decoder_layers", 0)
              or getattr(cfg, "decoder_layers", 0) or enc)
    if enc <= 0:
        raise AttributeError("config carries no layer count")
    return enc, dec


def train_flops_per_token(cfg, task: str, seq_len: int) -> float:
    """Per-REAL-token training FLOPs for a single-stack model config
    (encoder-only or decoder-only) under ``task``:

    - ``causal-lm``: every position pays the LM head (2·h·V).
    - ``mlm``: only the masked fraction pays the head (the fused path
      literally computes only those; the unfused path's extra work is
      overhead, not model FLOPs).
    - classification tasks (seq-cls / token-cls / qa / rtd): the head
      is O(h·labels) ≈ negligible.

    ``seq_len`` sets the attention-score term (the only length-dependent
    part); with bucketing/packing pass the configured max — the term is
    a few percent of the total at these shapes.
    """
    args = _cfg_layer_args(cfg)
    layers, _ = _cfg_layers(cfg)
    fwd = layers * _layer_fwd_flops_per_token(kv_len=seq_len, **args)
    fwd += _moe_extra_fwd(cfg, args, layers)
    vocab = int(getattr(cfg, "vocab_size", 0) or 0)
    head = 2 * args["hidden"] * vocab
    if task == "causal-lm":
        fwd += head
    elif task == "mlm":
        fwd += head * MLM_MASK_FRACTION
    return TRAIN_FACTOR * fwd


def seq2seq_train_flops_per_token(cfg, enc_len: int,
                                  dec_len: int) -> tuple[float, float]:
    """(encoder FLOPs per encoder token, decoder FLOPs per decoder
    token) for an encoder-decoder config. Decoder layers additionally
    pay cross-attention (KV projections over + scores against the
    encoder context) and every decoder token pays the LM head. Multiply
    by the two REAL token counts separately."""
    args = _cfg_layer_args(cfg)
    h = args["hidden"]
    enc_layers, dec_layers = _cfg_layers(cfg)
    enc_fwd = (enc_layers
               * _layer_fwd_flops_per_token(kv_len=enc_len, **args)
               + _moe_extra_fwd(cfg, args, enc_layers))
    # cross-attention per decoder token: q+o projections + scores over
    # the encoder width (the cross K/V projections are paid per ENCODER
    # token once, folded in here as an approximation)
    cross = 2 * h * h * (2 + 2 * args["kv_ratio"]) + 4 * enc_len * h
    dec_fwd = (dec_layers
               * (_layer_fwd_flops_per_token(kv_len=dec_len, **args) + cross))
    vocab = int(getattr(cfg, "vocab_size", 0) or 0)
    dec_fwd += 2 * h * vocab
    return TRAIN_FACTOR * enc_fwd, TRAIN_FACTOR * dec_fwd


def trainer_flops_per_token(cfg, task: str,
                            seq_len: int) -> tuple[float, float]:
    """What the Trainer wires into its StepMeter: ``(flops per primary
    token, flops per decoder token)`` — the second is 0 except for
    seq2seq, where the two token streams are counted separately. A
    config without the transformer figures raises AttributeError: the
    port's model configs always carry them, so MFU is never dropped
    silently."""
    if task == "seq2seq":
        # decoder width ~ a fraction of the encoder width in the
        # shipped configs; the attention terms are small, so
        # enc_len for both keeps one knob
        return seq2seq_train_flops_per_token(cfg, seq_len, seq_len)
    return train_flops_per_token(cfg, task, seq_len), 0.0


def mfu(achieved_tflops_per_chip: Optional[float],
        peak: Optional[float]) -> Optional[float]:
    """MFU in (0, 1] — None when either side is unknown (never guessed,
    never clipped silently: >1 means the FLOPs model or the peak table
    is wrong and should LOOK wrong)."""
    if not achieved_tflops_per_chip or not peak:
        return None
    return achieved_tflops_per_chip / peak
