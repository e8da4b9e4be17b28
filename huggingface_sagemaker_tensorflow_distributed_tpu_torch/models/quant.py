"""Int8 weight-only quantization for generation (counterpart of the JAX
package's ``models/quant.py``).

Symmetric per-output-channel scales, no zero point: a targeted dense
kernel ``W [in, out]`` becomes ``q = round(W / scale)`` in int8 with
``scale = max|W[:, j]| / 127`` per output column. The arithmetic is the
JAX package's, in numpy on the JAX layout (the transpose of
``nn.Linear.weight``), so ``q`` and ``scale`` equal the JAX ones bit for
bit; the port stores ``q`` as ``[out, in]`` (``Int8Linear.weight_q``).

Scope: the dense kernels of the generating families, matched on their
JAX parameter paths (``models/lora.py::jax_param_paths``, the names LoRA
targets): GPT-2 (qkv / attn_out / fc_in / fc_out), the Llama family (q /
k / v / o, gate / up / down), T5 (query / key / value / attention_out,
wi / wi_0 / wi_1 / wo) and BART/mBART (q / k / v / o, fc1 / fc2). Each family builds those denses through
:func:`make_dense`, the one place that picks fp or int8 by the config's
``weight_quant``. Embeddings and LM heads stay full precision. A
quantized model is loaded (:func:`quantize_for_generation`), never
trained.

The product stays plain PyTorch: :class:`Int8Linear` dequantizes its
weight into the compute dtype on every call and runs ``F.linear``, so it
moves more bytes than the fp layer it replaces (the int8 weight read,
the dequantized weight written and read again). What it saves is the
weight memory the model holds.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.layers import Dense
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.lora import (
    jax_param_paths,
)

# per-family dense-kernel leaves that become int8 (regex against the
# "/"-joined JAX parameter path ending in "/kernel"); LM heads excluded
GPT2_QUANT_TARGETS = r"(qkv|attn_out|fc_in|fc_out)/kernel$"
T5_QUANT_TARGETS = r"(query|key|value|attention_out|wi|wi_0|wi_1|wo)/kernel$"
BART_QUANT_TARGETS = r"(query|key|value|attention_out|fc1|fc2)/kernel$"
LLAMA_QUANT_TARGETS = (
    r"(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj)/kernel$")


class Int8Linear(nn.Module):
    """Drop-in for :class:`~.layers.Dense` holding an int8 weight
    ``weight_q [out, in]`` and fp32 per-output-channel scales
    ``weight_scale [out]`` (the JAX ``Int8Dense``'s ``kernel_q`` and
    ``kernel_scale``). Built with zero weights and unit scales; the
    values come from :func:`quantize_for_generation`."""

    def __init__(self, cfg, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = cfg.dtype
        self.weight_q = nn.Parameter(torch.zeros(out_features, in_features,
                                                 dtype=torch.int8), requires_grad=False)
        self.weight_scale = nn.Parameter(torch.ones(out_features), requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=cfg.param_dtype))
                     if bias else None)

    def forward(self, x):
        dt = self.compute_dtype
        w = self.weight_q.to(dt) * self.weight_scale.to(dt)[:, None]
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), w, bias)


def make_dense(cfg, in_features: int, out_features: int, bias: bool = True) -> nn.Module:
    """The dense-construction chokepoint of GPT-2, T5 and BART: a
    :class:`~.layers.Dense`, or an :class:`Int8Linear` when
    ``cfg.weight_quant`` is ``"int8"``."""
    if getattr(cfg, "weight_quant", "none") == "int8":
        return Int8Linear(cfg, in_features, out_features, bias=bias)
    return Dense(cfg, in_features, out_features, bias=bias)


def quantize_kernel(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8 of a JAX-layout kernel ``[in,
    out]``: scale = max|w|/127 per column, q = round(w/scale). Returns
    (q int8 [in, out], scale fp32 [out])."""
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=0)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale[None, :]), -127, 127).astype(np.int8)
    return q, scale


def quantize_params(flat: dict, targets: str) -> tuple[dict, dict]:
    """Rewrite each targeted ``.../kernel`` of a flat JAX-path tree
    (``{"backbone/h_0/attention/qkv/kernel": array [in, out], ...}``)
    into ``kernel_q`` + ``kernel_scale``; everything else passes through.
    Returns (quantized flat tree, stats)."""
    rx = re.compile(targets)
    out: dict = {}
    n_quant = bytes_before = bytes_after = 0
    for path, leaf in flat.items():
        arr = np.asarray(leaf)
        if rx.search(path) and arr.ndim == 2:
            q, scale = quantize_kernel(arr)
            base = path[: -len("kernel")]
            out[base + "kernel_q"] = q
            out[base + "kernel_scale"] = scale
            n_quant += 1
            bytes_before += arr.size * arr.dtype.itemsize
            bytes_after += q.size + scale.size * 4
        else:
            out[path] = leaf
    if n_quant == 0:
        raise ValueError(f"quant target {targets!r} matched no kernels")
    stats = {"kernels_quantized": n_quant, "bytes_before": bytes_before,
             "bytes_after": bytes_after}
    return out, stats


def quantize_for_generation(model: nn.Module) -> tuple[nn.Module, dict]:
    """A full-precision GPT-2, Llama, T5, BART or mBART -> ``(int8 model,
    stats)``: the same architecture with ``weight_quant='int8'`` on the
    model's device, in eval mode, its targeted kernels quantized in the
    JAX layout, every other parameter carried as it is. The KV cache,
    decoding and sampling are untouched."""
    # the families import this module for make_dense
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.bart import BartConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
        params_from_jax,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.gpt2 import Gpt2Config
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.llama import LlamaConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.t5 import T5Config

    cfg = model.config
    targets = {Gpt2Config: GPT2_QUANT_TARGETS, T5Config: T5_QUANT_TARGETS,
               BartConfig: BART_QUANT_TARGETS,
               LlamaConfig: LLAMA_QUANT_TARGETS}.get(type(cfg))
    if targets is None:
        raise ValueError(
            "int8 weight-only quantization covers the generating "
            "families (GPT-2, Llama, T5, BART/mBART); got "
            f"{type(cfg).__name__}")
    flat = {}
    with torch.no_grad():
        for name, path in jax_param_paths(model).items():
            t = model.get_parameter(name).detach().float().cpu()
            flat[path] = (t.T if path.endswith("/kernel") else t).numpy()
    qflat, stats = quantize_params(flat, targets)
    state = params_from_jax(qflat)
    device = next(model.parameters()).device
    with torch.device("meta"):
        qmodel = type(model)(dataclasses.replace(cfg, weight_quant="int8"))
    own = qmodel.state_dict()
    state = {k: v.to(device=device, dtype=own[k].dtype) for k, v in state.items()}
    qmodel.load_state_dict(state, strict=True, assign=True)
    return qmodel.eval().requires_grad_(False), stats
