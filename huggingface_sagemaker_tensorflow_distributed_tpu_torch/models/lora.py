"""LoRA, low-rank adaptation for parameter-efficient fine-tuning
(counterpart of the JAX package's ``models/lora.py``).

The base model is frozen and each targeted dense kernel ``W`` computes
with ``W_eff = W + (alpha / r) * A·B``, ``A [in, r]`` drawn
N(0, 1/sqrt(in)) and ``B [r, out]`` zero, so step 0 is the base model
bit for bit; the optimizer state exists for the adapters (and the task
heads ``lora_train_heads`` matches) only.

- **Targets match on the JAX path.** A preset or a user regex is written
  against the JAX package's parameter paths
  (``backbone/encoder/layer_3/attention/query/kernel``), so each port
  parameter is first named by its JAX path (:func:`jax_param_paths`, the
  inverse of ``convert.params_from_jax``) and the same regex picks the
  same kernels in both packages.
- **Merge, then multiply, as the JAX package does.** An adapted
  :class:`~.layers.Dense` (or a DeBERTa conv) builds its merged weight in
  its parameter dtype inside its forward (:func:`attach_lora` hands it its
  factors) and casts it to the compute dtype, so a bf16 step rounds as the
  reference and the merged export do. Every use of a module sees the
  merged weight (DeBERTa's shared query and key projections serve its
  position terms too), and a recomputed (remat) forward merges again.
- **The sidecar reads across.** ``adapter.safetensors`` holds the JAX
  flat names (``.../kernel/a``, ``.../kernel/b``) in the JAX layouts and
  ``adapter_config.json`` the same keys, so either package reads the
  other's.

Adapters are a flat dict ``{kernel path: {"a": tensor, "b": tensor}}``.
Only kernels (dense layers and the conv) adapt: a regex that matches an
embedding table raises, since the tied heads read those tables directly.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Optional

import torch
from torch import nn

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.config import (
    LORA_HEAD_REGEX_DEFAULT as HEAD_REGEX_DEFAULT,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.safetensors_io import (
    load_file,
    save_file,
)

# preset -> kernel-leaf regex over the "/"-joined JAX path (per-layer
# modules end in ".../<name>/kernel", pipelined stacks in "..._kernel")
TARGET_PRESETS = {
    "attention": r"(query|key|value|qkv|attention_out|attn_out"
                 r"|q_proj|k_proj|v_proj|o_proj)(/kernel|_kernel)$",
    "mlp": r"(intermediate|ffn_out|fc_in|fc_out|wi|wi_0|wi_1|wo|fc1|fc2"
           r"|gate_proj|up_proj|down_proj)(/kernel|_kernel)$",
    "all": r"(/kernel|_kernel)$",
}

_INDEXED = re.compile(r"(^|\.)(h|layer|layers|block)\.(\d+)(?=\.|$)")


def target_regex(targets: str) -> str:
    """Resolve a preset name or pass a custom regex through."""
    return TARGET_PRESETS.get(targets, targets)


def lora_scaling(rank: int, alpha: float) -> float:
    return alpha / rank


def _leaf(module: nn.Module, name: str) -> str:
    if name in ("weight_q", "weight_scale"):        # models/quant.py's Int8Linear
        return "kernel" + name[len("weight"):]
    if name != "weight":
        return name
    if isinstance(module, (nn.Linear, nn.Conv1d)):
        return "kernel"
    if isinstance(module, nn.Embedding):
        return "embedding"
    return "scale"                      # layer norms


def jax_param_paths(model: nn.Module) -> dict[str, str]:
    """``{port parameter name: JAX parameter path}``: ``layer.3`` becomes
    ``layer_3`` (also ``h``, ``block``), a dense or conv ``weight`` its
    ``kernel`` (an int8 dense's ``weight_q`` and ``weight_scale`` its
    ``kernel_q`` and ``kernel_scale``), an embedding's its ``embedding``, a
    layer norm's its ``scale``."""
    out = {}
    for mod_name, module in model.named_modules():
        for p_name, _ in module.named_parameters(recurse=False):
            path = _INDEXED.sub(r"\1\2_\3", mod_name).replace(".", "/")
            leaf = _leaf(module, p_name)
            out[f"{mod_name}.{p_name}" if mod_name else p_name] = (
                f"{path}/{leaf}" if path else leaf)
    return out


def _kernel_modules(model: nn.Module) -> dict[str, nn.Module]:
    """``{JAX kernel path: module}`` of every adaptable module."""
    out = {}
    for mod_name, module in model.named_modules():
        if isinstance(module, (nn.Linear, nn.Conv1d)):
            out[_INDEXED.sub(r"\1\2_\3", mod_name).replace(".", "/") + "/kernel"] = module
    return out


def _targeted(model: nn.Module, pattern: str) -> list[str]:
    rx = re.compile(pattern)
    hits = sorted(p for p in jax_param_paths(model).values() if rx.search(p))
    kernels = _kernel_modules(model)
    tables = [p for p in hits if p not in kernels and not p.endswith("/bias")
              and not p.endswith("/scale")]
    if tables:
        raise ValueError(f"lora target {pattern!r} matches {tables[:4]}: only dense "
                         "and conv kernels adapt in the PyTorch package")
    return [p for p in hits if p in kernels]


def _jax_shape(weight: torch.Tensor) -> tuple:
    """The JAX kernel's shape: ``[in, out]`` for a dense ``[out, in]``,
    ``[K, in/g, out]`` for a conv ``[out, in/g, K]``."""
    return tuple(reversed(weight.shape))


def init_lora_params(model: nn.Module, rank: int, targets: str = "attention",
                     seed: int = 0) -> dict:
    """Adapters for the kernels ``targets`` (a preset or a regex) matches:
    ``{path: {"a": A, "b": B}}``, fp32 on the model's device, in sorted
    path order; a dense ``[in, out]`` kernel takes ``A [in, r]`` ~
    N(0, 1/sqrt(in)) from ``torch.Generator(seed)`` and ``B [r, out]``
    zero; a conv ``[K, in/g, out]`` takes stacked ``[K, in/g, r]`` and
    ``[K, r, out]`` (the JAX package's 3-D form)."""
    paths = _targeted(model, target_regex(targets))
    if not paths:
        raise ValueError(f"lora target {targets!r} matched no kernels in the param tree")
    kernels = _kernel_modules(model)
    gen = torch.Generator().manual_seed(int(seed))
    lora = {}
    for path in paths:
        weight = kernels[path].weight
        shape = _jax_shape(weight)
        *lead, fan_in, fan_out = shape
        a = torch.randn((*lead, fan_in, rank), generator=gen) / math.sqrt(fan_in)
        b = torch.zeros((*lead, rank, fan_out))
        lora[path] = {"a": a.to(weight.device), "b": b.to(weight.device)}
    return lora


def lora_delta(a: torch.Tensor, b: torch.Tensor, weight: torch.Tensor,
               scaling: float) -> torch.Tensor:
    """``W + scaling * A·B`` in ``weight``'s layout and dtype (the JAX
    ``merge_lora`` of one kernel: the product in fp32, cast to the
    parameter dtype, scaled, added)."""
    delta = a @ b                                    # [.., in, out]
    delta = delta.t() if delta.dim() == 2 else delta.permute(2, 1, 0)
    return (weight + scaling * delta.to(weight.dtype)).to(weight.dtype)


def merge_lora(model: nn.Module, lora: dict, scaling: float) -> dict:
    """The model's ``state_dict`` with every adapted kernel merged (the
    JAX ``merge_lora``; the other entries are the live tensors)."""
    names = {v: k for k, v in jax_param_paths(model).items()}
    state = dict(model.state_dict())
    with torch.no_grad():
        for path, ab in lora.items():
            key = names[path]
            state[key] = lora_delta(ab["a"], ab["b"], state[key], scaling)
    return state


def attach_lora(model: nn.Module, lora: Optional[dict], scaling: float = 1.0) -> None:
    """Make each adapted module compute with its merged weight (its
    ``lora`` attribute holds ``(A, B, scaling)``; it is no parameter of the
    model, so the model's ``state_dict`` stays the base's). ``None``
    detaches every adapter."""
    kernels = _kernel_modules(model)
    for module in kernels.values():
        if "lora" in module.__dict__:
            del module.lora
    for path, ab in (lora or {}).items():
        kernels[path].lora = (ab["a"], ab["b"], scaling)


def freeze_base(model: nn.Module, head_regex: str) -> list[str]:
    """``requires_grad_(False)`` on every parameter whose JAX path
    ``head_regex`` does not match (an empty regex freezes all); returns the
    names left trainable (the task heads, fresh on a fine-tune)."""
    rx = re.compile(head_regex) if head_regex else None
    heads = []
    for name, path in jax_param_paths(model).items():
        p = model.get_parameter(name)
        keep = rx is not None and bool(rx.search(path))
        p.requires_grad_(keep)
        if keep:
            heads.append(name)
    return heads


def count_params(tree) -> int:
    """Elements in a tensor, a module, or a (nested) dict or list of them."""
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    if isinstance(tree, nn.Module):
        return sum(p.numel() for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    return 0


def save_adapters(path: str, lora: dict, *, rank: int, alpha: float,
                  targets: str) -> None:
    """The adapter sidecar: ``adapter.safetensors`` (flat ``.../kernel/a``
    and ``.../kernel/b`` names, the JAX layouts) and
    ``adapter_config.json``, as the JAX ``save_adapters`` writes them."""
    flat = {f"{k}/{part}": v for k, ab in lora.items() for part, v in ab.items()}
    os.makedirs(path, exist_ok=True)
    save_file(flat, os.path.join(path, "adapter.safetensors"))
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"lora_rank": rank, "lora_alpha": alpha, "lora_targets": targets}, f,
                  indent=2)


def load_adapters(path: str, device="cpu") -> tuple[dict, dict]:
    """Inverse of :func:`save_adapters` (reads the JAX package's sidecar
    too): ``(adapters, config dict)``."""
    flat = load_file(os.path.join(path, "adapter.safetensors"), device=device)
    with open(os.path.join(path, "adapter_config.json")) as f:
        cfg = json.load(f)
    lora: dict = {}
    for name, value in flat.items():
        kernel, part = name.rsplit("/", 1)
        lora.setdefault(kernel, {})[part] = value
    return lora, cfg
