"""Weights for the port's GPT-2: carried over from a JAX parameter tree,
or made at random from a seed.

- :func:`params_from_jax` maps the JAX package's flattened GPT-2 params
  (``flax.traverse_util.flatten_dict(params, sep="/")``) onto
  :class:`~.gpt2.Gpt2LMHeadModel`'s ``state_dict``: a flax ``Dense``
  ``kernel [in, out]`` becomes ``Linear.weight [out, in]``, a LayerNorm
  ``scale`` becomes ``weight``, an ``Embed.embedding`` the embedding
  weight, and ``h_<i>`` the ``h.<i>`` module list entry. Both packages
  then compute the same function.
- :func:`init_gpt2` is the counterpart of the JAX package's
  ``models/auto.py::init_params`` for GPT-2: normal(initializer_range)
  embeddings and dense kernels, ``initializer_range / sqrt(2 * layers)``
  for the residual projections (``attn_out``, ``fc_out``), zero biases,
  unit LayerNorm scales. The numbers come from a ``torch.Generator``, so
  they are not JAX's numbers for the same seed.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import resolve_device
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.gpt2 import (
    Gpt2Config,
    Gpt2LMHeadModel,
)

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "bias": "bias"}
_RESIDUAL_OUT = ("attn_out", "fc_out")


def params_from_jax(flat: dict) -> dict:
    """``{"backbone/h_0/attention/qkv/kernel": array, ...}`` (an optional
    leading ``params/`` is dropped) -> a ``state_dict`` of tensors."""
    out = {}
    for key, value in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        leaf = parts[-1]
        if leaf not in _LEAF:
            raise ValueError(f"unsupported JAX parameter {key!r}")
        arr = np.asarray(value)
        if leaf == "kernel":
            arr = arr.T
        path = [re.sub(r"^h_(\d+)$", r"h.\1", p) for p in parts[:-1]]
        out[".".join(path + [_LEAF[leaf]])] = torch.from_numpy(np.array(arr))
    return out


def init_gpt2(cfg: Gpt2Config, seed: int = 0, device=None) -> Gpt2LMHeadModel:
    """A GPT-2 with random weights from ``seed``, in eval mode on
    ``device`` (CUDA unless the caller names another; raises without
    it). Weights are drawn on the CPU, so a seed gives the same model on
    every device."""
    dev = resolve_device(device)
    model = Gpt2LMHeadModel(cfg)
    gen = torch.Generator().manual_seed(int(seed))
    std = cfg.initializer_range
    resid_std = std / (2 * cfg.num_layers) ** 0.5
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".ln_" in name or name.startswith("backbone.ln_f"):
                p.fill_(1.0)
            else:
                s = resid_std if any(f".{r}." in name for r in _RESIDUAL_OUT) else std
                p.copy_(torch.randn(p.shape, generator=gen) * s)
    return model.to(dev).eval().requires_grad_(False)
