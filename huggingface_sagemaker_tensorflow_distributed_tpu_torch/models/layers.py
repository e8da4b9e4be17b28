"""Activation table shared by the port's models (counterpart of the JAX
package's ``models/layers.py::ACT2FN``)."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

ACT2FN: dict[str, Callable] = {
    "gelu": lambda x: F.gelu(x, approximate="none"),   # HF "gelu" is erf-exact
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
    "tanh": torch.tanh,
}
