"""PyTorch/CUDA port of ``huggingface_sagemaker_tensorflow_distributed_tpu``.

The JAX package stays the reference; this package imports nothing of it
and nothing of JAX. Its first slice is continuous-batching greedy
serving of GPT-2, with paged decode attention as a hand-written CUDA
kernel for Hopper (``csrc/paged_attention.cu``); its second is
BERT-family sequence-classification fine-tuning (``train/cli.py``), with
the flash-attention forward, dQ and dK/dV/dmask as hand-written CUDA
kernels (``csrc/flash_attention.cu``); its third is GPT-2 causal-LM
training (``train/cli.py --task causal-lm``), with the fused LM head +
cross-entropy forward, dH and dW as hand-written CUDA kernels
(``csrc/vocab_ce.cu``). Later slices ported the rest of the JAX
package's models on those kernels, the Llama family and Mixture-of-Experts
among them (``models/llama.py``, ``models/moe.py``). Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; without a GPU they raise
instead of falling back. The package itself imports nothing, so its
offline telemetry readers (``python -m <package>.obs``) run without torch.
"""

from __future__ import annotations


def resolve_device(device=None) -> "torch.device":  # noqa: F821
    """The device an entry point runs on: CUDA unless ``device`` names
    another. Raises when CUDA is asked for (explicitly or by default)
    and is not available; never falls back to the CPU."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is False; pass "
            "device='cpu' to run on the CPU")
    return dev
