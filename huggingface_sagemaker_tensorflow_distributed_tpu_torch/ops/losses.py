"""Loss and metric primitives (counterpart of the JAX package's
``ops/losses.py``): fp32 cross-entropy with integer labels, masked mean
and accuracy, with a {0,1} validity mask so padded eval rows count for
nothing."""

from __future__ import annotations

import torch


def softmax_cross_entropy_with_integer_labels(logits, labels):
    """Per-example CE in float32. logits [..., C], labels [...] int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - label_logit


def masked_mean(values, mask=None):
    """Mean over valid entries; mask is {0,1} broadcastable to values."""
    values = values.float()
    if mask is None:
        return values.mean()
    mask = mask.float()
    return (values * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def accuracy(logits, labels, mask=None):
    """Share of rows whose argmax is the label (Keras
    ``SparseCategoricalAccuracy``)."""
    correct = (logits.argmax(-1) == labels).float()
    return masked_mean(correct, mask)
