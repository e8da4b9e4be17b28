"""Mixture-of-Experts feed-forward (counterpart of the JAX package's
``models/moe.py``): the GShard/Switch token-routed FFN of the encoder
families and GPT-2 (:class:`MoeFeedForward`) and Mixtral's SwiGLU expert
bank for the Llama family (:class:`MixtralMoeBlock`).

- Routing is the JAX package's dense formulation: an fp32 router and
  softmax, greedy top-k (:func:`topk_dispatch`, ``argmax`` keeps the
  first of equal maxima as ``jnp.argmax`` does), one-hot dispatch and
  combine tensors ``[B, S, E, C]`` contracted with the tokens
  (``bsec,bsh->ebch``) and with the expert outputs. Each batch row is a
  routing group with a static per-expert capacity (:func:`expert_capacity`);
  a choice past it is dropped and the token rides the residual, so the
  drops are the JAX package's exactly.
- Slot priority is round-major (GShard) or position-major
  (``causal=True``, GPT-2's and Mixtral's: no future token changes an
  earlier token's drops).
- The Switch load-balance loss of each forward is kept on the module
  (``aux_loss``) and :func:`moe_aux_loss` hands the trainer their sum,
  where the JAX package sows it into the ``losses`` collection. Under
  data parallelism it is the global batch's, as in the JAX package's one
  step over the sharded batch: the ranks' per-expert means are
  all-reduced before their product.

Expert parallelism is not ported: the banks are whole on one device (the
trainer's ``ep > 1`` raises, ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def expert_capacity(cfg, seq_len: int) -> int:
    """Static per-group expert capacity: ``ceil(k·S·factor / E)`` rounded
    up to a multiple of 4 (at least 4), the JAX package's."""
    raw = cfg.expert_capacity_factor * cfg.expert_top_k * seq_len / cfg.num_experts
    return max(4, 4 * math.ceil(raw / 4))


def topk_dispatch(probs: torch.Tensor, k: int, C: int, causal: bool):
    """Greedy top-k routing into capacity slots. ``probs`` ``[B, S, E]``
    fp32. Returns ``(combine [B, S, E, C] fp32, top1_mask [B, S, E])``:
    each kept token-to-slot assignment weighted by its gate, normalized
    per token by its selected top-k mass (Mixtral's renormalization; a
    dropped choice keeps zero dispatch). Slot priority is round-major, or
    position-major with ``causal`` (a slot counts only assignments of
    strictly earlier tokens)."""
    B, S, E = probs.shape
    remaining = probs
    masks, gates = [], []
    for _ in range(k):
        idx = remaining.argmax(-1)                            # first maximum
        mask = F.one_hot(idx, E).to(torch.float32)
        gates.append((remaining * mask).sum(-1))
        remaining = remaining * (1.0 - mask)
        masks.append(mask)
    top1_mask = masks[0]

    if causal:
        total = sum(masks)
        prefix = torch.cumsum(total, dim=1) - total
        slot_pos = [prefix] * k
    else:
        slot_pos = []
        counts = torch.zeros(B, E, dtype=torch.float32, device=probs.device)
        for mask in masks:
            slot_pos.append(torch.cumsum(mask, dim=1) - 1.0 + counts[:, None, :])
            counts = counts + mask.sum(1)

    combine = torch.zeros(B, S, E, C, dtype=torch.float32, device=probs.device)
    gate_total = torch.zeros(B, S, dtype=torch.float32, device=probs.device)
    for mask, gate, pos in zip(masks, gates, slot_pos):
        slot = (pos * mask).sum(-1)                            # [B, S]
        kept = (slot < C) & (gate > 0.0)
        slot_oh = F.one_hot(torch.where(kept, slot, 0.0).long(), C).to(torch.float32)
        disp = mask[..., None] * slot_oh[:, :, None, :] * kept[:, :, None, None].float()
        combine = combine + gate[:, :, None, None] * disp
        gate_total = gate_total + gate
    denom = torch.where(gate_total > 0.0, gate_total, 1.0)
    return combine / denom[:, :, None, None], top1_mask


class _Routed(nn.Module):
    """The scaffolding both MoE flavours share: the fp32 ``router [H, E]``
    (the JAX parameter's layout), :func:`topk_dispatch`, the Switch aux
    loss and the token-to-expert dispatch contraction."""

    aux_loss: Optional[torch.Tensor] = None
    # the last forward's per-expert (top-1 fraction, mean probability)
    balance: Optional[tuple] = None

    def __init__(self, cfg, causal: bool):
        super().__init__()
        self.cfg, self.causal = cfg, causal
        self.router = nn.Parameter(torch.zeros(cfg.hidden_size, cfg.num_experts,
                                               dtype=torch.float32))

    def route(self, hidden):
        """``(expert_in [E, B, C, H] in the compute dtype, combine [B, S, E,
        C] fp32)``; sets ``aux_loss``."""
        cfg = self.cfg
        E = cfg.num_experts
        C = expert_capacity(cfg, hidden.shape[1])
        logits = torch.einsum("bsh,he->bse", hidden.float(), self.router.float())
        probs = torch.softmax(logits, dim=-1)
        combine, top1 = topk_dispatch(probs, cfg.expert_top_k, C, self.causal)
        # Switch load balance: top-1 fractions x mean router probabilities
        frac = top1.mean(dim=(0, 1))
        mean_prob = probs.mean(dim=(0, 1))
        self.balance = (frac, mean_prob)
        self.aux_loss = cfg.router_aux_coef * E * (frac * mean_prob).sum()
        dispatch = (combine > 0.0).to(cfg.dtype)
        expert_in = torch.einsum("bsec,bsh->ebch", dispatch, hidden.to(cfg.dtype))
        return expert_in, combine

    def combine(self, combine, out):
        return torch.einsum("bsec,ebch->bsh", combine.to(self.cfg.dtype), out)


class MoeFeedForward(_Routed):
    """The token-routed FFN of the encoder families' and GPT-2's MoE
    layers: ``wi [E, H, F]``, the activation, ``wo [E, F, H]`` per expert,
    output dropout. ``causal`` picks position-major slot priority;
    ``out_init_std`` is the ``wo`` init's std (GPT-2's residual-flow
    scaling; :func:`~.convert.init_gpt2` reads it)."""

    def __init__(self, cfg, causal: bool = False, out_init_std: Optional[float] = None):
        super().__init__(cfg, causal)
        from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.layers import ACT2FN

        E, H, Fd = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
        self.out_init_std = out_init_std
        self.wi = nn.Parameter(torch.zeros(E, H, Fd, dtype=cfg.param_dtype))
        self.wo = nn.Parameter(torch.zeros(E, Fd, H, dtype=cfg.param_dtype))
        self.act = ACT2FN[cfg.hidden_act]
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, hidden):
        dt = self.cfg.dtype
        expert_in, combine = self.route(hidden)
        h = self.act(torch.einsum("ebch,ehf->ebcf", expert_in, self.wi.to(dt)))
        out = torch.einsum("ebcf,efh->ebch", h, self.wo.to(dt))
        return self.dropout(self.combine(combine, out))


class MixtralMoeBlock(_Routed):
    """Mixtral's sparse MoE (HF ``MixtralSparseMoeBlock`` naming): SwiGLU
    experts ``w2(act(w1 x) * w3 x)`` with ``w1``/``w3`` ``[E, H, F]`` and
    ``w2 [E, F, H]``, position-major priority, no dropout. At a capacity
    factor of at least ``E / k`` nothing is dropped and the block equals
    HF's, which routes every token."""

    def __init__(self, cfg):
        super().__init__(cfg, causal=True)
        from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.layers import ACT2FN

        E, H, Fd = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
        self.w1 = nn.Parameter(torch.zeros(E, H, Fd, dtype=cfg.param_dtype))
        self.w3 = nn.Parameter(torch.zeros(E, H, Fd, dtype=cfg.param_dtype))
        self.w2 = nn.Parameter(torch.zeros(E, Fd, H, dtype=cfg.param_dtype))
        self.act = ACT2FN[cfg.hidden_act]

    def forward(self, hidden):
        dt = self.cfg.dtype
        expert_in, combine = self.route(hidden)
        g = self.act(torch.einsum("ebch,ehf->ebcf", expert_in, self.w1.to(dt)))
        u = torch.einsum("ebch,ehf->ebcf", expert_in, self.w3.to(dt))
        out = torch.einsum("ebcf,efh->ebch", g * u, self.w2.to(dt))
        return self.combine(combine, out)


def moe_aux_loss(model: nn.Module, world: int = 1) -> Optional[torch.Tensor]:
    """The sum of the aux losses the MoE layers of ``model`` kept on their
    last forward (None without MoE layers); each is read once.

    With ``world`` > 1 (data parallelism over the ``world`` ranks of the
    initialized process group, each with an equal share of the global
    batch's rows), each layer's loss is taken over the global batch, as the
    JAX package's one step over the data-sharded batch takes it: the ranks'
    per-expert top-1 fractions and mean probabilities are summed by one
    all-reduce and averaged before their product. The probabilities carry
    the router's gradient, so that all-reduce is the autograd-aware one:
    its backward sums each rank's share, and the gradients' mean over the
    ranks is then the global loss's gradient."""
    layers = [m for m in model.modules() if isinstance(m, _Routed) and m.aux_loss is not None]
    if not layers:
        return None
    if world > 1:
        from torch.distributed.nn.functional import all_reduce

        E = layers[0].cfg.num_experts
        stacked = torch.cat([torch.cat([m.balance[0].detach(), m.balance[1]]) for m in layers])
        means = all_reduce(stacked).reshape(len(layers), 2, E) / world
    total = None
    for i, m in enumerate(layers):
        aux = m.aux_loss if world == 1 else (
            m.cfg.router_aux_coef * E * (means[i, 0] * means[i, 1]).sum())
        total = aux if total is None else total + aux
        m.aux_loss = m.balance = None
    return total
