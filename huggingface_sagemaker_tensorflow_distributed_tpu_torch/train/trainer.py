"""The training engine: train/eval steps and the epoch loop (counterpart
of the JAX package's ``train/trainer.py``: ``_masked_sums``, the task
losses ``seq_cls_loss``, ``token_cls_loss`` (also ``mlm``'s, without the
F1 counts), ``qa_loss``, ``causal_lm_loss``, ``rtd_loss`` and
``seq2seq_loss`` (with train-time label smoothing), the fused
``make_fused_causal_lm_loss``, ``make_fused_mlm_loss`` and
``make_fused_seq2seq_loss``, and ``Trainer`` for every task).

- A train step is forward, backward, one all-reduce mean of the
  gradients over the ranks, clipping, and the optimizer update at the
  schedule's learning rate; with ``gradient_accumulation_steps = k`` the
  update comes every k-th step with the mean of the k micro-batch
  gradients (optax ``MultiSteps``). The loss is the mean over the valid
  rows or tokens of the whole global batch, as the JAX package's sharded
  ``_masked_sums`` gives: with several ranks the valid count is
  all-reduced first and each rank back-propagates ``loss_sum * world /
  count``, so the gradient mean is the global mean even when the ranks
  hold different numbers of valid tokens (causal-LM padding); the logged
  loss and accuracy are the global ones.
- ``fit`` keeps the JAX epoch loop and its lifecycle: ``steps_per_epoch``
  cap, ``log_every_steps`` sync points, checkpoints every
  ``checkpoint_every_steps`` and at each epoch end (each after the
  replica-divergence check), mid-epoch resume, per-epoch eval with
  ``eval_each_epoch``, ``keep_best`` and ``early_stopping_patience``, the
  ``--profile`` window (train steps 3-6 of the first epoch, a
  ``torch.profiler`` Chrome trace under ``profile_dir``), and the
  Keras-style history (``loss``, ``sparse_categorical_accuracy``,
  ``eval_loss``/``eval_accuracy``, ``train_runtime``,
  ``train_samples_per_second[_per_chip]`` with the first (warm-up) step,
  and with length bucketing the first step of each new batch width,
  excluded from the meter, and with an MFU figure to read
  ``train_achieved_tflops_per_chip``/``train_mfu``). Step metrics stay on
  the device until a sync point.
- Telemetry (``obs``): the spans ``train/step_dispatch``,
  ``train/sync``, ``train/checkpoint``, ``eval/run`` and ``eval/sync``,
  the meter's per-window series, and on instrumented runs the heartbeat
  and the anomaly detector (non-finite loss, grad-norm explosion fed by
  the update's global norm, step-time spikes, stragglers).
- ``evaluate`` sums loss, correct predictions and the count exactly over
  the ``valid`` rows, across ranks; token-cls adds the micro-F1 over the
  non-O tags (``eval_f1``) from its summed true and false positives and
  false negatives.
- Every batch iterator ``fit`` and ``evaluate`` open is closed on every
  exit (the ``steps_per_epoch`` cap, an exception), which stops the
  batcher's prefetch thread.
- Token-packed batches (``segment_ids``, ``position_ids``) reach every
  task loss's model call (``_packed_kwargs``).
- Over a ``dp × fsdp × seq × tp`` mesh (``mesh``, ``parallel/mesh.py``) with
  ``fsdp > 1`` or ``tp > 1`` the model is wrapped by
  ``parallel/sharding.py:shard_model``, the tensor-parallel plan left out
  at ``tp`` 1 (a model the caller wrapped already stays as it is): FSDP2
  reduces the gradients over ``data × fsdp``, so
  there is no all-reduce of them here. The ``tensor`` ranks of a replica
  share its rows, so the loss sums and the counts are summed over the
  data-parallel group only, each rank back-propagates ``loss_sum ·
  dp_size / count``, and the learning rate scales by ``dp_size``
  (``data_parallel_size``; the JAX Trainer's ``dp_size``) where MFU and
  the meter count every rank (``world_size``). The replica check compares
  each shard across the ``data`` replicas; a checkpoint holds the gathered
  state (``torch.distributed.checkpoint.state_dict``, ``full_state_dict``)
  on rank 0's host, one tensor at a time gathered and offloaded, and
  restores onto the same mesh by rank 0's broadcast; ``export_params`` is
  the gathered model in its unwrapped layout, on rank 0's host (``{}`` on
  the others). No card holds more than one whole tensor on the way. The
  DP-only path is unchanged.
- Over a mesh whose ``seq`` axis is > 1 (sequence parallelism,
  ``parallel/ring_attention.py``) the ``seq`` ranks of a replica take its
  rows too, so the loss sums and counts stay over ``data × fsdp``; every
  forward and backward runs under the mesh (``parallel.mesh.use_mesh``), so
  a ring model splits its sequence over ``seq``. Each rank's gradient is
  its block's share of the sequence, scaled by ``seq`` (the gather before
  the heads sums the ranks' gradients), so the gradients are averaged over
  ``data × fsdp × seq``: FSDP2 over ``data × fsdp``, then an all-reduce of
  the local shards over ``seq`` (FSDP2 shards over no ``seq`` rank); with
  ``fsdp`` = ``tp`` = 1 nothing is wrapped and the plain all-reduce over
  every rank (``data × seq``) does both. The replica check
  compares ``data`` and ``seq``. BART, DeBERTa, MoE layers and LoRA raise
  there (``sharding.check_sequence_parallel``, ROADMAP item 11).
- LoRA (``lora_rank > 0``, ``models/lora.py``): the base is frozen but the
  heads ``lora_train_heads`` matches, adapters from ``torch.Generator(seed)``
  are attached to the targeted kernels, and ``self.params`` (the optimizer,
  the clip, the all-reduce, the accumulated gradients) holds the adapters and
  heads only; the checkpoint carries the adapters, keep-best snapshots the
  adapters and heads, and ``export_params`` is the merged model.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.config import TrainConfig
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import lora as lo
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.moe import moe_aux_loss
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.anomaly import (
    anomaly_enabled_env,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.flight import (
    start_profiler,
    stop_profiler,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.losses import (
    softmax_cross_entropy_with_integer_labels,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.vocab_ce import (
    fused_vocab_cross_entropy,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.collectives import (
    ReplicaDivergenceError,
    replica_divergence,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.watchdog import (
    compile_budget_env,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel import mesh as pmesh
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel import sharding
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.distributed import (
    agree_compile_budget_crossed,
    all_reduce_mean_grads,
    all_reduce_sum,
    host_step_stats,
    mesh_group,
    rank,
    world_size,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.optim import (
    build_optimizer,
    clip_by_global_norm,
    global_norm,
    set_lr,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.logging import get_logger
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.results import (
    write_results_file,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.timing import (
    StepMeter,
    Stopwatch,
)

logger = get_logger(__name__)


def _masked_sums(per_example, correct, valid):
    """Masked loss/correct sums and count, plus the mean loss over the
    valid rows."""
    valid = valid.float()
    count = valid.sum()
    loss_sum = (per_example.float() * valid).sum()
    correct_sum = (correct.float() * valid).sum()
    loss = loss_sum / torch.clamp(count, min=1.0)
    return loss, {"loss_sum": loss_sum, "correct": correct_sum, "count": count}


def _packed_kwargs(batch) -> dict:
    """A token-packed batch's ``segment_ids`` (block-diagonal attention per
    packed example) and ``position_ids`` (restarting per example), only
    those present, so unpacked batches reach models that take neither (the
    JAX ``_packed_kwargs``)."""
    return {k: batch[k] for k in ("segment_ids", "position_ids") if k in batch}


def seq_cls_loss(model, batch):
    """Cross-entropy from logits and accuracy (Keras
    ``SparseCategoricalCrossentropy(from_logits=True)`` /
    ``SparseCategoricalAccuracy``): ``(mean loss, sums)``."""
    logits = model(batch["input_ids"], batch["attention_mask"],
                   token_type_ids=batch.get("token_type_ids"), **_packed_kwargs(batch))
    per_ex = softmax_cross_entropy_with_integer_labels(logits, batch["labels"])
    valid = batch.get("valid")
    if valid is None:
        valid = torch.ones_like(per_ex)
    correct = logits.argmax(-1) == batch["labels"]
    return _masked_sums(per_ex, correct, valid)


def token_cls_loss(model, batch, with_f1: bool = True):
    """Token-level CE with label masking (labels == -100 ignored, the HF
    convention; the CoNLL NER task). The sums add the TOKEN-level
    micro-F1 components over the non-O tags (tag 0 is outside):
    ``f1_tp``, ``f1_fp`` and ``f1_fn``. Published CoNLL figures are
    ENTITY-level (seqeval) F1, which is stricter."""
    logits = model(batch["input_ids"], batch["attention_mask"],
                   token_type_ids=batch.get("token_type_ids"), **_packed_kwargs(batch))
    labels = batch["labels"]
    token_valid = (labels != -100) & (batch["attention_mask"] > 0)
    if "valid" in batch:
        token_valid = token_valid & (batch["valid"][:, None] > 0)
    safe_labels = labels.clamp(min=0)
    per_tok = softmax_cross_entropy_with_integer_labels(logits, safe_labels)
    pred = logits.argmax(-1)
    correct = pred == safe_labels
    loss, sums = _masked_sums(per_tok, correct, token_valid)
    if with_f1:
        v = token_valid.float()
        sums["f1_tp"] = (((pred != 0) & correct).float() * v).sum()
        sums["f1_fp"] = (((pred != 0) & ~correct).float() * v).sum()
        sums["f1_fn"] = (((safe_labels != 0) & ~correct).float() * v).sum()
    return loss, sums


def qa_loss(model, batch):
    """SQuAD span loss: the mean of the start and end CE (HF); a row is
    half correct per position it predicts."""
    start_logits, end_logits = model(batch["input_ids"], batch["attention_mask"],
                                     token_type_ids=batch.get("token_type_ids"),
                                     **_packed_kwargs(batch))
    valid = batch.get("valid")
    if valid is None:
        valid = torch.ones(start_logits.shape[0], device=start_logits.device)
    starts, ends = batch["start_positions"], batch["end_positions"]
    s_ce = softmax_cross_entropy_with_integer_labels(start_logits, starts)
    e_ce = softmax_cross_entropy_with_integer_labels(end_logits, ends)
    s_ok = (start_logits.argmax(-1) == starts).float()
    e_ok = (end_logits.argmax(-1) == ends).float()
    return _masked_sums(0.5 * (s_ce + e_ce), 0.5 * (s_ok + e_ok), valid)


def causal_lm_loss(model, batch):
    """Next-token CE for decoder-only LMs (GPT-2): logits at position i
    predict token i+1; pad targets (and padded eval rows) are masked out.
    Metric is next-token accuracy."""
    logits = model(batch["input_ids"], batch["attention_mask"],
                   **_packed_kwargs(batch))[:, :-1]                       # [B, S-1, V]
    labels = batch["labels"][:, 1:]
    token_valid = (batch["attention_mask"][:, 1:] > 0) & (labels != -100)
    if "valid" in batch:
        token_valid = token_valid & (batch["valid"][:, None] > 0)
    safe_labels = labels.clamp(min=0)
    per_tok = softmax_cross_entropy_with_integer_labels(logits, safe_labels)
    correct = logits.argmax(-1) == safe_labels
    return _masked_sums(per_tok, correct, token_valid)


def rtd_loss(model, batch):
    """Replaced-token detection (ELECTRA pretraining): per-token binary CE
    on whether the token was replaced; -100 and pad positions are ignored.
    Metric is detection accuracy."""
    logits = model(batch["input_ids"], batch["attention_mask"],
                   token_type_ids=batch.get("token_type_ids"),
                   **_packed_kwargs(batch))                                   # [B, S]
    labels = batch["labels"]
    token_valid = (labels != -100) & (batch["attention_mask"] > 0)
    if "valid" in batch:
        token_valid = token_valid & (batch["valid"][:, None] > 0)
    target = labels.clamp(min=0).float()
    x = logits.float()
    # optax.sigmoid_binary_cross_entropy: -t log σ(x) - (1 - t) log σ(-x)
    per_tok = -target * F.logsigmoid(x) - (1.0 - target) * F.logsigmoid(-x)
    correct = (logits > 0) == (target > 0.5)
    return _masked_sums(per_tok, correct, token_valid)


def seq2seq_loss(model, batch, epsilon: float = 0.0):
    """Teacher-forced LM cross-entropy over the target tokens (labels ==
    -100 ignored); the metric is next-token accuracy. With ``epsilon > 0``
    a training forward (``model.training``) smooths the labels uniformly:
    ``(1 - eps) CE + eps (lse - mean logit)``, from the logits, no one-hot;
    eval keeps the plain CE."""
    logits = model(batch["input_ids"], batch["attention_mask"], batch["decoder_input_ids"],
                   batch.get("decoder_attention_mask"))
    labels = batch["labels"]
    token_valid = labels != -100
    if "valid" in batch:
        token_valid = token_valid & (batch["valid"][:, None] > 0)
    safe_labels = labels.clamp(min=0)
    per_tok = softmax_cross_entropy_with_integer_labels(logits, safe_labels)
    if epsilon > 0 and model.training:
        lf = logits.float()
        per_tok = (1.0 - epsilon) * per_tok + epsilon * (torch.logsumexp(lf, dim=-1)
                                                         - lf.mean(-1))
    correct = logits.argmax(-1) == safe_labels
    return _masked_sums(per_tok, correct, token_valid)


def make_fused_causal_lm_loss(model):
    """``causal_lm_loss`` without the [B, S, V] logits: the model's
    ``hidden_and_embedding`` feeds the fused vocab cross-entropy
    (``ops/vocab_ce.py``: the CUDA kernels on the card). Instead of
    slicing off the last position, labels are shifted left with a -100
    tail, so every position is computed and the last is masked: the same
    masked sums as ``causal_lm_loss``. Packed rows run K2 on all ``B·S``
    rows too: each segment's first label is -100, so nothing crosses a
    boundary."""

    def loss(model, batch):
        hidden, embedding = model.hidden_and_embedding(batch["input_ids"],
                                                       batch["attention_mask"],
                                                       **_packed_kwargs(batch))
        B, S, H = hidden.shape
        labels, attn = batch["labels"], batch["attention_mask"]
        shifted = torch.cat([labels[:, 1:], labels.new_full((B, 1), -100)], dim=1)
        token_valid = torch.cat([(attn[:, 1:] > 0) & (labels[:, 1:] != -100),
                                 torch.zeros_like(attn[:, :1], dtype=torch.bool)], dim=1)
        if "valid" in batch:
            token_valid = token_valid & (batch["valid"][:, None] > 0)
        safe_labels = shifted.clamp(min=0)
        per_tok, pred = fused_vocab_cross_entropy(hidden.reshape(B * S, H), embedding,
                                                  safe_labels.reshape(B * S))
        correct = pred.reshape(B, S) == safe_labels
        return _masked_sums(per_tok.reshape(B, S), correct, token_valid)

    return loss


def make_fused_seq2seq_loss(label_smoothing: float = 0.0):
    """``seq2seq_loss`` without the [B, T, V] logits: the model's
    ``seq2seq_hidden_and_embedding`` (the decoder hidden, T5's tied-head
    scale applied, and the LM weight) feeds the fused vocab cross-entropy
    (``ops/vocab_ce.py``: the CUDA kernels on the card) on all ``B·T``
    rows; the labels align with the decoder positions, so nothing is
    shifted or gathered. ``label_smoothing`` goes into the kernels on
    training forwards; eval is the plain CE."""

    def loss(model, batch):
        hidden, weight = model.seq2seq_hidden_and_embedding(
            batch["input_ids"], batch["attention_mask"], batch["decoder_input_ids"],
            batch.get("decoder_attention_mask"))
        B, T, H = hidden.shape
        labels = batch["labels"]
        token_valid = labels != -100
        if "valid" in batch:
            token_valid = token_valid & (batch["valid"][:, None] > 0)
        safe_labels = labels.clamp(min=0)
        eps = label_smoothing if model.training else 0.0
        per_tok, pred = fused_vocab_cross_entropy(hidden.reshape(B * T, H), weight,
                                                  safe_labels.reshape(B * T), eps)
        return _masked_sums(per_tok.reshape(B, T), pred.reshape(B, T) == safe_labels,
                            token_valid)

    return loss


# rows a fused MLM step's K is rounded up to: the JAX package's block_n, so
# K and ce_dropped equal its own
MLM_ROW_QUANTUM = 256


def mlm_gather_rows(n: int, mask_cap: float) -> int:
    """K, the static number of rows the fused MLM loss gathers out of
    ``n`` tokens: ``mask_cap`` of them rounded up to ``MLM_ROW_QUANTUM``,
    at most ``n`` (the JAX ``make_fused_mlm_loss``'s K)."""
    return min(n, -(-int(n * mask_cap) // MLM_ROW_QUANTUM) * MLM_ROW_QUANTUM)


def mlm_gather_index(flags, k: int):
    """The ``k`` rows the fused MLM loss keeps out of ``flags [n]`` (1 for
    a labelled token): labelled rows first, each group in index order, as
    the JAX ``lax.top_k`` on the flags keeps ties; ``torch.topk`` promises
    no order among ties, a stable descending sort does. Returns ``(index
    [k], kept row is labelled [k])``."""
    flags = flags.to(torch.int32)
    sel = torch.sort(flags, descending=True, stable=True).indices[:k]
    return sel, flags.index_select(0, sel) > 0


def bias_fold_width(h_dim: int) -> int:
    """The hidden width with the decoder bias folded in: the next multiple
    of 8 past ``h_dim`` (``[h | 1 | 0...]``, ``[W | b | 0...]``), 16-byte
    rows in bf16 for the tensor-core kernels (776 at BERT-base, where dW
    stays under its 800 cap)."""
    return (h_dim // 8 + 1) * 8


def make_fused_mlm_loss(mask_cap: float):
    """The MLM loss without the [B, S, V] logits: only about 15% of the
    positions carry a label, so ``mlm_gather_rows`` rows (masked positions
    first, in index order: :func:`mlm_gather_index`) are gathered into a
    static ``[K, E]`` buffer, and only those go through the fused vocab
    cross-entropy (``ops/vocab_ce.py``: the CUDA kernels on the card); a
    static K needs no host sync. The decoder bias is folded into the same
    kernels by widening ``h -> [h | 1 | 0...]`` and ``W -> [W | b | 0...]``
    to :func:`bias_fold_width`, so ``h'·W'ᵀ = h·Wᵀ + b`` exactly and the
    bias gradient comes out of the concat's backward (``W'`` is a new fp32
    ``[V, E']`` tensor each step). Positions past K
    (none at 15% masking under the default cap of 25%) drop out of both the
    loss and the count; ``ce_dropped`` counts them. With several ranks each
    gathers from its own batch, the JAX package's per-shard gather."""

    def loss(model, batch):
        hidden, table, bias = model(batch["input_ids"], batch["attention_mask"],
                                    token_type_ids=batch.get("token_type_ids"),
                                    return_fused_inputs=True, **_packed_kwargs(batch))
        labels = batch["labels"]
        token_valid = (labels != -100) & (batch["attention_mask"] > 0)
        if "valid" in batch:
            token_valid = token_valid & (batch["valid"][:, None] > 0)
        B, S, E = hidden.shape
        n = B * S
        k = mlm_gather_rows(n, mask_cap)
        sel, sel_valid = mlm_gather_index(token_valid.reshape(n), k)
        h_sel = hidden.reshape(n, E).index_select(0, sel)
        lab_sel = labels.clamp(min=0).reshape(n).index_select(0, sel)
        pad = bias_fold_width(E) - E
        h_tail = torch.zeros(k, pad, dtype=h_sel.dtype, device=h_sel.device)
        h_tail[:, 0] = 1
        w_tail = torch.zeros(table.shape[0], pad - 1, dtype=table.dtype, device=table.device)
        w_aug = torch.cat([table, bias[:, None].to(table.dtype), w_tail], dim=1)
        per_tok, pred = fused_vocab_cross_entropy(torch.cat([h_sel, h_tail], dim=1),
                                                  w_aug, lab_sel)
        loss_val, sums = _masked_sums(per_tok, pred == lab_sel, sel_valid)
        # supervision the static cap dropped (0 while the masking rate stays
        # under mask_cap): measured, not silent
        sums["ce_dropped"] = token_valid.float().sum() - sums["count"]
        return loss_val, sums

    return loss


TASK_LOSSES = {"seq-cls": seq_cls_loss, "token-cls": token_cls_loss, "qa": qa_loss,
               "causal-lm": causal_lm_loss,
               # CE over the vocab at the masked positions: token-cls's
               # shape without the NER F1 (vocab id 0 is a token, not a tag)
               "mlm": functools.partial(token_cls_loss, with_f1=False),
               "rtd": rtd_loss, "seq2seq": seq2seq_loss}


def _full_state_dict(model, optimizer) -> tuple[dict, dict]:
    """The whole model and optimizer state of a sharded model on rank 0's
    host, ``{}`` on every other rank (``torch.distributed.checkpoint.
    state_dict``; each tensor gathered and offloaded in turn, so no card
    holds the whole state; rank 0 is the one that writes it)."""
    from torch.distributed.checkpoint.state_dict import StateDictOptions, get_state_dict

    return get_state_dict(model, optimizer,
                          options=StateDictOptions(full_state_dict=True, cpu_offload=True))


def _load_full_state_dict(model, optimizer, model_state: dict, optim_state: dict) -> None:
    """:func:`_full_state_dict`'s output put back from rank 0's copy, one
    tensor at a time broadcast to the ranks, each keeping its shards (the
    other ranks' copies are not read)."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        set_model_state_dict,
        set_optimizer_state_dict,
    )

    if dist.get_rank() != 0:
        model_state, optim_state = {}, {}
    # two calls: ``set_state_dict`` skips the model where its state is empty
    options = StateDictOptions(full_state_dict=True, broadcast_from_rank0=True)
    set_model_state_dict(model, model_state, options=options)
    set_optimizer_state_dict(model, optimizer, optim_state, options=options)


def _load_whole_grads(params: list, grads: list, device) -> None:
    """Rank 0's whole gradient accumulators (``grads``; the other ranks'
    are not read) broadcast one at a time, each rank keeping its shard of
    each as its parameter's ``.grad``."""
    rank0 = dist.get_rank() == 0
    layout = [[None if g is None else (tuple(g.shape), g.dtype) for g in grads]
              if rank0 else None]
    dist.broadcast_object_list(layout, src=0)
    if len(layout[0]) != len(params):
        raise ValueError(f"{len(layout[0])} saved accumulators for {len(params)} parameters")
    for i, (p, info) in enumerate(zip(params, layout[0])):
        if info is None:
            p.grad = None
            continue
        whole = grads[i].to(device) if rank0 else torch.empty(info[0], dtype=info[1],
                                                               device=device)
        dist.broadcast(whole, src=0)
        p.grad = sharding.dtensor_like(whole, p)


def _closing(batches):
    """A batch iterator as a context that closes it on exit (a prefetching
    iterator stops its thread); one without ``close`` as it is."""
    return contextlib.closing(batches) if hasattr(batches, "close") else \
        contextlib.nullcontext(batches)


class Trainer:
    """Train/eval engine over the model's device, data-parallel over the
    ``torch.distributed`` ranks when a process group is up."""

    def __init__(self, config: TrainConfig, model, task: Optional[str] = None,
                 total_steps: Optional[int] = None, mesh=None):
        self.config = config
        self.model = model
        mesh = getattr(model, "mesh", None) or mesh
        # the seq axis: its size, and the mesh every forward runs under
        self.sp = pmesh.mesh_shape(mesh)[pmesh.AXIS_SEQ] if mesh is not None else 1
        sharding.check_sequence_parallel(model, self.sp)
        if mesh is not None and not sharding.is_sharded(model):
            shape = pmesh.mesh_shape(mesh)
            tp = shape[pmesh.AXIS_TENSOR]
            if shape[pmesh.AXIS_FSDP] > 1 or tp > 1:
                # at tp 1 the plan would only route every Linear through
                # DTensor dispatch (host time, no work): FSDP2 alone
                sharding.shard_model(model, mesh, tensor_plan=tp > 1)
        self.task = task or config.task
        if self.task not in TASK_LOSSES:
            raise ValueError(f"no loss for task {self.task!r}")
        self.loss_fn = TASK_LOSSES[self.task]
        if config.label_smoothing > 0:
            # the config allows smoothing for task='seq2seq' only
            self.loss_fn = functools.partial(seq2seq_loss, epsilon=config.label_smoothing)
        if config.fused_vocab_ce:
            if self.task == "causal-lm" and hasattr(model, "hidden_and_embedding"):
                self.loss_fn = make_fused_causal_lm_loss(model)
            elif self.task == "mlm" and hasattr(model, "mlm_head"):
                self.loss_fn = make_fused_mlm_loss(config.fused_mlm_mask_cap)
            elif self.task == "seq2seq" and hasattr(model, "seq2seq_hidden_and_embedding"):
                self.loss_fn = make_fused_seq2seq_loss(config.label_smoothing)
            else:
                raise ValueError(
                    "fused_vocab_ce requires task='causal-lm' with a model "
                    "exposing hidden_and_embedding (GPT-2 family), "
                    "task='mlm' with a return_fused_inputs-capable MLM model "
                    "(BERT-family), or task='seq2seq' with a model exposing "
                    "seq2seq_hidden_and_embedding (T5/BART)")
        self.device = next(model.parameters()).device
        self.n_chips = world_size()
        # the replicas of a batch (the tensor ranks of one share its rows);
        # the group the loss sums are summed over (None: every rank)
        self.dp_size, self._dp_group = self.n_chips, None
        self.sharded = sharding.is_sharded(model)
        self.mesh = None
        if self.sharded or self.sp > 1:
            if config.lora_rank > 0:
                raise NotImplementedError(
                    "lora_rank>0 over a sharded or sequence-parallel mesh is not "
                    "ported to the PyTorch package yet: ROADMAP queue 1, item 11 "
                    "(parallelism beyond DP)")
            self.mesh = mesh
            self.n_chips = pmesh.world_size(mesh)
            self.dp_size = pmesh.data_parallel_size(mesh)
            self._dp_group = mesh_group(mesh, (pmesh.AXIS_DATA, pmesh.AXIS_FSDP))
        # LoRA (models/lora.py): the base is frozen but the heads
        # lora_train_heads matches, and the adapters join the trainable
        # parameters, so the optimizer state, the clip, the all-reduce and
        # the accumulated gradients cover those only
        self.lora: Optional[dict] = None
        self.lora_scaling: Optional[float] = None
        adapters: list = []
        if config.lora_rank > 0:
            adapters = self._init_lora(config)
        self.params = [p for p in model.parameters() if p.requires_grad] + adapters
        self.optimizer, self.schedule, self.scaled_lr = build_optimizer(
            config, self.params, world_size=self.dp_size, total_steps=total_steps)
        self.step = 0            # micro-steps taken
        self.updates = 0         # optimizer updates applied
        for p in self.params:
            p.grad = None
        # the anomaly detector's grad-norm series costs one reduction per
        # update, paid only when a detector will read it
        self._emit_grad_norm = obs.configured() and anomaly_enabled_env()
        # --keep_best (HF load_best_model_at_end): host snapshot of the
        # best epoch's weights and the watched metric's best value
        self._best_params: Optional[dict] = None
        self._best_metric: Optional[float] = None
        self.best_epoch: Optional[int] = None

    def _init_lora(self, config: TrainConfig) -> list:
        """Freeze the base, attach fresh adapters (``A`` from
        ``torch.Generator(seed)``); returns them as trainable parameters in
        path order."""
        lora = lo.init_lora_params(self.model, config.lora_rank, config.lora_targets,
                                   seed=config.seed)
        self.lora = {path: {k: torch.nn.Parameter(v) for k, v in ab.items()}
                     for path, ab in lora.items()}
        self.lora_scaling = lo.lora_scaling(config.lora_rank, config.lora_alpha)
        heads = lo.freeze_base(self.model, config.lora_train_heads)
        lo.attach_lora(self.model, self.lora, self.lora_scaling)
        n_heads = sum(self.model.get_parameter(n).numel() for n in heads)
        logger.info("LoRA r=%d alpha=%g targets=%s: %d adapter + %d head "
                    "trainable / %d frozen params", config.lora_rank, config.lora_alpha,
                    config.lora_targets, lo.count_params(self.lora), n_heads,
                    lo.count_params(self.model) - n_heads)
        return [ab[k] for ab in self.lora.values() for k in ("a", "b")]

    @property
    def export_params(self) -> dict:
        """The deployable weights as a ``state_dict``: with LoRA the base
        and the adapters merged (what ``save_pretrained`` writes), else the
        model's own. After a ``keep_best`` fit they are the best epoch's."""
        if self.sharded:
            return sharding.export_state(self.model)   # a collective
        if self.lora is None:
            return self.model.state_dict()
        return lo.merge_lora(self.model, self.lora, self.lora_scaling)

    # -- state (what a checkpoint holds) ---------------------------------------

    def state_dict(self) -> dict:
        """Everything that makes a resumed run equal an uninterrupted one:
        model and optimizer state, the micro-step and update counts (the
        LR schedule's position), the partial gradient accumulators (None
        between updates) and the generators that draw dropout. The
        tensors are the live ones: the checkpointer copies them."""
        rng = {"cpu": torch.get_rng_state()}
        if self.device.type == "cuda":
            rng["cuda"] = torch.cuda.get_rng_state(self.device)
        if self.sharded:
            # the gathered state (a collective), in the mesh's own layout,
            # on rank 0's host only: the other ranks' is empty (no model,
            # no optimizer state, every accumulator None)
            model_state, optim_state = _full_state_dict(self.model, self.optimizer)
            return {"model": model_state, "optimizer": optim_state,
                    "step": self.step, "updates": self.updates,
                    "grads": [None if p.grad is None else sharding.whole_on_rank0(p.grad)
                              for p in self.params], "rng": rng}
        state = {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                 "step": self.step, "updates": self.updates,
                 "grads": [p.grad for p in self.params], "rng": rng}
        if self.lora is not None:
            state["lora"] = self.lora
        return state

    def load_state_dict(self, state: dict) -> None:
        """Put a :meth:`state_dict` (e.g. a restored checkpoint's, on the
        CPU) back into the live trainer (over a mesh: onto the mesh it was
        saved from)."""
        if self.sharded:
            _load_full_state_dict(self.model, self.optimizer, state["model"],
                                  state["optimizer"])
        else:
            self.model.load_state_dict(state["model"])
            if self.lora is not None:
                self._load_lora(state["lora"])
            self.optimizer.load_state_dict(state["optimizer"])
        self.step, self.updates = int(state["step"]), int(state["updates"])
        if self.sharded:
            _load_whole_grads(self.params, state["grads"], self.device)
        else:
            for p, g in zip(self.params, state["grads"], strict=True):
                p.grad = None if g is None else g.to(p.device)
        torch.set_rng_state(state["rng"]["cpu"])
        if self.device.type == "cuda":
            torch.cuda.set_rng_state(state["rng"]["cuda"], self.device)

    @torch.no_grad()
    def _load_lora(self, lora: dict) -> None:
        """Copy saved adapters into the live ones (the attached modules and
        the optimizer hold these parameter objects)."""
        if set(lora) != set(self.lora):
            raise ValueError("the saved adapters target other kernels than this run's")
        for path, ab in lora.items():
            for k, v in ab.items():
                self.lora[path][k].copy_(v)

    def check_replica_divergence(self) -> float:
        """Verify the parameter replicas agree across the ranks (over a mesh:
        each shard across the ``data`` and ``seq`` axes). Returns the
        relative deviation; raises ``ReplicaDivergenceError`` beyond
        ``config.divergence_tol``. Called before each checkpoint save, so
        a divergent replica is never persisted silently."""
        if self.mesh is not None:
            axes = (pmesh.AXIS_DATA, pmesh.AXIS_SEQ) if self.sp > 1 else (pmesh.AXIS_DATA,)
            rel = replica_divergence(self.params, mesh_group(self.mesh, axes))
        else:
            rel = replica_divergence(self.params)
        if rel > self.config.divergence_tol:
            raise ReplicaDivergenceError(
                f"parameter replicas diverge (relative deviation {rel:.3e} > "
                f"tol {self.config.divergence_tol:.1e}); refusing to "
                "checkpoint — restore from the last good checkpoint")
        return rel

    # -- steps ---------------------------------------------------------------

    def train_step(self, batch) -> dict:
        """One micro-step; returns device scalars ``loss``/``accuracy``
        (and ``grad_norm`` at an update, when the anomaly detector reads
        it)."""
        with self._under_mesh():
            return self._train_step(batch)

    def _under_mesh(self):
        """The mesh as the ambient one when its ``seq`` axis is active (the
        ring models split their sequence under it), else nothing."""
        return pmesh.use_mesh(self.mesh) if self.sp > 1 else contextlib.nullcontext()

    def _train_step(self, batch) -> dict:
        cfg = self.config
        accum = cfg.gradient_accumulation_steps
        self.model.train()
        loss, sums = self.loss_fn(self.model, batch)
        # the MoE layers' Switch aux losses of this forward join the task
        # loss (the JAX Trainer's sown "losses"), on every loss path
        aux = moe_aux_loss(self.model, world=self.dp_size)
        objective = loss if aux is None else loss + aux
        if self.dp_size > 1:
            # the global valid count first: each rank's share of the global
            # mean is loss_sum * dp_size / count (the gradient all-reduce, or
            # FSDP2's reduce-scatter, divides by dp_size); the aux loss is
            # already the global batch's, the same on every rank
            parts = [sums["count"], sums["loss_sum"].detach(), sums["correct"]]
            totals = all_reduce_sum(torch.stack(parts), self._dp_group)
            count = torch.clamp(totals[0], min=1.0)
            objective = sums["loss_sum"] * self.dp_size / count
            loss = totals[1] / count
            if aux is not None:
                objective = objective + aux
                loss = loss + aux.detach()
            sums = {"correct": totals[2], "count": totals[0]}
        elif aux is not None:
            loss = objective
        (objective / accum if accum > 1 else objective).backward()
        self.step += 1
        metrics = {}
        if self.step % accum == 0:
            if not self.sharded:         # FSDP2 has reduced them in backward
                all_reduce_mean_grads(self.params)
            elif self.sp > 1:            # over data x fsdp; seq is left
                all_reduce_mean_grads(self.params, pmesh.seq_group(self.mesh))
            norm = None
            if cfg.max_grad_norm > 0:
                norm = clip_by_global_norm(self.params, cfg.max_grad_norm)
            elif self._emit_grad_norm:
                norm = global_norm(self.params)
            if self._emit_grad_norm:
                metrics["grad_norm"] = norm
            set_lr(self.optimizer, self.schedule(self.updates))
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self.updates += 1
        acc = sums["correct"] / torch.clamp(sums["count"], min=1.0)
        return {"loss": loss.detach(), "accuracy": acc.detach(), **metrics}

    @torch.no_grad()
    def eval_step(self, batch) -> dict:
        self.model.eval()
        with self._under_mesh():
            _, sums = self.loss_fn(self.model, batch)
        moe_aux_loss(self.model)         # evaluation reports the task loss alone
        return sums

    # -- keep-best -------------------------------------------------------------

    def _best_snapshot(self) -> dict:
        """Host copy of the weights ``--keep_best`` must preserve (the
        replicas are equal, so every rank copies its own). Under LoRA only
        what can change: the adapters and the trainable heads, not the
        frozen base."""
        def host(t):
            # over a mesh every rank keeps its own shard
            return sharding.local_tensor(t.detach()).to("cpu", copy=True)

        if self.lora is None:
            return {k: host(v) for k, v in self.model.state_dict().items()}
        return {"lora": {p: {k: host(v) for k, v in ab.items()} for p, ab in self.lora.items()},
                "heads": {n: host(p) for n, p in self.model.named_parameters()
                          if p.requires_grad}}

    @torch.no_grad()
    def _restore_best(self) -> None:
        """load_best_model_at_end: put the best snapshot back into the live
        model, then release the host copy."""
        if self.sharded:
            for name, value in self.model.state_dict().items():
                sharding.local_tensor(value).copy_(self._best_params[name])
        elif self.lora is None:
            self.model.load_state_dict(self._best_params)
        else:
            self._load_lora(self._best_params["lora"])
            for name, value in self._best_params["heads"].items():
                self.model.get_parameter(name).copy_(value)
        self._best_params = None

    # -- loops ---------------------------------------------------------------

    def fit(self, train_batcher, epochs: Optional[int] = None, checkpointer=None,
            start_epoch: int = 0, start_step_in_epoch: int = 0,
            eval_batcher=None) -> dict:
        """Epoch loop (Keras ``model.fit``); returns the history dict.

        Step metrics stay on the device until a log or checkpoint sync
        point. A mid-epoch resume (``start_step_in_epoch``) continues the
        epoch's permutation from the next unseen batch. With
        ``eval_batcher`` every epoch ends with an eval pass; ``keep_best``
        snapshots the weights whenever ``best_metric`` improves and loads
        the best back at the end, and ``early_stopping_patience`` stops
        after that many epochs without improvement."""
        cfg = self.config
        epochs = cfg.epochs if epochs is None else epochs
        # telemetry: the compile tracker, the heartbeat (and its stall
        # dump) and the anomaly detector exist only on instrumented runs,
        # so an uninstrumented fit starts no thread
        obs_files = obs.has_sink()
        heartbeat = None
        if obs_files:
            obs.compile_tracker()
            heartbeat = obs.heartbeat().start()
            heartbeat.watch_current_thread()
        detector = obs.anomalies() if obs.configured() else None
        if detector is not None:
            detector.begin_fit()
        fpt, dec_fpt = obs.flops.trainer_flops_per_token(
            getattr(self.model, "config", None), self.task, cfg.max_seq_length)
        peak = obs.flops.peak_tflops(torch.cuda.get_device_name(self.device)
                                     if self.device.type == "cuda" else None)
        meter = StepMeter(n_chips=self.n_chips, device=self.device,
                          sink=obs.metrics() if obs_files else None,
                          flops_per_token=fpt, dec_flops_per_token=dec_fpt,
                          peak_tflops=peak)
        # one (tokens, dec_tokens) entry per batch, popped per step; x the
        # replica count approximates the global figure (shards are balanced)
        tok_scale = self.dp_size
        token_log = getattr(train_batcher, "token_log", None)
        history: dict[str, list] = {"loss": [], "sparse_categorical_accuracy": []}
        steps_per_epoch = train_batcher.steps_per_epoch()
        if cfg.steps_per_epoch:
            steps_per_epoch = min(steps_per_epoch, cfg.steps_per_epoch)
        if start_step_in_epoch >= steps_per_epoch:
            # a mid-epoch checkpoint landed exactly on the epoch boundary
            start_epoch, start_step_in_epoch = start_epoch + 1, 0
        gbs = train_batcher.global_batch_size
        profiler = None
        first_step = True
        # with length bucketing the first step of each NEW batch width pays
        # the kernels' and the allocator's first use at that shape: the
        # meter excludes it as it does the run's first step
        track_shapes = bool(getattr(train_batcher, "bucket_sizes", None))
        seen_shapes: set = set()

        def sync(metrics_list):
            with obs.span("train/sync"):
                fetched = [{k: float(v) for k, v in m.items()} for m in metrics_list]
            window = meter.end_window()
            meter.begin_window()
            if detector is not None:
                if window is not None:
                    detector.observe_step_time(meter._steps, window["step_time_s"])
                for m in fetched:
                    detector.observe_loss(meter._steps, m["loss"])
                    if "grad_norm" in m:
                        detector.observe_grad_norm(meter._steps, m["grad_norm"])
            return fetched

        if eval_batcher is None and (cfg.keep_best or cfg.early_stopping_patience > 0):
            logger.warning(
                "keep_best/early_stopping_patience are set but fit() got no "
                "eval_batcher — both are inert this run")
        epochs_since_best = 0

        def obs_fit_done():
            # runs when fit raises too: an armed stall watchdog over a dead
            # loop would dump a false stall
            if heartbeat is not None:
                heartbeat.unwatch()
            if obs_files:
                obs.flush()

        with contextlib.ExitStack() as epilogue, Stopwatch(self.device) as sw:
            epilogue.callback(obs_fit_done)
            for epoch in range(start_epoch, epochs):
                start_step = start_step_in_epoch if epoch == start_epoch else 0
                device_metrics: list = []
                losses, accs = [], []
                if token_log is not None:
                    # a batch staged last epoch but never dispatched (the
                    # steps_per_epoch cap) would misalign every pop
                    token_log.clear()
                meter.begin_window()
                # closed on every exit (the steps_per_epoch cap, an
                # exception): the prefetch thread stops, the staged batches go
                with _closing(train_batcher.global_arrays(epoch, start_step)) as batch_iter:
                    for step, batch in enumerate(batch_iter, start=start_step):
                        if step >= steps_per_epoch:
                            break
                        if cfg.profile and profiler is None and epoch == start_epoch \
                                and step - start_step == 3:
                            profiler = start_profiler(self.device.type)
                        new_width = False
                        if track_shapes:
                            sig = tuple(tuple(v.shape) for v in batch.values())
                            if sig not in seen_shapes:
                                seen_shapes.add(sig)
                                new_width = not first_step
                        if new_width:
                            # close the running window (the meter waits for
                            # the card) before the new width's first step
                            meter.end_window()
                        with obs.span("train/step_dispatch"):
                            metrics = self.train_step(batch)
                        device_metrics.append(metrics)
                        meter.window_step(gbs)
                        if token_log:
                            # one entry per dispatched step: the stager's
                            # lookahead entry stays for the next step
                            tok, dec = token_log.popleft()
                            meter.window_tokens(tok * tok_scale, dec * tok_scale)
                        obs.pulse()
                        if first_step or new_width:
                            # the first step builds the kernels and warms the
                            # allocator, a new width's first step meets its
                            # shapes: keep each (and its tokens) out of the
                            # throughput window
                            meter.exclude_step(gbs)
                            meter.begin_window()
                            first_step = False
                        if profiler is not None and step - start_step == 6:
                            self._stop_profiler(profiler)
                            profiler = None
                        want_log = cfg.log_every_steps and step % cfg.log_every_steps == 0
                        want_ckpt = (checkpointer is not None and cfg.checkpoint_every_steps
                                     and (step + 1) % cfg.checkpoint_every_steps == 0)
                        if want_log or want_ckpt:
                            for m in sync(device_metrics):
                                losses.append(m["loss"])
                                accs.append(m["accuracy"])
                            device_metrics = []
                        if want_log:
                            logger.info(
                                "epoch %d step %d/%d loss %.4f acc %.4f (%.1f samples/s/chip)",
                                epoch, step, steps_per_epoch, losses[-1], accs[-1],
                                meter.samples_per_sec_per_chip)
                            gstep = epoch * steps_per_epoch + step
                            obs.scalar("train/loss", losses[-1], gstep)
                            obs.scalar("train/accuracy", accs[-1], gstep)
                            obs.scalar("train/samples_per_sec_per_chip",
                                       meter.samples_per_sec_per_chip, gstep)
                        if want_ckpt:
                            if cfg.check_divergence:
                                self.check_replica_divergence()
                            # checkpoint wall time is not step time: bracket it
                            # out of the throughput window
                            meter.end_window()
                            with obs.span("train/checkpoint"):
                                checkpointer.save(self.state_dict(), epoch=epoch,
                                                  step_in_epoch=step + 1)
                            meter.begin_window()
                for m in sync(device_metrics):
                    losses.append(m["loss"])
                    accs.append(m["accuracy"])
                # the epoch boundary's eval and checkpoint are not step time
                meter.end_window()
                history["loss"].append(float(np.mean(losses)) if losses else float("nan"))
                history["sparse_categorical_accuracy"].append(
                    float(np.mean(accs)) if accs else float("nan"))
                logger.info("epoch %d done: loss %.4f acc %.4f", epoch,
                            history["loss"][-1], history["sparse_categorical_accuracy"][-1])
                obs.scalar("train/epoch_loss", history["loss"][-1], epoch)
                if obs.configured():
                    # straggler visibility: a collective, guarded by a
                    # condition that is the same on every rank
                    stats = host_step_stats(meter.avg_step_time, self.device)
                    if stats is not None:
                        obs.scalar("train/step_time_hosts_mean", stats["mean"], epoch,
                                   args=stats)
                        if detector is not None:
                            detector.observe_straggler(epoch, stats)
                if (compile_budget_env() is not None and world_size() > 1
                        and not obs.compile_budget_agreed()):
                    # the budget is crossed at a rank-local instant, so the
                    # ranks agree on it here, in a collective whose guard is
                    # the same on every rank; once latched, every rank's
                    # bucket ladder stops minting new widths from the same
                    # step
                    if agree_compile_budget_crossed(obs.compile_budget_exceeded(),
                                                    self.device):
                        obs.set_compile_budget_agreed()
                        logger.info("compile budget crossing agreed across %d ranks "
                                    "at epoch %d: bucket ladders stop minting new "
                                    "widths", world_size(), epoch)
                stop_early = False
                if eval_batcher is not None:
                    res = self.evaluate(eval_batcher)
                    history.setdefault("eval_loss", []).append(res["eval_loss"])
                    history.setdefault("eval_accuracy", []).append(res["eval_accuracy"])
                    logger.info("epoch %d eval: loss %.4f acc %.4f", epoch,
                                res["eval_loss"], res["eval_accuracy"])
                    obs.scalar("eval/loss", res["eval_loss"], epoch)
                    obs.scalar("eval/accuracy", res["eval_accuracy"], epoch)
                    if cfg.keep_best or cfg.early_stopping_patience > 0:
                        metric = res[cfg.best_metric]
                        if self._best_metric is None:
                            better = True
                        elif cfg.best_metric.endswith("accuracy"):
                            better = metric > self._best_metric
                        else:
                            better = metric < self._best_metric
                        if better:
                            self._best_metric = metric
                            self.best_epoch = epoch
                            epochs_since_best = 0
                            if cfg.keep_best:
                                self._best_params = self._best_snapshot()
                            logger.info("epoch %d is the new best (%s %.4f)",
                                        epoch, cfg.best_metric, metric)
                        else:
                            epochs_since_best += 1
                            patience = cfg.early_stopping_patience
                            if patience and epochs_since_best >= patience:
                                logger.info("early stop at epoch %d: no %s improvement "
                                            "for %d epochs", epoch, cfg.best_metric,
                                            patience)
                                stop_early = True
                if checkpointer is not None:
                    if cfg.check_divergence:
                        self.check_replica_divergence()
                    with obs.span("train/checkpoint"):
                        checkpointer.save(self.state_dict(), epoch=epoch + 1)
                if stop_early:
                    break
            if profiler is not None:   # an epoch shorter than the profiled steps
                self._stop_profiler(profiler)
            if cfg.keep_best and self._best_params is not None:
                # load_best_model_at_end: the final eval and the export see
                # the best epoch's weights; the optimizer state is not
                # rewound (training is over, and a resume reads the
                # checkpoint, not this)
                self._restore_best()
                logger.info("restored best epoch %d weights into the live model (%s %.4f)",
                            self.best_epoch, cfg.best_metric, self._best_metric)
            meter.end_window()

        history["train_runtime"] = sw.elapsed
        history["train_samples_per_second"] = round(meter.samples_per_sec, 3)
        history["train_samples_per_second_per_chip"] = round(
            meter.samples_per_sec_per_chip, 3)
        achieved = meter.achieved_tflops_per_chip
        if achieved is not None:
            history["train_achieved_tflops_per_chip"] = round(achieved, 6)
            if meter.mfu is not None:
                history["train_mfu"] = round(meter.mfu, 5)
        if obs_files:
            obs.scalar("train/runtime", sw.elapsed)
            obs.scalar("train/samples_per_sec_per_chip_final", meter.samples_per_sec_per_chip)
            obs.scalar("train/compile_excluded_steps", meter.excluded_steps)
            if meter.mfu is not None:
                obs.scalar("train/mfu_final", meter.mfu)
        self.meter = meter
        return history

    def _stop_profiler(self, profiler) -> None:
        """Close the ``--profile`` window: wait for the card, write the
        Chrome trace under ``profile_dir``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        path = os.path.join(self.config.profile_dir,
                            f"train_rank{rank()}_{time.time_ns()}.pt.trace.json")
        stop_profiler(profiler, path)
        logger.info("profile of the train steps written to %s", path)

    def evaluate(self, eval_batcher) -> dict:
        """Keras ``model.evaluate``: loss and accuracy over exactly the
        valid rows of every rank; token-cls adds ``eval_f1``, the micro-F1
        over the non-O tags from the summed counts."""
        totals: dict = {}
        with obs.span("eval/run"), _closing(eval_batcher.global_arrays(epoch=0)) as batches:
            for batch in batches:
                for key, val in self.eval_step(batch).items():
                    totals[key] = totals.get(key, 0.0) + val.float()
                obs.pulse()
        # the loss's keys are the same on every rank (and the JAX order)
        keys = ["loss_sum", "correct", "count"] + [k for k in totals if k.startswith("f1_")]
        with obs.span("eval/sync"):
            flat = all_reduce_sum(torch.stack([torch.as_tensor(totals.get(k, 0.0),
                                                               device=self.device).float()
                                               for k in keys]), self._dp_group)
            totals = dict(zip(keys, (float(x) for x in flat)))
        count = max(totals["count"], 1.0)
        results = {"eval_loss": totals["loss_sum"] / count,
                   "eval_accuracy": totals["correct"] / count}
        if "f1_tp" in totals:
            tp, fp, fn = totals["f1_tp"], totals["f1_fp"], totals["f1_fn"]
            results["eval_f1"] = 2 * tp / max(2 * tp + fp + fn, 1.0)
        return results

    # -- results (the reference's train_results.txt / eval_results.txt) ------

    def write_train_results(self, history: dict) -> None:
        write_results_file(self.config.output_data_dir, "train_results.txt",
                           history, logger=logger)

    def write_eval_results(self, results: dict) -> None:
        write_results_file(self.config.output_data_dir, "eval_results.txt",
                           results, logger=logger)
