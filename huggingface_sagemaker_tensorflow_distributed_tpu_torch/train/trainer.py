"""The training engine: train/eval steps and the epoch loop (counterpart
of the JAX package's ``train/trainer.py``: ``_masked_sums``, the task
losses ``seq_cls_loss`` and ``causal_lm_loss``, the fused
``make_fused_causal_lm_loss``, and ``Trainer`` for tasks ``seq-cls`` and
``causal-lm``).

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
- ``fit`` keeps the JAX epoch loop: ``steps_per_epoch`` cap,
  ``log_every_steps`` sync points, per-epoch eval with
  ``eval_each_epoch``, the Keras-style history (``loss``,
  ``sparse_categorical_accuracy``, ``eval_loss``/``eval_accuracy``),
  ``train_runtime`` and ``train_samples_per_second[_per_chip]`` with the
  first (warm-up) step excluded from the meter. Step metrics stay on the
  device until a sync point.
- ``evaluate`` sums loss, correct predictions and the count exactly over
  the ``valid`` rows, across ranks.

Telemetry (``obs``), anomaly detection, MFU, checkpointing and keep-best
wait for later slices (ROADMAP slice 2 follow-ups).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.config import TrainConfig
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.losses import (
    softmax_cross_entropy_with_integer_labels,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.vocab_ce import (
    fused_vocab_cross_entropy,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.distributed import (
    all_reduce_mean_grads,
    all_reduce_sum,
    world_size,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.optim import (
    build_optimizer,
    clip_by_global_norm,
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


def seq_cls_loss(model, batch):
    """Cross-entropy from logits and accuracy (Keras
    ``SparseCategoricalCrossentropy(from_logits=True)`` /
    ``SparseCategoricalAccuracy``): ``(mean loss, sums)``."""
    logits = model(batch["input_ids"], batch["attention_mask"],
                   token_type_ids=batch.get("token_type_ids"))
    per_ex = softmax_cross_entropy_with_integer_labels(logits, batch["labels"])
    valid = batch.get("valid")
    if valid is None:
        valid = torch.ones_like(per_ex)
    correct = logits.argmax(-1) == batch["labels"]
    return _masked_sums(per_ex, correct, valid)


def causal_lm_loss(model, batch):
    """Next-token CE for decoder-only LMs (GPT-2): logits at position i
    predict token i+1; pad targets (and padded eval rows) are masked out.
    Metric is next-token accuracy."""
    logits = model(batch["input_ids"], batch["attention_mask"])[:, :-1]   # [B, S-1, V]
    labels = batch["labels"][:, 1:]
    token_valid = (batch["attention_mask"][:, 1:] > 0) & (labels != -100)
    if "valid" in batch:
        token_valid = token_valid & (batch["valid"][:, None] > 0)
    safe_labels = labels.clamp(min=0)
    per_tok = softmax_cross_entropy_with_integer_labels(logits, safe_labels)
    correct = logits.argmax(-1) == safe_labels
    return _masked_sums(per_tok, correct, token_valid)


def make_fused_causal_lm_loss(model):
    """``causal_lm_loss`` without the [B, S, V] logits: the model's
    ``hidden_and_embedding`` feeds the fused vocab cross-entropy
    (``ops/vocab_ce.py``: the CUDA kernels on the card). Instead of
    slicing off the last position, labels are shifted left with a -100
    tail, so every position is computed and the last is masked: the same
    masked sums as ``causal_lm_loss``."""

    def loss(model, batch):
        hidden, embedding = model.hidden_and_embedding(batch["input_ids"],
                                                       batch["attention_mask"])
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


TASK_LOSSES = {"seq-cls": seq_cls_loss, "causal-lm": causal_lm_loss}


class Trainer:
    """Train/eval engine over the model's device, data-parallel over the
    ``torch.distributed`` ranks when a process group is up."""

    def __init__(self, config: TrainConfig, model, task: Optional[str] = None,
                 total_steps: Optional[int] = None):
        self.config = config
        self.model = model
        self.task = task or config.task
        if self.task not in TASK_LOSSES:
            raise NotImplementedError(f"task {self.task!r} is not ported to the "
                                      "PyTorch package yet: ROADMAP slices B/C")
        self.loss_fn = TASK_LOSSES[self.task]
        if config.fused_vocab_ce:
            if self.task == "causal-lm" and hasattr(model, "hidden_and_embedding"):
                self.loss_fn = make_fused_causal_lm_loss(model)
            else:
                raise ValueError(
                    "fused_vocab_ce requires task='causal-lm' with a GPT-2 "
                    "model (one exposing hidden_and_embedding); the fused "
                    "MLM and seq2seq losses are not ported yet: ROADMAP "
                    "slices B and C")
        self.device = next(model.parameters()).device
        self.n_chips = world_size()
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer, self.schedule, self.scaled_lr = build_optimizer(
            config, self.params, world_size=self.n_chips, total_steps=total_steps)
        self.step = 0            # micro-steps taken
        self.updates = 0         # optimizer updates applied
        for p in self.params:
            p.grad = None

    # -- steps ---------------------------------------------------------------

    def train_step(self, batch) -> dict:
        """One micro-step; returns device scalars ``loss``/``accuracy``."""
        cfg = self.config
        accum = cfg.gradient_accumulation_steps
        self.model.train()
        loss, sums = self.loss_fn(self.model, batch)
        objective = loss
        if self.n_chips > 1:
            # the global valid count first: each rank's share of the global
            # mean is loss_sum * world / count (the gradient all-reduce
            # divides by world)
            totals = all_reduce_sum(torch.stack([sums["count"], sums["loss_sum"].detach(),
                                                 sums["correct"]]))
            count = torch.clamp(totals[0], min=1.0)
            objective = sums["loss_sum"] * self.n_chips / count
            loss = totals[1] / count
            sums = {"correct": totals[2], "count": totals[0]}
        (objective / accum if accum > 1 else objective).backward()
        self.step += 1
        if self.step % accum == 0:
            all_reduce_mean_grads(self.params)
            if cfg.max_grad_norm > 0:
                clip_by_global_norm(self.params, cfg.max_grad_norm)
            set_lr(self.optimizer, self.schedule(self.updates))
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self.updates += 1
        acc = sums["correct"] / torch.clamp(sums["count"], min=1.0)
        return {"loss": loss.detach(), "accuracy": acc.detach()}

    @torch.no_grad()
    def eval_step(self, batch) -> dict:
        self.model.eval()
        _, sums = self.loss_fn(self.model, batch)
        return sums

    # -- loops ---------------------------------------------------------------

    def fit(self, train_batcher, epochs: Optional[int] = None,
            eval_batcher=None) -> dict:
        """Epoch loop (Keras ``model.fit``); returns the history dict."""
        cfg = self.config
        epochs = cfg.epochs if epochs is None else epochs
        meter = StepMeter(n_chips=self.n_chips, device=self.device)
        history: dict[str, list] = {"loss": [], "sparse_categorical_accuracy": []}
        steps_per_epoch = train_batcher.steps_per_epoch()
        if cfg.steps_per_epoch:
            steps_per_epoch = min(steps_per_epoch, cfg.steps_per_epoch)
        gbs = train_batcher.global_batch_size
        first_step = True

        def sync(metrics_list):
            fetched = [{k: float(v) for k, v in m.items()} for m in metrics_list]
            meter.end_window()
            meter.begin_window()
            return fetched

        with Stopwatch(self.device) as sw:
            for epoch in range(epochs):
                device_metrics: list = []
                losses, accs = [], []
                meter.begin_window()
                for step, batch in enumerate(train_batcher.global_arrays(epoch)):
                    if step >= steps_per_epoch:
                        break
                    metrics = self.train_step(batch)
                    device_metrics.append(metrics)
                    meter.window_step(gbs)
                    if first_step:
                        # the first step builds the kernels and warms the
                        # allocator: keep it out of the throughput window
                        meter.exclude_step(gbs)
                        meter.begin_window()
                        first_step = False
                    if cfg.log_every_steps and step % cfg.log_every_steps == 0:
                        for m in sync(device_metrics):
                            losses.append(m["loss"])
                            accs.append(m["accuracy"])
                        device_metrics = []
                        logger.info(
                            "epoch %d step %d/%d loss %.4f acc %.4f (%.1f samples/s/chip)",
                            epoch, step, steps_per_epoch, losses[-1], accs[-1],
                            meter.samples_per_sec_per_chip)
                for m in sync(device_metrics):
                    losses.append(m["loss"])
                    accs.append(m["accuracy"])
                meter.end_window()
                history["loss"].append(float(np.mean(losses)) if losses else float("nan"))
                history["sparse_categorical_accuracy"].append(
                    float(np.mean(accs)) if accs else float("nan"))
                logger.info("epoch %d done: loss %.4f acc %.4f", epoch,
                            history["loss"][-1], history["sparse_categorical_accuracy"][-1])
                if eval_batcher is not None:
                    res = self.evaluate(eval_batcher)
                    history.setdefault("eval_loss", []).append(res["eval_loss"])
                    history.setdefault("eval_accuracy", []).append(res["eval_accuracy"])
                    logger.info("epoch %d eval: loss %.4f acc %.4f", epoch,
                                res["eval_loss"], res["eval_accuracy"])
            meter.end_window()

        history["train_runtime"] = sw.elapsed
        history["train_samples_per_second"] = round(meter.samples_per_sec, 3)
        history["train_samples_per_second_per_chip"] = round(
            meter.samples_per_sec_per_chip, 3)
        self.meter = meter
        return history

    def evaluate(self, eval_batcher) -> dict:
        """Keras ``model.evaluate``: loss and accuracy over exactly the
        valid rows of every rank."""
        totals = {"loss_sum": torch.zeros((), device=self.device),
                  "correct": torch.zeros((), device=self.device),
                  "count": torch.zeros((), device=self.device)}
        for batch in eval_batcher.global_arrays(epoch=0):
            for key, val in self.eval_step(batch).items():
                totals[key] += val.float()
        flat = all_reduce_sum(torch.stack([totals["loss_sum"], totals["correct"],
                                           totals["count"]]))
        loss_sum, correct, count = (float(x) for x in flat)
        count = max(count, 1.0)
        return {"eval_loss": loss_sum / count, "eval_accuracy": correct / count}

    # -- results (the reference's train_results.txt / eval_results.txt) ------

    def write_train_results(self, history: dict) -> None:
        write_results_file(self.config.output_data_dir, "train_results.txt",
                           history, logger=logger)

    def write_eval_results(self, results: dict) -> None:
        write_results_file(self.config.output_data_dir, "eval_results.txt",
                           results, logger=logger)
