"""Input pipeline: static-shape batching and per-rank sharding
(counterpart of the JAX package's ``ArrayDataset.from_texts``,
``ArrayDataset.from_lm_texts`` and ``ShardedBatcher``,
``data/pipeline.py``).

Every rank builds the same seeded epoch permutation (the JAX package's
splitmix64 order, bit for bit) and takes its slice of each global batch,
so the global order is agreed with no communication. Train batches drop
the remainder; eval batches pad the tail with row 0 and carry a ``valid``
column so padded rows count for nothing. :meth:`ShardedBatcher.
global_arrays` hands the trainer tensors on its device, copied from
pinned host memory on CUDA. ``start_step`` continues an epoch's
permutation from that batch (mid-epoch resume), and ``token_log`` counts
each batch's real tokens for the trainer's MFU accounting. Length
bucketing, the prefetch thread, the H2D stager and packing wait for a
later slice (ROADMAP slice 2 follow-ups).
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs


def epoch_permutation(n: int, seed: int) -> np.ndarray:
    """The JAX package's platform-independent epoch permutation
    (``data/native.py::_py_permutation``): indices stably sorted by a
    per-index splitmix64 key."""
    u = np.uint64
    m64 = u(0xFFFFFFFFFFFFFFFF)
    seedmix = u((seed * 0xD1342543DE82EF95 + 0x2545F4914F6CDD1D) & int(m64))
    idx = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = (seedmix ^ (idx * u(0x9E3779B97F4A7C15))) + u(0x9E3779B97F4A7C15)
        z = (z ^ (z >> u(30))) * u(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> u(27))) * u(0x94D049BB133111EB)
        z = z ^ (z >> u(31))
    return np.argsort(z, kind="stable").astype(np.int64)


@dataclass
class ArrayDataset:
    """Column dict of host-resident numpy arrays with equal leading dim."""

    columns: dict[str, np.ndarray]

    def __post_init__(self):
        sizes = {k: len(v) for k, v in self.columns.items()}
        if len(set(sizes.values())) > 1:
            raise ValueError(f"ragged columns: {sizes}")

    def __len__(self) -> int:
        return len(next(iter(self.columns.values())))

    def __getitem__(self, idx) -> dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.columns.items()}

    @classmethod
    def from_texts(cls, tokenizer, texts, labels=None, max_length: int = 512,
                   text_pairs=None) -> "ArrayDataset":
        """Tokenize and pad to ``max_length`` in one call."""
        enc = tokenizer(texts, truncation=True, padding="max_length",
                        max_length=max_length, text_pairs=text_pairs)
        cols = {"input_ids": enc["input_ids"], "attention_mask": enc["attention_mask"]}
        if "token_type_ids" in enc:
            cols["token_type_ids"] = enc["token_type_ids"]
        if labels is not None:
            cols["labels"] = np.asarray(labels, np.int32)
        return cls(cols)

    @classmethod
    def from_lm_texts(cls, tokenizer, texts, max_length: int = 512,
                      packed: bool = False,
                      eos_token_id: Optional[int] = None) -> "ArrayDataset":
        """Causal-LM corpus: labels are the input ids themselves (the
        trainer's causal-lm loss shifts them); pad positions get -100.
        ``eos_token_id`` serves the packed layout only, which is not ported
        yet (``packed=True`` raises)."""
        if packed:
            raise NotImplementedError(
                "packed LM rows (packed=True) are not ported to the PyTorch "
                "package yet: ROADMAP slice B (packing)")
        enc = tokenizer(texts, truncation=True, padding="max_length",
                        max_length=max_length)
        ids = np.asarray(enc["input_ids"], np.int32)
        mask = np.asarray(enc["attention_mask"], np.int32)
        labels = np.where(mask > 0, ids, -100).astype(np.int32)
        return cls({"input_ids": ids, "attention_mask": mask, "labels": labels})


def _rank_and_world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class ShardedBatcher:
    """Iterates global batches, yielding this rank's shard of each.

    ``process_index``/``process_count`` default to the ``torch.distributed``
    rank and world size (0 and 1 without a process group); ``device`` is
    where :meth:`global_arrays` puts the tensors (CPU by default)."""

    def __init__(self, dataset: ArrayDataset, global_batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_remainder: bool = True,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None, device=None):
        self.dataset = dataset
        self.global_batch_size = global_batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        rank, world = _rank_and_world()
        self.process_index = rank if process_index is None else process_index
        self.process_count = world if process_count is None else process_count
        if global_batch_size % self.process_count != 0:
            raise ValueError(f"global batch {global_batch_size} not divisible by "
                             f"{self.process_count} ranks")
        self.per_host = global_batch_size // self.process_count
        self.device = torch.device("cpu" if device is None else device)
        # MFU accounting: one (tokens, dec_tokens) entry of REAL
        # (attention-mask) tokens per batch :meth:`global_arrays` yields,
        # which the trainer pops once per step. Counted only when an MFU
        # figure can be read (telemetry configured, or a peak override
        # set), as in the JAX package; bounded so eval never grows it.
        self._count_tokens = obs.state().enabled and (
            obs.configured() or obs.flops.env_peak_tflops() is not None)
        self.token_log: collections.deque = collections.deque(maxlen=8192)

    def steps_per_epoch(self) -> int:
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.global_batch_size
        return (n + self.global_batch_size - 1) // self.global_batch_size

    def local_batches(self, epoch: int = 0, start_step: int = 0
                      ) -> Iterator[dict[str, np.ndarray]]:
        """Yield rank-local numpy batches (with the ``valid`` column)."""
        n = len(self.dataset)
        order = epoch_permutation(n, self.seed + epoch) if self.shuffle else np.arange(n)
        lo_rank = self.process_index * self.per_host
        hi_rank = lo_rank + self.per_host
        for s in range(start_step, self.steps_per_epoch()):
            lo = s * self.global_batch_size
            global_idx = order[lo: lo + self.global_batch_size]
            valid_n = len(global_idx)
            if valid_n < self.global_batch_size:
                pad = np.zeros(self.global_batch_size - valid_n, dtype=order.dtype)
                global_idx = np.concatenate([global_idx, pad])
            batch = self.dataset[global_idx[lo_rank:hi_rank]]
            valid = np.zeros(self.global_batch_size, np.int32)
            valid[:valid_n] = 1
            batch["valid"] = valid[lo_rank:hi_rank]
            yield batch

    def global_arrays(self, epoch: int = 0, start_step: int = 0
                      ) -> Iterator[dict[str, torch.Tensor]]:
        """This rank's batches as tensors on ``device`` (int64 token and
        label columns; on CUDA copied from pinned memory without blocking
        the host)."""
        cuda = self.device.type == "cuda"
        for batch in self.local_batches(epoch, start_step):
            if self._count_tokens:
                self.token_log.append((int(np.count_nonzero(batch["attention_mask"])), 0))
            out = {}
            for key, value in batch.items():
                t = torch.from_numpy(np.ascontiguousarray(value))
                if key != "valid":
                    t = t.long()
                if cuda:
                    t = t.pin_memory().to(self.device, non_blocking=True)
                out[key] = t
            yield out
