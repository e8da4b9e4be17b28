"""Streaming data tier: corpora larger than host RAM (counterpart of the
JAX package's ``data/streaming.py``, tasks ``seq-cls``, ``causal-lm``,
``mlm`` and ``seq2seq``).

Only a line-offset index stays resident (8 bytes a row against about
2 KB a row materialized at sequence 512); each batch window is read,
tokenized and padded on demand, feeding the same ``ShardedBatcher``:
epoch permutations, per-rank sharding, prefetch and the feed to the card
are unchanged. A row's content depends only on its index, not on the
batch that gathers it, so every rank materializes identical global
batches, and a mid-epoch resume replays identical data. ``mlm`` masks
each row from its own ``RandomState([seed, epoch, row])``, so its masks
too depend on the row and the epoch alone (not bit-equal to the
materialized tier's corpus-wide draw). ``seq2seq`` reads ``source`` and
``target`` fields of a ``.jsonl`` corpus and builds each batch through
``ArrayDataset.from_seq2seq``, so its columns are the materialized tier's.

Reads are coalesced: rows whose byte ranges lie within a gap of each
other are fetched in one read, and the gap tunes itself per batch from
the bytes read but not used (``obs.autotune("data/read_coalesce_gap")``).
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.pipeline import (
    ArrayDataset,
    apply_mlm_masking,
    encode_mlm_clean,
)


class LineCorpus:
    """Offset-indexed view of a ``.txt`` (one text per line) or
    ``.jsonl`` (``{"text": ..., "label": ...}``) file.

    Resident state is one int64 offset per line; texts are read back on
    demand. The index builds in one pass of the C++ host library
    (``native=False``: the Python line loop)."""

    def __init__(self, path: str, text_key: str = "text",
                 label_key: str = "label", max_rows: Optional[int] = None,
                 native: bool = True):
        from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.native import (
            native_line_boundaries,
        )

        self.path = path
        self.text_key = text_key
        self.label_key = label_key
        self._jsonl = path.endswith((".jsonl", ".json"))
        # the C++ scan, or the Python line loop on request (the same index)
        boundaries = native_line_boundaries(path, native=native)
        # drop a trailing empty line's phantom record (LF or CRLF)
        n = len(boundaries) - 1
        if n and boundaries[-1] - boundaries[-2] <= 2:
            with open(path, "rb") as f:
                f.seek(int(boundaries[-2]))
                if not f.readline().strip():
                    n -= 1
        if max_rows is not None:
            n = min(n, max_rows)
        self._offsets = np.asarray(boundaries[: n + 1], np.int64)
        # adaptive read coalescing (the streaming half of the input-
        # pipeline autotuning story): rows whose byte ranges sit within
        # ``_coalesce_gap`` of each other are fetched in ONE read — an
        # epoch permutation has real locality inside a batch window, and
        # one syscall per row is the dominant cost on networked
        # filesystems. The gap self-tunes per batch from the observed
        # waste ratio (gap bytes read but not used): shrink fast when
        # reads are mostly waste, grow while they are nearly all signal.
        self._coalesce_gap = 64 * 1024
        self._coalesce_gap_max = 1 << 20

    def __len__(self) -> int:
        return len(self._offsets) - 1

    def _read_lines(self, idx: np.ndarray) -> list[str]:
        """Raw decoded lines for ``idx``, in ``idx`` order (the ONE
        seek/read/decode path — reads happen in file order for seek
        locality, coalesced into one read per near-adjacent run)."""
        order = np.argsort(idx, kind="stable")
        rows = np.asarray(idx, np.int64)[order]
        offsets = self._offsets
        out: list[Optional[str]] = [None] * len(idx)
        gap = self._coalesce_gap
        reads = 0
        bytes_read = 0
        bytes_used = 0
        # span: how much of the producer thread's time is raw file I/O
        # (vs tokenize/mask) — the streaming half of the input-bound story
        with obs.span("data/corpus_read"):
            with open(self.path, "rb") as f:
                i = 0
                while i < len(rows):
                    j0 = i
                    start = int(offsets[rows[i]])
                    end = int(offsets[rows[i] + 1])
                    # duplicates/overlaps coalesce too (negative gap)
                    while (i + 1 < len(rows)
                           and int(offsets[rows[i + 1]]) - end <= gap):
                        i += 1
                        end = max(end, int(offsets[rows[i] + 1]))
                    f.seek(start)
                    blob = f.read(end - start)
                    reads += 1
                    bytes_read += len(blob)
                    for j in range(j0, i + 1):
                        r = int(rows[j])
                        lo = int(offsets[r]) - start
                        hi = int(offsets[r + 1]) - start
                        out[order[j]] = blob[lo:hi].decode(
                            "utf-8").rstrip("\r\n")
                        bytes_used += hi - lo
                    i += 1
        if reads and bytes_read:
            waste = max(0.0, 1.0 - min(bytes_used, bytes_read) / bytes_read)
            if waste > 0.5:
                self._coalesce_gap = gap // 4
            elif waste < 0.1 and gap < self._coalesce_gap_max:
                # grow from wherever we are (floor 64, not a big jump):
                # a sparse corpus that converged below a few KB must not
                # be bounced straight back into the wasteful regime
                self._coalesce_gap = max(gap * 2, 64)
            if self._coalesce_gap != gap:
                obs.autotune("data/read_coalesce_gap", self._coalesce_gap,
                             "waste_high" if waste > 0.5 else "waste_low",
                             args={"reads": reads, "rows": len(rows),
                                   "waste": round(waste, 3)})
        return out

    def read_records(self, idx: np.ndarray) -> list[dict]:
        """Raw jsonl records for ``idx``, in ``idx`` order (jsonl files
        only — .txt lines carry no fields)."""
        if not self._jsonl:
            raise ValueError("read_records needs a .jsonl corpus")
        return [json.loads(line) for line in self._read_lines(idx)]

    def read_rows(self, idx: np.ndarray) -> tuple[list[str], Optional[list[int]]]:
        """Texts (and labels for jsonl rows that carry them) for ``idx``,
        in ``idx`` order."""
        if not self._jsonl:
            return self._read_lines(idx), None
        texts: list[Optional[str]] = [None] * len(idx)
        labels: list[Optional[int]] = [None] * len(idx)
        any_label = False
        for j, rec in enumerate(self.read_records(idx)):
            texts[j] = rec[self.text_key]
            if self.label_key in rec:
                labels[j] = int(rec[self.label_key])
                any_label = True
        return texts, (labels if any_label else None)


class StreamingTextDataset:
    """``ArrayDataset``-compatible streaming source for ``seq-cls``,
    ``causal-lm``, ``mlm`` and ``seq2seq`` over a :class:`LineCorpus`.

    Duck-types the batcher contract (``__len__``, ``__getitem__`` with an
    index array, ``begin_epoch``); only the gathered batch is ever
    tokenized or resident. Length bucketing needs corpus-wide token
    lengths, which streaming deliberately does not precompute: the
    batcher raises on that combination. ``seq2seq_kwargs`` pass through to
    ``from_seq2seq`` (``max_target_length``, the decoder start, pad and
    EOS ids, and ``source_key``/``target_key``)."""

    def __init__(self, corpus: LineCorpus, tokenizer, task: str = "seq-cls",
                 max_length: int = 512, num_labels: Optional[int] = None,
                 mlm_probability: float = 0.15, whole_word: bool = True,
                 seed: int = 0, seq2seq_kwargs: Optional[dict] = None):
        if task not in ("mlm", "causal-lm", "seq-cls", "seq2seq"):
            raise ValueError(
                "streaming tier supports mlm/causal-lm/seq-cls/seq2seq, "
                f"got {task!r}")
        if task == "mlm" and getattr(tokenizer, "mask_token_id", None) is None:
            raise ValueError("tokenizer has no [MASK] token — MLM needs one")
        if task == "seq2seq" and not corpus._jsonl:
            raise ValueError(
                "seq2seq streaming needs a .jsonl corpus with "
                "source/target fields (.txt lines carry no fields) — "
                "failing now beats a KeyError at the first batch")
        self.corpus = corpus
        self.tokenizer = tokenizer
        self.task = task
        self.max_length = max_length
        self.num_labels = num_labels
        self.mlm_probability = mlm_probability
        self.whole_word = whole_word
        self.seed = seed
        self.seq2seq_kwargs = dict(seq2seq_kwargs or {})
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.corpus)

    def begin_epoch(self, epoch: int) -> None:
        """Keep the epoch for the MLM masks' seeds; nothing is read here."""
        self._epoch = epoch

    def resident_bytes(self) -> int:
        """Host memory the dataset itself holds (the offset index)."""
        return self.corpus._offsets.nbytes

    def __getitem__(self, idx) -> dict[str, np.ndarray]:
        with obs.span("data/stream_batch"):
            return self._materialize(idx)

    def _materialize(self, idx) -> dict[str, np.ndarray]:
        if not isinstance(idx, np.ndarray):
            idx = np.atleast_1d(np.asarray(idx, np.int64))
        if self.task == "seq2seq":
            kw = dict(self.seq2seq_kwargs)
            src_key, tgt_key = kw.pop("source_key", "source"), kw.pop("target_key", "target")
            records = self.corpus.read_records(idx)
            return ArrayDataset.from_seq2seq(
                self.tokenizer, [r[src_key] for r in records], [r[tgt_key] for r in records],
                max_source_length=self.max_length, **kw).columns
        texts, labels = self.corpus.read_rows(idx)
        if self.task == "mlm":
            return self._mlm_rows(idx, texts)
        enc = self.tokenizer(texts, truncation=True, padding="max_length",
                             max_length=self.max_length)
        ids = np.asarray(enc["input_ids"], np.int32)
        am = np.asarray(enc["attention_mask"], np.int32)
        if self.task == "causal-lm":
            return {"input_ids": ids, "attention_mask": am,
                    "labels": np.where(am > 0, ids, -100).astype(np.int32)}
        if labels is None:
            raise ValueError("seq-cls streaming needs jsonl labels")
        missing = [int(idx[j]) for j, label in enumerate(labels) if label is None]
        if missing:
            raise ValueError(
                f"seq-cls streaming: rows {missing[:8]} carry no "
                f"'{self.corpus.label_key}' field — every jsonl row needs a label")
        if self.num_labels is not None:
            top = max(labels)
            if top >= self.num_labels:
                raise ValueError(
                    f"seq-cls: corpus row carries label {top} but num_labels is "
                    f"{self.num_labels}; pass --num_labels {top + 1}")
        return {"input_ids": ids, "attention_mask": am,
                "labels": np.asarray(labels, np.int32)}

    def _mlm_rows(self, idx: np.ndarray, texts: list) -> dict[str, np.ndarray]:
        """Clean-tokenize the window, then mask each row from its own
        ``(seed, epoch, row)`` stream: independent of the batch's rows."""
        clean, am, wid = encode_mlm_clean(self.tokenizer, texts, self.max_length)
        ids = np.empty_like(clean)
        labels = np.empty_like(clean)
        vocab = int(self.tokenizer.vocab_size)
        mask_id = int(self.tokenizer.mask_token_id)
        for j, r in enumerate(idx):
            rng = np.random.RandomState([self.seed & 0x7FFFFFFF, self._epoch, int(r)])
            row_ids, row_labels = apply_mlm_masking(
                clean[j: j + 1], wid[j: j + 1], rng, mask_id, vocab,
                self.mlm_probability, self.whole_word)
            ids[j] = row_ids[0]
            labels[j] = row_labels[0]
        return {"input_ids": ids, "attention_mask": am, "labels": labels}
