"""Input pipeline: batching, per-rank sharding, length bucketing and the
feed to the card (counterpart of the JAX package's ``ArrayDataset.
from_texts``, ``ArrayDataset.from_lm_texts``, the prefetch machinery and
``ShardedBatcher``, ``data/pipeline.py``).

Every rank builds the same seeded epoch permutation (the JAX package's
splitmix64 order, bit for bit) and takes its slice of each global batch,
so the global order is agreed with no communication. Train batches drop
the remainder; eval batches pad the tail with row 0 and carry a ``valid``
column so padded rows count for nothing. ``start_step`` continues an
epoch's permutation from that batch (mid-epoch resume).

- **Length bucketing** (``bucket_sizes``): rows are sorted by length
  inside windows of ``bucket_window`` batches, and each batch's token
  columns are cut to the smallest bucket width that holds the global
  batch's longest row (every rank agrees). The row lengths come from
  the C++ host library (``data/native.py``).
- **The feed** (:meth:`ShardedBatcher.global_arrays`): with
  ``prefetch="auto"`` a :class:`PrefetchIterator` gathers (and, for a
  streaming dataset, reads and tokenizes) batches on a thread, its queue
  depth set by the :class:`~.autotune.PrefetchAutotuner`, and an
  :class:`H2DStager` stages batch N+1 onto the card while the trainer
  computes on batch N. On CUDA a batch is copied from pinned host buffers
  that are kept and reused, on a side stream; the consumer's stream waits
  on that copy's event and the staged tensors are recorded on it. On the
  CPU the stager only converts. ``token_log`` holds each staged batch's
  real tokens for the trainer's MFU accounting, popped once per step.

- **Masked LM** (:func:`apply_mlm_masking`, :class:`MlmDataset`): whole-
  word masking drawn from a ``numpy.random.RandomState``, bit for bit the
  JAX package's draw; an :class:`MlmDataset` re-draws its masks for each
  epoch from ``seed + epoch``, and the batcher calls its ``begin_epoch``
  before the epoch and before each gather (on the prefetch thread when
  one runs), so a mid-epoch resume replays the same masks.

- **Token packing** (:func:`pack_examples`, ``ArrayDataset.pack``,
  ``ShardedBatcher(pack=True)``): short examples share rows first-fit
  decreasing, with ``segment_ids`` (1-based, 0 on padding) and
  ``position_ids`` (restarting per example) columns that the models turn
  into a block-diagonal ``[B, 1, S, S]`` mask and per-example positions;
  ``from_lm_texts(packed=True)`` is the other layout, EOS-joined documents
  cut into full rows.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Iterator, Optional, Union

import numpy as np
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.autotune import (
    PrefetchAutotuner,
)


def encode_mlm_clean(tokenizer, texts, max_length: int):
    """Tokenize an MLM corpus without masking: ``(clean_ids,
    attention_mask, word_ids)``, the inputs every masking draw starts
    from (the materialized and the streaming tiers share it)."""
    import re

    if getattr(tokenizer, "mask_token_id", None) is None:
        raise ValueError("tokenizer has no [MASK] token — MLM needs one "
                         "(BERT-family vocabs ship it)")
    if hasattr(tokenizer, "encode_text_words"):
        # HF fast tokenizers: the raw text through the tokenizer itself,
        # word ids from its encoding
        enc = tokenizer.encode_text_words(texts, max_length=max_length)
    else:
        words = [re.findall(r"\w+|[^\w\s]", t) for t in texts]
        enc = tokenizer.encode_words(words, max_length=max_length)
    return (np.asarray(enc["input_ids"], np.int32),
            np.asarray(enc["attention_mask"], np.int32),
            np.asarray(enc["word_ids"], np.int32))


def pack_examples(columns: dict[str, np.ndarray], max_length: int,
                  causal: bool = False, pad_token_id: int = 0) -> dict[str, np.ndarray]:
    """Token-pack a column dict (the JAX package's ``pack_examples``): short
    examples share ``max_length`` rows, placed first-fit decreasing (stable
    on ties, so every rank packs alike). Every 2-D column is packed by
    copying each example's real tokens (its ``attention_mask``); padding
    gets mask 0, segment 0, label -100 and ``pad_token_id``. Two columns are
    added: ``segment_ids`` (1-based per example, 0 on padding) and
    ``position_ids`` (from 0 in each example). Rows with no real token are
    dropped; per-example scalar columns (seq-cls labels) raise.

    ``causal=True`` also sets each segment's first label to -100: the
    causal-LM loss shifts labels left, so the label at a boundary would be
    the next example's first token. The unpacked loss never reads a row's
    first label either, so packed loss sums equal unpacked ones."""
    if "input_ids" not in columns or "attention_mask" not in columns:
        raise ValueError("packing needs input_ids + attention_mask columns")
    n, width = columns["attention_mask"].shape
    bad = [k for k, v in columns.items() if v.ndim != 2 or v.shape[1] != width]
    if bad:
        raise ValueError(
            f"columns {bad} are not [N, {width}] token columns — packing "
            "merges examples along the token dim, so per-example scalars "
            "(seq-cls labels) and ragged widths cannot pack")
    lengths = (columns["attention_mask"] > 0).sum(axis=1).astype(np.int64)
    if int(lengths.max(initial=0)) > max_length:
        raise ValueError(f"example of length {int(lengths.max())} exceeds the packed "
                         f"row width {max_length}")
    order = np.argsort(-lengths, kind="stable")
    bins: list[list[int]] = []
    space: list[int] = []
    for e in order:
        need = int(lengths[e])
        if need == 0:
            continue
        for b, free in enumerate(space):
            if free >= need:
                bins[b].append(int(e))
                space[b] -= need
                break
        else:
            bins.append([int(e)])
            space.append(max_length - need)
    rows = len(bins)
    out: dict[str, np.ndarray] = {}
    for k, v in columns.items():
        fill = -100 if k == "labels" else (pad_token_id if k == "input_ids" else 0)
        out[k] = np.full((rows, max_length), fill, v.dtype)
    out["segment_ids"] = np.zeros((rows, max_length), np.int32)
    out["position_ids"] = np.zeros((rows, max_length), np.int32)
    for r, members in enumerate(bins):
        o = 0
        for s, e in enumerate(members):
            ln = int(lengths[e])
            sel = columns["attention_mask"][e] > 0
            for k, v in columns.items():
                out[k][r, o: o + ln] = v[e][sel]
            out["segment_ids"][r, o: o + ln] = s + 1
            out["position_ids"][r, o: o + ln] = np.arange(ln)
            if causal and "labels" in out:
                out["labels"][r, o] = -100
            o += ln
    return out


def apply_mlm_masking(clean_ids: np.ndarray, word_ids: np.ndarray,
                      rng: np.random.RandomState, mask_token_id: int,
                      vocab_size: int, mlm_probability: float = 0.15,
                      whole_word: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """One masking draw over ``[n, L]`` clean rows -> ``(input_ids,
    labels)``, the HF collator's rule: ``mlm_probability`` of the words
    chosen (at least one in a row that has words; with ``whole_word``
    every piece of a chosen word, else each token on its own), chosen
    tokens become [MASK] 80%, a random id 10%, unchanged 10%; labels are
    -100 elsewhere. The draws depend only on the shapes, in the JAX
    package's order, so the same ``rng`` state gives its masks exactly."""
    ids = clean_ids.copy()
    labels = np.full_like(ids, -100)
    wid = word_ids
    n, width = ids.shape
    n_words = np.maximum(wid.max(axis=1) + 1, 0)
    has_words = n_words > 0
    if whole_word:
        max_w = max(int(n_words.max()), 1)
        chosen = rng.rand(n, max_w) < mlm_probability
        # "at least one word" counts only a row's real words
        real_w = np.arange(max_w)[None, :] < n_words[:, None]
        none = has_words & ~(chosen & real_w).any(axis=1)
        idx = np.flatnonzero(none)
        if len(idx):
            pick = (rng.rand(len(idx)) * n_words[idx]).astype(np.int64)
            chosen[idx, pick] = True
        sel = (wid >= 0) & np.take_along_axis(chosen, np.maximum(wid, 0), axis=1)
    else:
        sel = (wid >= 0) & (rng.rand(n, width) < mlm_probability)
        none = has_words & ~sel.any(axis=1)
        for r in np.flatnonzero(none):
            cand = np.flatnonzero(wid[r] >= 0)
            sel[r, cand[rng.randint(len(cand))]] = True
    labels[sel] = clean_ids[sel]
    action = rng.rand(n, width)
    ids[sel & (action < 0.8)] = mask_token_id
    do_rand = sel & (action >= 0.8) & (action < 0.9)
    ids[do_rand] = rng.randint(0, vocab_size, int(do_rand.sum())).astype(ids.dtype)
    return ids, labels


def shift_right(labels: np.ndarray, decoder_start_token_id: int, pad_token_id: int = 0,
                ignore_id: int = -100) -> np.ndarray:
    """Teacher-forcing decoder inputs ``[start, y_0, ..., y_{T-2}]`` with
    ignored labels mapped back to the pad id (HF ``_shift_right``)."""
    labels = np.where(labels == ignore_id, pad_token_id, labels)
    start = np.full(labels.shape[:-1] + (1,), decoder_start_token_id, labels.dtype)
    return np.concatenate([start, labels[..., :-1]], axis=-1)


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

    def pack(self, max_length: Optional[int] = None, causal: bool = False,
             pad_token_id: int = 0) -> "ArrayDataset":
        """The token-packed view of this dataset (:func:`pack_examples`):
        short examples share rows behind ``segment_ids``/``position_ids``.
        Token-level tasks only (causal-LM with ``causal=True``, MLM and
        token-cls with the default); ``max_length`` defaults to the
        dataset's width. A dataset with a per-epoch transform (MLM
        re-masking) refuses, as in the JAX package."""
        if getattr(self, "begin_epoch", None) is not None:
            raise ValueError(
                "packing re-groups rows at build time, which would freeze "
                "this dataset's per-epoch transform (MLM re-masking) — "
                "pack a plain ArrayDataset (e.g. static_masking=True)")
        if max_length is None:
            max_length = self.columns["attention_mask"].shape[1]
        return ArrayDataset(pack_examples(self.columns, max_length, causal=causal,
                                          pad_token_id=pad_token_id))

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
    def from_mlm_texts(cls, tokenizer, texts, max_length: int = 512,
                       mlm_probability: float = 0.15, whole_word: bool = True,
                       seed: int = 0, static_masking: bool = False) -> "MlmDataset":
        """Masked-LM corpus with (whole-word) masking, re-drawn each epoch
        (:class:`MlmDataset`; see :func:`apply_mlm_masking` for the
        rule). Eval iterates at epoch 0, so its masks stay fixed."""
        ids, am, wid = encode_mlm_clean(tokenizer, texts, max_length)
        return MlmDataset(
            clean_ids=ids, attention_mask=am, word_ids=wid,
            mask_token_id=int(tokenizer.mask_token_id),
            vocab_size=int(tokenizer.vocab_size), mlm_probability=mlm_probability,
            whole_word=whole_word, seed=seed, static_masking=static_masking)

    @classmethod
    def from_rtd_texts(cls, tokenizer, texts, max_length: int = 512,
                       replace_probability: float = 0.15,
                       seed: int = 0) -> "ArrayDataset":
        """Replaced-token-detection corpus (ELECTRA's pretraining shape):
        about ``replace_probability`` of the real tokens swapped for random
        ids from ``RandomState(seed)``; labels 1 where the id changed, 0 on
        untouched tokens, -100 on specials and pads. (ELECTRA draws the
        replacements from a trained generator; random replacement is the
        JAX package's offline tier.)"""
        enc = tokenizer(texts, truncation=True, padding="max_length",
                        max_length=max_length)
        ids = np.asarray(enc["input_ids"], np.int32).copy()
        am = np.asarray(enc["attention_mask"], np.int32)
        specials = {getattr(tokenizer, name, None)
                    for name in ("pad_token_id", "cls_token_id", "sep_token_id",
                                 "mask_token_id")}
        real = (am > 0) & ~np.isin(ids, [t for t in specials if t is not None])
        rng = np.random.RandomState(seed)
        vocab = int(tokenizer.vocab_size)
        pick = real & (rng.rand(*ids.shape) < replace_probability)
        draws = rng.randint(0, vocab, ids.shape).astype(np.int32)
        changed = pick & (draws != ids)
        labels = np.where(real, 0, -100).astype(np.int32)
        labels[changed] = 1
        ids = np.where(changed, draws, ids)
        return cls({"input_ids": ids, "attention_mask": am, "labels": labels})

    @classmethod
    def from_lm_texts(cls, tokenizer, texts, max_length: int = 512,
                      packed: bool = False,
                      eos_token_id: Optional[int] = None) -> "ArrayDataset":
        """Causal-LM corpus: labels are the input ids themselves (the
        trainer's causal-lm loss shifts them); pad positions get -100.

        ``packed=True`` is the pretraining layout: documents tokenized
        without padding or special tokens, each followed by
        ``eos_token_id`` (else the tokenizer's EOS, else its SEP), and the
        stream cut into full ``max_length`` rows (documents attend across
        their boundaries); the tail that would need padding is dropped."""
        if not packed:
            enc = tokenizer(texts, truncation=True, padding="max_length",
                            max_length=max_length)
            ids = np.asarray(enc["input_ids"], np.int32)
            mask = np.asarray(enc["attention_mask"], np.int32)
            labels = np.where(mask > 0, ids, -100).astype(np.int32)
            return cls({"input_ids": ids, "attention_mask": mask, "labels": labels})
        if eos_token_id is None:
            eos_token_id = getattr(tokenizer, "eos_token_id", None)
        if eos_token_id is None:
            eos_token_id = getattr(tokenizer, "sep_token_id", None)
        if eos_token_id is None:
            raise ValueError(
                "packed=True joins documents with EOS, but the tokenizer "
                "has neither eos_token_id nor sep_token_id — pass "
                "eos_token_id explicitly")
        vocab = getattr(tokenizer, "vocab_size", None)
        try:
            # an HF vocab_size leaves out added tokens; len() counts them
            vocab = max(int(vocab), len(tokenizer))
        except TypeError:
            pass
        if vocab is not None and not 0 <= int(eos_token_id) < int(vocab):
            raise ValueError(
                f"packed=True separator id {eos_token_id} is outside the "
                f"tokenizer vocab ({vocab}): the model would embed an "
                "out-of-range id every document boundary (a config.json "
                "with the default GPT-2 eos 50256 on a small-vocab test "
                "model is the usual culprit) — pass a valid eos_token_id")
        # tokenized in chunks of 1024, each padded to its own longest row
        stream: list[int] = []
        texts = list(texts)
        for lo in range(0, len(texts), 1024):
            enc = tokenizer(texts[lo: lo + 1024], truncation=False, padding="longest",
                            max_length=1 << 20, add_special_tokens=False)
            all_ids = np.asarray(enc["input_ids"])
            all_mask = np.asarray(enc["attention_mask"]) > 0
            for r in range(all_ids.shape[0]):
                stream.extend(all_ids[r][all_mask[r]].tolist())
                stream.append(int(eos_token_id))
        n_rows = len(stream) // max_length
        if n_rows == 0:
            raise ValueError(f"packed corpus shorter than one {max_length}-token row")
        ids = np.asarray(stream[: n_rows * max_length], np.int32).reshape(n_rows, max_length)
        return cls({"input_ids": ids, "attention_mask": np.ones_like(ids),
                    "labels": ids.copy()})

    @classmethod
    def from_token_classification(cls, tokenizer, sentences, word_tags,
                                  max_length: int = 512) -> "ArrayDataset":
        """Word-level NER -> token-level labels: each word's first subword
        takes its tag; continuation subwords, specials and pads take -100
        (the HF convention the token-cls loss masks on)."""
        enc = tokenizer.encode_words(sentences, max_length=max_length)
        word_ids = enc["word_ids"]
        n, L = word_ids.shape
        labels = np.full((n, L), -100, np.int32)
        for r in range(n):
            tags = word_tags[r]
            prev = -1
            for t in range(L):
                w = word_ids[r, t]
                if w < 0 or w >= len(tags):
                    continue
                if w != prev:
                    labels[r, t] = tags[w]
                prev = w
        return cls({"input_ids": enc["input_ids"], "attention_mask": enc["attention_mask"],
                    "labels": labels})

    @classmethod
    def from_qa(cls, tokenizer, questions, contexts, start_chars, answer_texts,
                max_length: int = 512, doc_stride: int = 0) -> "ArrayDataset":
        """SQuAD-style spans -> start/end token positions. ``doc_stride`` >
        0 trains on overlapping context windows (HF run_qa) instead of
        truncating long contexts: each window is a row of its own,
        labelled with the answer's tokens when it holds the whole answer
        and with CLS (0) when not."""
        enc = dict(tokenizer.encode_qa(questions, contexts, start_chars, answer_texts,
                                       max_length=max_length, doc_stride=doc_stride))
        # the window -> example map is for eval; training rows stand alone
        enc.pop("example_ids", None)
        return cls(enc)

    @classmethod
    def from_seq2seq(cls, tokenizer, sources, targets, max_source_length: int = 512,
                     max_target_length: int = 64, decoder_start_token_id: int = 0,
                     pad_token_id: int = 0, eos_token_id: int = 1) -> "ArrayDataset":
        """Source/target pairs -> encoder inputs, teacher-forcing decoder
        inputs (``shift_right`` of the labels), ``decoder_attention_mask``
        and ``-100``-masked labels. Targets are LM-style: the raw tokens
        (no CLS/SEP) and the model's EOS, so generation stops where the
        decoder learned to."""
        enc = tokenizer(sources, truncation=True, padding="max_length",
                        max_length=max_source_length)
        tgt = tokenizer(targets, truncation=True, padding="max_length",
                        max_length=max_target_length - 1, add_special_tokens=False)
        raw_ids = np.asarray(tgt["input_ids"], np.int32)
        raw_mask = np.asarray(tgt["attention_mask"], np.int32)
        n = raw_ids.shape[0]
        tgt_ids = np.full((n, max_target_length), pad_token_id, np.int32)
        tgt_mask = np.zeros((n, max_target_length), np.int32)
        tgt_ids[:, :-1] = np.where(raw_mask > 0, raw_ids, pad_token_id)
        tgt_mask[:, :-1] = raw_mask
        lengths = raw_mask.sum(axis=1)
        tgt_ids[np.arange(n), lengths] = eos_token_id
        tgt_mask[np.arange(n), lengths] = 1
        labels = np.where(tgt_mask > 0, tgt_ids, -100).astype(np.int32)
        dec_in = shift_right(labels, decoder_start_token_id, pad_token_id).astype(np.int32)
        return cls({"input_ids": enc["input_ids"], "attention_mask": enc["attention_mask"],
                    "decoder_input_ids": dec_in, "decoder_attention_mask": tgt_mask,
                    "labels": labels})

    @classmethod
    def from_span_corruption_texts(cls, tokenizer, texts, max_source_length: int = 512,
                                   max_target_length: int = 114,
                                   corruption_rate: float = 0.15,
                                   mean_span_length: float = 3.0, n_sentinels: int = 100,
                                   decoder_start_token_id: int = 0, pad_token_id: int = 0,
                                   eos_token_id: int = 1, seed: int = 0) -> "ArrayDataset":
        """T5's span-corruption pretraining: about ``corruption_rate`` of
        each row's tokens drop out in spans of mean ``mean_span_length``;
        each span becomes a sentinel (the i-th is ``vocab_size - 1 - i``)
        in the source, and the target interleaves the sentinels with the
        dropped spans, then a final sentinel and EOS::

            source: Thank you <X> me to your party <Y> week . </s>
            target: <X> for inviting <Y> last <Z> </s>

        The split points are drawn from ``RandomState(seed)`` in the JAX
        package's order, so the columns are its own."""
        enc = tokenizer(texts, truncation=True, padding="max_length",
                        max_length=max_source_length, add_special_tokens=False)
        ids = np.asarray(enc["input_ids"], np.int32)
        am = np.asarray(enc["attention_mask"], np.int32)
        vocab = int(tokenizer.vocab_size)
        rng = np.random.RandomState(seed)

        def partition(total: int, parts: int) -> list:
            """``total`` split into ``parts`` random segments of >= 1."""
            cuts = (np.sort(rng.choice(total - 1, parts - 1, replace=False)) + 1
                    if parts > 1 else np.array([], np.int64))
            return list(np.diff(np.concatenate([[0], cuts, [total]])))

        n_rows = ids.shape[0]
        src = np.full((n_rows, max_source_length), pad_token_id, np.int32)
        src_mask = np.zeros((n_rows, max_source_length), np.int32)
        tgt_ids = np.full((n_rows, max_target_length), pad_token_id, np.int32)
        tgt_mask = np.zeros((n_rows, max_target_length), np.int32)
        for r in range(n_rows):
            toks = ids[r][am[r] > 0]
            n = len(toks)
            if n < 4:
                src[r, :n] = toks
                src[r, min(n, max_source_length - 1)] = eos_token_id
                src_mask[r, :min(n + 1, max_source_length)] = 1
                tgt_ids[r, 0] = eos_token_id
                tgt_mask[r, 0] = 1
                continue
            num_noise = int(np.clip(round(n * corruption_rate), 1, n - 2))
            # num_spans + 1 kept segments of >= 1 token fit in n - num_noise
            num_spans = int(np.clip(round(num_noise / mean_span_length), 1,
                                    min(num_noise, n - num_noise - 1, n_sentinels - 1)))
            noise_lens = partition(num_noise, num_spans)
            keep_lens = partition(n - num_noise, num_spans + 1)
            s_row: list = []
            t_row: list = []
            pos = 0
            for i in range(num_spans):
                sentinel = vocab - 1 - i
                s_row += toks[pos:pos + keep_lens[i]].tolist() + [sentinel]
                pos += keep_lens[i]
                t_row += [sentinel] + toks[pos:pos + noise_lens[i]].tolist()
                pos += noise_lens[i]
            s_row = (s_row + toks[pos:].tolist() + [eos_token_id])[:max_source_length]
            t_row = (t_row + [vocab - 1 - num_spans])[:max_target_length - 1] + [eos_token_id]
            src[r, :len(s_row)] = s_row
            src_mask[r, :len(s_row)] = 1
            tgt_ids[r, :len(t_row)] = t_row
            tgt_mask[r, :len(t_row)] = 1
        labels = np.where(tgt_mask > 0, tgt_ids, -100).astype(np.int32)
        dec_in = shift_right(labels, decoder_start_token_id, pad_token_id).astype(np.int32)
        return cls({"input_ids": src, "attention_mask": src_mask,
                    "decoder_input_ids": dec_in, "decoder_attention_mask": tgt_mask,
                    "labels": labels})


class MlmDataset(ArrayDataset):
    """An :class:`ArrayDataset` whose MLM masks are re-drawn each epoch.

    It holds the clean ids and word ids; ``begin_epoch(e)`` makes
    ``input_ids``/``labels`` from ``RandomState(seed + e)`` in one
    vectorized pass, so every rank derives the same masks with no
    communication. ``static_masking`` pins every epoch to epoch 0's draw."""

    def __init__(self, clean_ids: np.ndarray, attention_mask: np.ndarray,
                 word_ids: np.ndarray, mask_token_id: int, vocab_size: int,
                 mlm_probability: float = 0.15, whole_word: bool = True,
                 seed: int = 0, static_masking: bool = False):
        self._clean_ids = clean_ids
        self._word_ids = word_ids
        self._mask_token_id = mask_token_id
        self._vocab_size = vocab_size
        self._mlm_probability = mlm_probability
        self._whole_word = whole_word
        self._seed = seed
        self._static = static_masking
        self._epoch: Optional[int] = None
        super().__init__({"attention_mask": attention_mask})
        self.begin_epoch(0)

    def pack(self, max_length: Optional[int] = None, causal: bool = False,
             pad_token_id: int = 0) -> "ArrayDataset":
        """Packing freezes the masking draw, so it needs
        ``static_masking`` (as in the JAX package): epoch 0's columns pack
        as a plain :class:`ArrayDataset`."""
        if not self._static:
            raise ValueError(
                "packing an MLM dataset freezes the masking draw, so it "
                "requires static_masking=True (per-epoch re-masking "
                "cannot re-mask packed rows)")
        self.begin_epoch(0)
        return ArrayDataset(dict(self.columns)).pack(max_length, causal=causal,
                                                     pad_token_id=pad_token_id)

    def begin_epoch(self, epoch: int) -> None:
        """Re-draw the masks for ``epoch`` (a no-op when they are that
        epoch's already)."""
        if self._static:
            epoch = 0
        if epoch == self._epoch:
            return
        ids, labels = apply_mlm_masking(
            self._clean_ids, self._word_ids, np.random.RandomState(self._seed + epoch),
            self._mask_token_id, self._vocab_size, self._mlm_probability,
            self._whole_word)
        self.columns["input_ids"] = ids
        self.columns["labels"] = labels
        self._epoch = epoch


def _rank_and_world(mesh=None) -> tuple[int, int]:
    """This process's batch shard and the shard count: with a ``mesh`` its
    replica's coordinate over ``data`` × ``fsdp`` and their count (the
    ``seq`` and ``tensor`` ranks of one replica take the same rows), else
    the process group's rank and size (0 and 1 without one)."""
    import torch.distributed as dist

    if mesh is not None:
        from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.mesh import (
            data_parallel_size,
        )
        from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.sharding import (
            data_parallel_rank,
        )
        return data_parallel_rank(mesh), data_parallel_size(mesh)
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


# -- prefetch ------------------------------------------------------------------

_PREFETCH_END = object()


class _AdaptiveQueue:
    """Bounded FIFO whose capacity can change while threads wait on it
    (what the prefetch autotuner adjusts). Mirrors the ``queue.Queue``
    subset the producer and consumer use (``put`` with a timeout raising
    ``queue.Full``, blocking ``get``, ``get_nowait`` raising
    ``queue.Empty``); a capacity change wakes blocked producers so a
    deeper queue takes effect at once."""

    def __init__(self, capacity: int):
        self._capacity = max(1, int(capacity))
        self._items: collections.deque = collections.deque()
        self._cond = threading.Condition()

    @property
    def capacity(self) -> int:
        return self._capacity

    def set_capacity(self, capacity: int) -> None:
        with self._cond:
            self._capacity = max(1, int(capacity))
            self._cond.notify_all()

    def qsize(self) -> int:
        return len(self._items)

    def put(self, item, timeout: Optional[float] = None) -> None:
        with self._cond:
            ok = self._cond.wait_for(
                lambda: len(self._items) < self._capacity, timeout=timeout)
            if not ok:
                raise queue.Full
            self._items.append(item)
            self._cond.notify_all()

    def get(self, timeout: Optional[float] = None):
        with self._cond:
            ok = self._cond.wait_for(lambda: len(self._items) > 0, timeout=timeout)
            if not ok:
                raise queue.Empty
            item = self._items.popleft()
            self._cond.notify_all()
            return item

    def get_nowait(self):
        return self.get(timeout=0)


class _PrefetchStats:
    """Producer wait against consumer wait: input-bound or compute-bound
    at a glance.

    - ``producer_wait``: the producer thread sat on a FULL queue (the
      input pipeline is ahead of the card).
    - ``consumer_wait``: the trainer sat on an EMPTY queue (the card
      waited for data)."""

    __slots__ = ("producer_wait", "consumer_wait", "produced", "consumed",
                 "_reported")

    def __init__(self):
        self.producer_wait = 0.0
        self.consumer_wait = 0.0
        self.produced = 0
        self.consumed = 0
        self._reported = False

    def report(self, depth: Optional[int] = None) -> None:
        if self._reported or not self.consumed:
            return
        self._reported = True
        obs.scalar("data/producer_wait_s", self.producer_wait,
                   args={"batches": self.produced})
        consumer_args = {"batches": self.consumed,
                         "verdict": ("input_bound"
                                     if self.consumer_wait > self.producer_wait
                                     else "compute_bound")}
        if depth is not None:
            # the achieved (final) depth, beside the wait verdict
            consumer_args["depth"] = int(depth)
        obs.scalar("data/consumer_wait_s", self.consumer_wait, args=consumer_args)


def _prefetch_producer(it, q: _AdaptiveQueue, stop: threading.Event,
                       stats: _PrefetchStats) -> None:
    # a module-level target: the thread must NOT reference the
    # PrefetchIterator, or the live-thread registry would keep it reachable
    # and its GC finalizer could never fire
    try:
        for item in it:
            t0 = time.perf_counter()
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            stats.producer_wait += time.perf_counter() - t0
            stats.produced += 1
            if stop.is_set():
                return
        q.put(_PREFETCH_END)
    except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
        if not stop.is_set():
            q.put(e)


def _drain_and_stop(q: _AdaptiveQueue, stop: threading.Event) -> None:
    stop.set()
    # drain so a producer blocked on put() sees the stop flag
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass


def _batch_nbytes(item) -> int:
    """Host bytes one queued batch holds (a dict of numpy columns; 0 when
    the item's shape is unknown: the autotuner then skips the memory cap)."""
    if isinstance(item, dict):
        return sum(int(getattr(v, "nbytes", 0)) for v in item.values())
    return int(getattr(item, "nbytes", 0))


class PrefetchIterator:
    """Iterator wrapper that materializes up to ``depth`` items ahead on a
    daemon thread. Exceptions from the producer re-raise at the consumer;
    ``close()`` stops the producer promptly, and dropping the iterator
    without closing it runs the same cleanup through ``weakref.finalize``.

    With an ``autotuner`` (:class:`~.autotune.PrefetchAutotuner`) the depth
    is live: each consumed batch feeds the cumulative wait stats to the
    controller, and a decision resizes the queue in place (an ``autotune``
    telemetry event). Without one, ``depth`` is fixed."""

    def __init__(self, it: Iterator, depth: int = 2,
                 autotuner: Optional[PrefetchAutotuner] = None):
        self._done = False
        self._autotuner = autotuner
        if autotuner is not None:
            depth = autotuner.depth
        self._queue = _AdaptiveQueue(depth)
        self._stop = threading.Event()
        self.stats = _PrefetchStats()
        self._thread = threading.Thread(
            target=_prefetch_producer, args=(it, self._queue, self._stop, self.stats),
            daemon=True)
        self._finalizer = weakref.finalize(self, _drain_and_stop, self._queue, self._stop)
        self._thread.start()

    @property
    def depth(self) -> int:
        return self._queue.capacity

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        with obs.span("data/next_batch"):
            t0 = time.perf_counter()
            item = self._queue.get()
            self.stats.consumer_wait += time.perf_counter() - t0
        if item is _PREFETCH_END:
            self._done = True
            self.stats.report(depth=self.depth)
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            raise item
        self.stats.consumed += 1
        if self._autotuner is not None:
            decision = self._autotuner.observe(
                self.stats.producer_wait, self.stats.consumer_wait,
                self.stats.consumed, _batch_nbytes(item))
            if decision is not None:
                new_depth, reason = decision
                self._queue.set_capacity(new_depth)
                obs.autotune("data/prefetch_depth", new_depth, reason,
                             args={"batches": self.stats.consumed})
        return item

    def close(self):
        if not self._done:
            self.stats.report(depth=self.depth)
        self._done = True
        self._finalizer()


# -- staging onto the card -------------------------------------------------------

_STAGER_END = object()


class H2DStager:
    """Overlap batch N+1's host-to-device copy with compute on batch N.

    When the consumer takes batch N, this iterator stages batch N+1 first
    (``put_batch``), so one batch's copy is always in flight while the
    card computes, and at most two device batches are live: the one
    computing and the one staging. ``deliver`` hands a staged batch to the
    consumer (on CUDA: its stream waits on the copy). Each staging is a
    ``data/h2d_stage`` span; exhaustion or ``close`` emits one
    ``data/h2d_stage_s`` metric with the staging seconds and batches."""

    def __init__(self, host_iter, put_batch, deliver=None):
        self._it = host_iter
        self._put = put_batch
        self._deliver = deliver
        self._pending = None
        self._primed = False
        self.stage_s = 0.0
        self.staged = 0
        self._reported = False

    def __iter__(self):
        return self

    def _stage(self):
        batch = next(self._it)  # StopIteration propagates to the caller
        t0 = time.perf_counter()
        with obs.span("data/h2d_stage"):
            out = self._put(batch)
        self.stage_s += time.perf_counter() - t0
        self.staged += 1
        return out

    def __next__(self):
        if self._pending is _STAGER_END:
            raise StopIteration
        if not self._primed:
            self._primed = True
            try:
                self._pending = self._stage()
            except StopIteration:
                self._pending = _STAGER_END
                self._report()
                raise
        current = self._pending
        try:
            self._pending = self._stage()
        except StopIteration:
            self._pending = _STAGER_END
            self._report()
        return current if self._deliver is None else self._deliver(current)

    def _report(self) -> None:
        if self._reported or not self.staged:
            return
        self._reported = True
        obs.scalar("data/h2d_stage_s", self.stage_s, args={"batches": self.staged})

    @property
    def stats(self) -> _PrefetchStats:
        """The wrapped prefetcher's wait accounting (the autotuner's input)."""
        return self._it.stats

    @property
    def depth(self) -> int:
        return getattr(self._it, "depth", 0)

    def close(self):
        self._pending = _STAGER_END
        self._report()
        if hasattr(self._it, "close"):
            self._it.close()


def _column_dtype(key: str) -> torch.dtype:
    """Token and label columns go to the model as int64; ``valid`` stays
    int32."""
    return torch.int32 if key == "valid" else torch.int64


class _Staged:
    __slots__ = ("tensors", "event")

    def __init__(self, tensors: dict, event):
        self.tensors = tensors
        self.event = event


class _CudaStager:
    """Copies host batches to the card from pinned buffers that are kept
    and reused, on a side stream.

    Two slots of pinned buffers (one per column, grown when a wider batch
    arrives) alternate; a slot is refilled only after the copy out of it
    has finished (its event). The copy and its event run on the side
    stream; :meth:`deliver` makes the consumer's current stream wait on the
    event and records the staged tensors on that stream, so the caching
    allocator does not hand their memory out again while the consumer's
    kernels may still read it."""

    SLOTS = 2

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._slots = [{"bufs": {}, "event": None} for _ in range(self.SLOTS)]
        self._next = 0

    def stage(self, batch: dict[str, np.ndarray]) -> _Staged:
        slot = self._slots[self._next]
        self._next = (self._next + 1) % self.SLOTS
        if slot["event"] is not None:
            slot["event"].synchronize()
        out = {}
        with torch.cuda.stream(self.stream):
            for key, value in batch.items():
                src = torch.from_numpy(np.ascontiguousarray(value))
                dtype, n = _column_dtype(key), src.numel()
                buf = slot["bufs"].get(key)
                if buf is None or buf.numel() < n or buf.dtype != dtype:
                    buf = torch.empty(n, dtype=dtype, pin_memory=True)
                    slot["bufs"][key] = buf
                host = buf[:n].view(src.shape)
                host.copy_(src)
                out[key] = host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        slot["event"] = event
        return _Staged(out, event)

    def deliver(self, staged: _Staged) -> dict[str, torch.Tensor]:
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(staged.event)
        for t in staged.tensors.values():
            t.record_stream(stream)
        return staged.tensors


# -- the batcher -----------------------------------------------------------------

class ShardedBatcher:
    """Iterates global batches, yielding this rank's shard of each.

    ``process_index``/``process_count`` default to the ``torch.distributed``
    rank and world size (0 and 1 without a process group), and with a
    ``mesh`` (``parallel/mesh.py``) to the data-parallel rank and size: the
    rank's coordinate over ``data`` × ``fsdp`` (the ``seq`` and ``tensor``
    ranks of one replica take the same rows, the JAX ``batch_sharding``; a
    bucket width the ``seq`` axis does not divide raises the JAX
    ``ValueError``); ``device`` is
    where :meth:`global_arrays` puts the tensors (CPU by default).
    ``bucket_sizes`` turns on length bucketing (sorted within windows of
    ``bucket_window`` batches); ``pack`` token-packs the dataset first
    (``ArrayDataset.pack``, ``pack_causal`` for causal-LM rows), the two
    being alternatives. ``native`` draws the epoch permutation,
    gathers rows and counts row lengths with the C++ host library (built at
    first use; a failed build raises); ``native=False`` asks for the numpy
    twins, which give the same batches.

    Once ``HSTD_COMPILE_BUDGET_S`` is spent (``obs.compile_budget_capped``)
    the ladder mints no new width: a batch takes the smallest width this
    batcher already emitted that holds it, else the full width."""

    def __init__(self, dataset, global_batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_remainder: bool = True,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None, device=None,
                 bucket_sizes: Optional[list[int]] = None, bucket_window: int = 16,
                 native: bool = True, pack: bool = False, pack_causal: bool = False,
                 mesh=None):
        if pack:
            # token packing leaves no pad waste for the bucket ladder to trim
            if bucket_sizes:
                raise ValueError(
                    "pack=True already eliminates pad waste; combining it "
                    "with bucket_sizes would re-fragment packed rows — "
                    "pick one")
            if not hasattr(dataset, "columns"):
                raise ValueError(
                    "pack=True re-groups rows at build time, which needs "
                    "a materialized dataset (streaming tiers tokenize "
                    "per batch)")
            dataset = dataset.pack(causal=pack_causal)
        self.dataset = dataset
        self.global_batch_size = global_batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.native = native
        self.bucket_sizes = sorted(bucket_sizes) if bucket_sizes else None
        self.bucket_window = bucket_window
        self._lengths: dict[str, np.ndarray] = {}
        # per mask column, the widths this batcher has emitted: the ladder
        # cap's "already compiled" set
        self._used_buckets: dict[str, set[int]] = {}
        if self.bucket_sizes and not hasattr(dataset, "columns"):
            raise ValueError(
                "length bucketing needs corpus-wide token lengths, which "
                "streaming datasets deliberately don't precompute — drop "
                "bucket_sizes or materialize the dataset")
        if self.bucket_sizes:
            # token count per row, per mask column: encoder and decoder
            # widths bucket independently
            from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.native import (
                native_row_lengths,
            )
            for name in ("attention_mask", "decoder_attention_mask"):
                if name in dataset.columns:
                    self._lengths[name] = native_row_lengths(dataset.columns[name],
                                                             native=native)
        # the last epoch's prefetch autotuner: its depth seeds the next
        # epoch's controller instead of re-learning from 2
        self._auto_tuner: Optional[PrefetchAutotuner] = None
        if self.bucket_sizes and mesh is not None:
            # a rank takes width / sp tokens of every row: every bucket width
            # must divide evenly
            from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.mesh import (
                AXIS_SEQ,
                mesh_shape,
            )
            sp = mesh_shape(mesh)[AXIS_SEQ]
            bad = [b for b in self.bucket_sizes if b % sp != 0]
            if bad:
                raise ValueError(
                    f"bucket_sizes {bad} not divisible by the mesh seq axis "
                    f"(size {sp}); pad bucket widths to multiples of {sp}")
        rank, world = _rank_and_world(mesh)
        self.process_index = rank if process_index is None else process_index
        self.process_count = world if process_count is None else process_count
        if global_batch_size % self.process_count != 0:
            raise ValueError(f"global batch {global_batch_size} not divisible by "
                             f"{self.process_count} ranks")
        self.per_host = global_batch_size // self.process_count
        self.device = torch.device("cpu" if device is None else device)
        self._cuda_stager: Optional[_CudaStager] = None
        # MFU accounting: one (tokens, dec_tokens) entry of REAL
        # (attention-mask) tokens per staged batch, in yield order, which
        # the trainer pops once per dispatched step (exact under the
        # stager's lookahead; a batch staged but never dispatched is
        # cleared at the next epoch). Counted only when an MFU figure can
        # be read (telemetry configured, or a peak override set), as in
        # the JAX package; bounded so eval never grows it.
        self._count_tokens = obs.state().enabled and (
            obs.configured() or obs.flops.env_peak_tflops() is not None)
        self.token_log: collections.deque = collections.deque(maxlen=8192)

    def steps_per_epoch(self) -> int:
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.global_batch_size
        return (n + self.global_batch_size - 1) // self.global_batch_size

    def _gather(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        columns = getattr(self.dataset, "columns", None)
        if columns is None:
            return self.dataset[idx]     # a streaming dataset reads its rows
        from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.native import (
            native_gather,
        )
        return {k: native_gather(v, idx, native=self.native) for k, v in columns.items()}

    def local_batches(self, epoch: int = 0, start_step: int = 0
                      ) -> Iterator[dict[str, np.ndarray]]:
        """Yield rank-local numpy batches (with the ``valid`` column),
        cut to their bucket width when bucketing is on."""
        from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.native import (
            native_permutation,
        )

        begin_epoch = getattr(self.dataset, "begin_epoch", None)
        if begin_epoch is not None:
            # a per-epoch transform (MLM re-masking), drawn from seed +
            # epoch: every rank agrees and a mid-epoch resume replays it
            begin_epoch(epoch)
        n = len(self.dataset)
        order = (native_permutation(n, self.seed + epoch, native=self.native)
                 if self.shuffle else np.arange(n))
        if self.bucket_sizes:
            order = self._length_sorted_windows(order)
        lo_rank = self.process_index * self.per_host
        hi_rank = lo_rank + self.per_host
        for s in range(start_step, self.steps_per_epoch()):
            if begin_epoch is not None:
                # again before every gather: another batcher over the same
                # dataset (train, then eval at epoch 0) may have re-masked
                # it to its own epoch between two of our batches
                begin_epoch(epoch)
            lo = s * self.global_batch_size
            global_idx = order[lo: lo + self.global_batch_size]
            valid_n = len(global_idx)
            if valid_n < self.global_batch_size:
                pad = np.zeros(self.global_batch_size - valid_n, dtype=order.dtype)
                global_idx = np.concatenate([global_idx, pad])
            batch = self._gather(global_idx[lo_rank:hi_rank])
            valid = np.zeros(self.global_batch_size, np.int32)
            valid[:valid_n] = 1
            batch["valid"] = valid[lo_rank:hi_rank]
            if self.bucket_sizes:
                batch = self._trim_to_buckets(batch, global_idx[:valid_n])
            yield batch

    # -- length bucketing --------------------------------------------------------

    def _bucket_for(self, max_len: int, full: int) -> int:
        for b in self.bucket_sizes:
            if b >= max_len:
                return min(b, full)
        return full

    def _length_sorted_windows(self, order: np.ndarray) -> np.ndarray:
        """Sort by length inside windows of ``bucket_window`` batches: like
        batches get like lengths (less padding) while the epoch stays
        roughly shuffled. Deterministic: every rank agrees."""
        key = self._lengths.get("attention_mask")
        if key is None or not self.shuffle:
            return order
        w = max(1, self.bucket_window) * self.global_batch_size
        out = order.copy()
        for lo in range(0, len(order), w):
            window = out[lo:lo + w]
            window.sort(kind="stable")  # determinism of ties
            out[lo:lo + w] = window[np.argsort(key[window], kind="stable")]
        return out

    def _trim_to_buckets(self, batch: dict[str, np.ndarray],
                         real_idx: np.ndarray) -> dict[str, np.ndarray]:
        """Cut token-width columns to the smallest bucket that holds the
        GLOBAL batch's longest real row (every rank agrees: the choice
        derives from the shared order). Encoder and decoder columns of the
        same width share one cut, the wider.

        Under the compile-budget cap a width this batcher has not emitted
        widens to the smallest emitted one that holds the batch, else to
        the full width. One process caps the moment its tracker crosses;
        several cap on the latch the trainer agrees at an epoch boundary,
        so every rank's choice stays the same."""
        # several ranks agree, the tensor ranks of one replica too
        capped = obs.compile_budget_capped(max(self.process_count, _rank_and_world()[1]))
        trims: dict[int, int] = {}  # original width -> bucket width
        for mask_name, lengths in self._lengths.items():
            width = self.dataset.columns[mask_name].shape[1]
            max_len = int(lengths[real_idx].max()) if len(real_idx) else 1
            bucket = self._bucket_for(max(max_len, 1), width)
            used = self._used_buckets.setdefault(mask_name, set())
            if capped and bucket not in used:
                bucket = min((b for b in used if b >= bucket), default=width)
            trims[width] = max(trims.get(width, 0), bucket)
        for mask_name in self._lengths:
            # record the applied cut (after the max over shared widths): a
            # per-mask bucket never emitted must not count as compiled
            width = self.dataset.columns[mask_name].shape[1]
            self._used_buckets[mask_name].add(trims[width])
        out = {}
        for k, v in batch.items():
            if v.ndim >= 2 and v.shape[1] in trims:
                out[k] = np.ascontiguousarray(v[:, :trims[v.shape[1]]])
            else:
                out[k] = v
        return out

    # -- the feed ----------------------------------------------------------------

    def global_arrays(self, epoch: int = 0, start_step: int = 0,
                      prefetch: Union[int, str] = "auto"):
        """This rank's batches as tensors on ``device`` (int64 token and
        label columns, int32 ``valid``). The returned iterator has
        ``close()`` for an early exit.

        ``prefetch="auto"`` (the default): gathering runs on a thread whose
        queue depth the :class:`~.autotune.PrefetchAutotuner` sets from the
        producer and consumer waits (``HSTD_PREFETCH_AUTOTUNE=0`` pins depth
        2), with the depth carried from one epoch to the next, and an
        :class:`H2DStager` stages batch N+1 while the trainer computes on
        batch N. ``prefetch=N`` is the same at a fixed depth N;
        ``prefetch=0`` stages each batch as it is asked for, with no thread
        and no lookahead."""
        host = self.local_batches(epoch, start_step)
        if prefetch == "auto":
            seed_depth = {}
            if self._auto_tuner is not None:
                seed_depth = {"initial_depth": self._auto_tuner.depth}
            tuner = PrefetchAutotuner.from_env(**seed_depth)
            if tuner is not None:
                self._auto_tuner = tuner
            host = PrefetchIterator(host, depth=2, autotuner=tuner)
        elif prefetch > 0:
            host = PrefetchIterator(host, depth=prefetch)
        else:
            return self._device_batches(host)
        return H2DStager(host, self._put_batch, self._deliver)

    def _put_batch(self, batch: dict[str, np.ndarray]):
        """One host batch onto ``device``: on CUDA staged (see
        :class:`_CudaStager`), on the CPU converted."""
        if self._count_tokens:
            am = batch.get("attention_mask")
            if am is not None:
                tok = int(np.count_nonzero(am))
            elif "input_ids" in batch:
                tok = int(batch["input_ids"].size)
            else:
                tok = 0
            dm = batch.get("decoder_attention_mask")
            dec = int(np.count_nonzero(dm)) if dm is not None else 0
            self.token_log.append((tok, dec))
        with obs.span("data/host_to_device"):
            if self.device.type == "cuda":
                if self._cuda_stager is None:
                    self._cuda_stager = _CudaStager(self.device)
                return self._cuda_stager.stage(batch)
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device, _column_dtype(k)) for k, v in batch.items()}

    def _deliver(self, staged):
        if isinstance(staged, _Staged):
            return self._cuda_stager.deliver(staged)
        return staged

    def _device_batches(self, host) -> Iterator[dict[str, torch.Tensor]]:
        for batch in host:
            # the span closes before the yield: a generator suspended inside
            # it would bill the consumer's time to the span
            staged = self._put_batch(batch)
            yield self._deliver(staged)
