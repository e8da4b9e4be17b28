"""Tokenization (counterpart of the JAX package's ``data/tokenization.py``).

Three tokenizers behind one interface (``__call__`` with the reference's
``input_ids``/``attention_mask`` dict, padded to ``max_length``;
``encode_words``, ``encode_qa``, ``decode``, ``save_pretrained``):

- :class:`WordHashTokenizer`, the dependency-free tokenizer: words hash
  (md5) into buckets, with PAD/CLS/SEP/UNK specials, so the same text
  gives the same ids in every process and in both packages.
- the in-repo WordPiece (``data/wordpiece.py``, its C++ core in
  ``data/native.py``) for a bare BERT ``vocab.txt``;
- :class:`HFTokenizer`, a local HF fast tokenizer (``tokenizer.json`` and
  the like) through ``transformers.AutoTokenizer`` with
  ``local_files_only=True``, imported only when such a directory is loaded.

:func:`load_tokenizer` picks among them as the JAX package does. The QA
window helpers (``_qa_windows``, ``_qa_feature``, ``_qa_assemble``) are
shared by the word-hash and WordPiece ``encode_qa``.
"""

from __future__ import annotations

import hashlib
import json
import os
import re

import numpy as np

_WORD = re.compile(r"\w+|[^\w\s]")


# --- QA feature assembly shared by the in-repo tokenizers ------------------
# (WordHash here and WordPiece in data/wordpiece.py build the identical
# [CLS] question [SEP] context-window [SEP] layout; the HF wrapper uses
# the fast tokenizer's own overflow machinery instead.)

_WARNED_STRIDE_CLAMP = False


def _qa_windows(n_q: int, n_ctx: int, max_length: int, doc_stride: int):
    """(window_start, window_len) pairs over the context tokens.
    stride 0 → one truncated window (the pre-stride behavior); stride>0 →
    overlapping windows covering the whole context. ``doc_stride`` is the
    OVERLAP between consecutive windows — the HF fast-tokenizer ``stride``
    parameter's meaning, so one config value windows identically across
    all tokenizer tiers; a stride ≥ the window size clamps to step 1 so
    coverage never gaps."""
    room = max_length - n_q - 3
    if room <= 0:
        yield 0, 0
        return
    if doc_stride <= 0 or n_ctx <= room:
        yield 0, min(n_ctx, room)
        return
    step = room - doc_stride
    if step < 1:
        # config validation rejects stride >= max_length-3, but a long
        # QUESTION can still shrink this example's room below the
        # stride — make the 1-token-step degeneration visible instead
        # of quietly emitting up to n_ctx features
        global _WARNED_STRIDE_CLAMP
        if not _WARNED_STRIDE_CLAMP:
            _WARNED_STRIDE_CLAMP = True
            import logging
            logging.getLogger(__name__).warning(
                "qa doc_stride %d >= window room %d (long question): "
                "stepping 1 token per window, up to %d features for this "
                "example — consider a smaller --qa_doc_stride or larger "
                "--max_seq_length (warning once)",
                doc_stride, room, n_ctx)
        step = 1
    w = 0
    while True:
        yield w, min(room, n_ctx - w)
        if w + room >= n_ctx:
            return
        w += step


def _qa_feature(example_id: int, q_ids, win_ids, win_spans, max_length: int,
                labeled: bool, a_start: int, a_end: int,
                cls_id: int, sep_id: int) -> dict:
    """One feature row: ids/segments/context char-offsets/labels for a
    single context window. The label is the token span iff the window
    contains the FULL answer (HF run_qa convention); otherwise (0, 0) =
    CLS, the unanswerable-in-this-window marker."""
    ids = [cls_id] + list(q_ids) + [sep_id] + list(win_ids) + [sep_id]
    segs = [0] * (len(q_ids) + 2) + [1] * (len(win_ids) + 1)
    ctx_offset = len(q_ids) + 2
    tok_start = tok_end = None
    first_start = last_end = 0
    ctx_positions = []
    for t, (s, e) in enumerate(win_spans):
        pos = ctx_offset + t
        if pos >= max_length or e == s:
            continue
        ctx_positions.append((pos, s, e))
        if labeled and s < a_end and e > a_start:
            if tok_start is None:
                tok_start = pos
                first_start = s
            tok_end = pos
            last_end = e
    # label iff the window contains the FULL answer: head covered
    # (first overlapping token starts at/before the answer) AND tail
    # covered — a window cutting either side trains toward CLS, not a
    # partial span (HF run_qa convention)
    if (tok_start is None or first_start > a_start or last_end < a_end
            or tok_end >= max_length):
        tok_start = tok_end = 0
    return {"example_id": example_id, "ids": ids[:max_length],
            "segs": segs[:max_length], "tok_start": tok_start,
            "tok_end": tok_end, "ctx_positions": ctx_positions}


def _qa_assemble(rows, max_length: int, pad_id: int, return_offsets: bool,
                 token_type: bool) -> dict:
    """Stack feature rows into the encode_qa array contract (+
    ``example_ids``, the feature→input map for doc-stride aggregation)."""
    n = len(rows)
    input_ids = np.full((n, max_length), pad_id, np.int32)
    attention_mask = np.zeros((n, max_length), np.int32)
    token_type_ids = np.zeros((n, max_length), np.int32)
    start_positions = np.zeros(n, np.int32)
    end_positions = np.zeros(n, np.int32)
    example_ids = np.zeros(n, np.int32)
    offset_starts = np.full((n, max_length), -1, np.int32)
    offset_ends = np.full((n, max_length), -1, np.int32)
    for r, row in enumerate(rows):
        ids = row["ids"]
        input_ids[r, : len(ids)] = ids
        attention_mask[r, : len(ids)] = 1
        token_type_ids[r, : len(row["segs"])] = row["segs"]
        start_positions[r] = row["tok_start"]
        end_positions[r] = row["tok_end"]
        example_ids[r] = row["example_id"]
        for pos, s, e in row["ctx_positions"]:
            offset_starts[r, pos] = s
            offset_ends[r, pos] = e
    res = {"input_ids": input_ids, "attention_mask": attention_mask,
           "start_positions": start_positions,
           "end_positions": end_positions, "example_ids": example_ids}
    if token_type:
        res["token_type_ids"] = token_type_ids
    if return_offsets:
        res["offset_starts"] = offset_starts
        res["offset_ends"] = offset_ends
    return res


class WordHashTokenizer:
    """Deterministic hashing tokenizer. Vocabulary layout: 0=PAD, 1=CLS,
    2=SEP, 3=UNK (doubles as the mask token), 4..vocab_size-1 hash
    buckets."""

    model_max_length = 512

    def __init__(self, vocab_size: int = 30522, lowercase: bool = True):
        self.vocab_size = vocab_size
        self.lowercase = lowercase
        self.pad_token_id = 0
        self.cls_token_id = 1
        self.sep_token_id = 2
        self.mask_token_id = 3

    def convert_ids_to_tokens(self, ids) -> list[str]:
        """Hash buckets are one-way; specials resolve, buckets become
        placeholders (this tier exists for synthetic/offline runs)."""
        names = {self.pad_token_id: "[PAD]", self.cls_token_id: "[CLS]",
                 self.sep_token_id: "[SEP]", self.mask_token_id: "[UNK]"}
        return [names.get(int(i), f"<{int(i)}>") for i in ids]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        specials = {self.pad_token_id, self.cls_token_id, self.sep_token_id}
        toks = [t for i, t in zip(ids, self.convert_ids_to_tokens(ids))
                if not (skip_special_tokens and int(i) in specials)]
        return " ".join(toks)

    def _word_id(self, word: str) -> int:
        digest = hashlib.md5(word.encode("utf-8")).digest()
        return 4 + int.from_bytes(digest[:4], "little") % (self.vocab_size - 4)

    def __call__(self, texts, truncation: bool = True, padding: str = "max_length",
                 max_length: int | None = None, text_pairs=None,
                 add_special_tokens: bool = True):
        """``input_ids``/``attention_mask`` (and ``token_type_ids`` with
        ``text_pairs``) as int32 ``[n, max_length]``, padded right."""
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        ids_list, seg_list = [], []
        for i, text in enumerate(texts):
            if self.lowercase:
                text = text.lower()
            ids = [self._word_id(w) for w in _WORD.findall(text)]
            if add_special_tokens:
                ids = [self.cls_token_id] + ids + [self.sep_token_id]
            segs = [0] * len(ids)
            if text_pairs is not None:
                pair = text_pairs[i].lower() if self.lowercase else text_pairs[i]
                pair_ids = [self._word_id(w) for w in _WORD.findall(pair)] + [self.sep_token_id]
                ids += pair_ids
                segs += [1] * len(pair_ids)
            if truncation:
                ids, segs = ids[:max_length], segs[:max_length]
            ids_list.append(ids)
            seg_list.append(segs)
        if padding == "longest":
            max_length = min(max_length, max(len(i) for i in ids_list))
        n = len(ids_list)
        input_ids = np.full((n, max_length), self.pad_token_id, np.int32)
        attention_mask = np.zeros((n, max_length), np.int32)
        token_type_ids = np.zeros((n, max_length), np.int32)
        for r, (ids, segs) in enumerate(zip(ids_list, seg_list)):
            ids, segs = ids[:max_length], segs[:max_length]
            input_ids[r, :len(ids)] = ids
            attention_mask[r, :len(ids)] = 1
            token_type_ids[r, :len(segs)] = segs
        out = {"input_ids": input_ids, "attention_mask": attention_mask}
        if text_pairs is not None:
            out["token_type_ids"] = token_type_ids
        return out

    def encode_words(self, word_lists, max_length: int | None = None):
        """Pre-split words → ids with word alignment (NER path).

        Returns input_ids, attention_mask, and ``word_ids`` (same shape;
        -1 for CLS/SEP/PAD) mapping each token to its source word — the
        alignment HF fast tokenizers expose via ``word_ids()``. One token
        per word here, so alignment is the identity.
        """
        max_length = max_length or self.model_max_length
        n = len(word_lists)
        input_ids = np.full((n, max_length), self.pad_token_id, np.int32)
        attention_mask = np.zeros((n, max_length), np.int32)
        word_ids = np.full((n, max_length), -1, np.int32)
        for r, words in enumerate(word_lists):
            if self.lowercase:
                words = [w.lower() for w in words]
            ids = [self.cls_token_id] + [self._word_id(w) for w in words] + [self.sep_token_id]
            wids = [-1] + list(range(len(words))) + [-1]
            ids, wids = ids[:max_length], wids[:max_length]
            input_ids[r, : len(ids)] = ids
            attention_mask[r, : len(ids)] = 1
            word_ids[r, : len(wids)] = wids
        return {"input_ids": input_ids, "attention_mask": attention_mask,
                "word_ids": word_ids}

    def encode_qa(self, questions, contexts, start_chars=None,
                  answer_texts=None, max_length: int | None = None,
                  return_offsets: bool = False, doc_stride: int = 0):
        """Question+context pairs → ids with answer span token positions.

        Char-offset → token-index mapping via the same regex the word
        hashing uses; spans truncated away land on position 0 (CLS), the
        HF convention for unanswerable-after-truncation.
        ``return_offsets`` adds ``offset_starts``/``offset_ends`` — char
        offsets into the context per CONTEXT token, -1 elsewhere (the
        answer-text decoding input, eval-side only so the extra columns
        never reach the model). ``start_chars``/``answer_texts`` may be
        None (inference: no labels to build).

        ``doc_stride > 0``: contexts longer than the room left by the
        question become MULTIPLE overlapping windows (HF run_qa
        semantics) instead of being truncated; the result rows are
        features, with ``example_ids`` mapping each feature back to its
        input — aggregate with ``utils.metrics.best_windowed_answers``.
        """
        max_length = max_length or self.model_max_length
        rows = []
        for r in range(len(questions)):
            q = questions[r].lower() if self.lowercase else questions[r]
            c = contexts[r].lower() if self.lowercase else contexts[r]
            q_ids = [self._word_id(w) for w in _WORD.findall(q)]
            ctx_spans = [(m.start(), m.end()) for m in _WORD.finditer(c)]
            c_ids = [self._word_id(c[s:e]) for s, e in ctx_spans]
            labeled = start_chars is not None
            a_start = start_chars[r] if labeled else 0
            a_end = a_start + (len(answer_texts[r]) if labeled else 0)
            for w0, nw in _qa_windows(len(q_ids), len(c_ids), max_length,
                                      doc_stride):
                rows.append(_qa_feature(
                    r, q_ids, c_ids[w0:w0 + nw], ctx_spans[w0:w0 + nw],
                    max_length, labeled, a_start, a_end,
                    self.cls_token_id, self.sep_token_id))
        return _qa_assemble(rows, max_length, self.pad_token_id,
                            return_offsets, token_type=True)

    def save_pretrained(self, output_dir: str) -> None:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "word_hash_tokenizer.json"), "w") as f:
            json.dump({"type": "word_hash", "vocab_size": self.vocab_size,
                       "lowercase": self.lowercase,
                       "model_max_length": self.model_max_length}, f)

    @classmethod
    def from_pretrained(cls, path: str) -> "WordHashTokenizer":
        with open(os.path.join(path, "word_hash_tokenizer.json")) as f:
            spec = json.load(f)
        tok = cls(vocab_size=spec["vocab_size"], lowercase=spec["lowercase"])
        tok.model_max_length = spec.get("model_max_length", 512)
        return tok


class HFTokenizer:
    """Wraps a local HF fast tokenizer behind the same interface."""

    def __init__(self, hf_tokenizer):
        self._tok = hf_tokenizer
        self.model_max_length = min(hf_tokenizer.model_max_length, 1 << 20)
        if hf_tokenizer.pad_token_id is None and hf_tokenizer.eos_token_id is not None:
            # GPT-2 family ships without a pad token; padding needs one,
            # and HF's standard recipe is pad = eos (pad positions are
            # masked out everywhere anyway)
            hf_tokenizer.pad_token = hf_tokenizer.eos_token
        self.pad_token_id = hf_tokenizer.pad_token_id or 0
        self.mask_token_id = hf_tokenizer.mask_token_id   # None for GPT-2
        self.vocab_size = hf_tokenizer.vocab_size

    def convert_ids_to_tokens(self, ids) -> list[str]:
        return self._tok.convert_ids_to_tokens([int(i) for i in ids])

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self._tok.decode([int(i) for i in ids],
                                skip_special_tokens=skip_special_tokens)

    def __call__(self, texts, truncation: bool = True, padding: str = "max_length",
                 max_length: int | None = None, text_pairs=None,
                 add_special_tokens: bool = True):
        out = self._tok(
            texts, text_pairs, truncation=truncation, padding=padding,
            max_length=max_length or self.model_max_length,
            add_special_tokens=add_special_tokens, return_tensors="np")
        res = {"input_ids": out["input_ids"].astype(np.int32),
               "attention_mask": out["attention_mask"].astype(np.int32)}
        if "token_type_ids" in out and text_pairs is not None:
            res["token_type_ids"] = out["token_type_ids"].astype(np.int32)
        return res


    def _with_word_ids(self, out, n: int, max_length: int):
        """Pack a fast-tokenizer BatchEncoding into our ids/mask/word_ids
        contract (-1 for specials/pads)."""
        word_ids = np.full((n, max_length), -1, np.int32)
        for r in range(n):
            for t, w in enumerate(out.word_ids(r)):
                if w is not None:
                    word_ids[r, t] = w
        return {"input_ids": out["input_ids"].astype(np.int32),
                "attention_mask": out["attention_mask"].astype(np.int32),
                "word_ids": word_ids}

    def encode_words(self, word_lists, max_length: int | None = None):
        """Pre-split words → subword ids + word alignment (fast-tokenizer
        ``word_ids()``; -1 for specials/pads)."""
        max_length = max_length or self.model_max_length
        out = self._tok(word_lists, is_split_into_words=True, truncation=True,
                        padding="max_length", max_length=max_length,
                        return_tensors="np")
        return self._with_word_ids(out, len(word_lists), max_length)

    def encode_text_words(self, texts, max_length: int | None = None):
        """RAW text → subword ids + word alignment. Unlike
        ``encode_words`` this tokenizes the text natively (byte-BPE
        spacing preserved — RoBERTa rejects pre-split input without
        add_prefix_space, and pre-splitting would change its ids) and
        reads word boundaries from the fast tokenizer, exactly like HF's
        whole-word-mask collator."""
        max_length = max_length or self.model_max_length
        out = self._tok(texts, truncation=True, padding="max_length",
                        max_length=max_length, return_tensors="np")
        return self._with_word_ids(out, len(texts), max_length)

    def encode_qa(self, questions, contexts, start_chars=None,
                  answer_texts=None, max_length: int | None = None,
                  return_offsets: bool = False, doc_stride: int = 0):
        """Question+context → ids + answer token span via offset mapping.
        ``return_offsets`` adds ``offset_starts``/``offset_ends`` (char
        offsets into the context per CONTEXT token, -1 elsewhere) for
        answer-text decoding at eval. ``start_chars``/``answer_texts``
        may be None (inference: no labels to build). ``doc_stride > 0``
        uses the fast tokenizer's own overflow machinery (one feature per
        context window; ``example_ids`` maps features → inputs)."""
        max_length = max_length or self.model_max_length
        kw = {}
        if doc_stride > 0:
            kw = {"return_overflowing_tokens": True, "stride": doc_stride}
        out = self._tok(list(questions), list(contexts),
                        truncation="only_second", padding="max_length",
                        max_length=max_length,
                        return_offsets_mapping=True, return_tensors="np",
                        **kw)
        n = out["input_ids"].shape[0]          # features (== inputs if stride 0)
        example_ids = (out["overflow_to_sample_mapping"].astype(np.int32)
                       if doc_stride > 0 else np.arange(n, dtype=np.int32))
        start_positions = np.zeros(n, np.int32)
        end_positions = np.zeros(n, np.int32)
        offset_starts = np.full((n, max_length), -1, np.int32)
        offset_ends = np.full((n, max_length), -1, np.int32)
        offsets = out["offset_mapping"]
        for r in range(n):
            ex = int(example_ids[r])
            labeled = start_chars is not None
            a_start = start_chars[ex] if labeled else 0
            a_end = a_start + (len(answer_texts[ex]) if labeled else 0)
            seq_ids = out.sequence_ids(r)
            tok_start = tok_end = None
            first_start = 0
            for t, (s, e) in enumerate(offsets[r]):
                if seq_ids[t] != 1 or e == s:
                    continue
                offset_starts[r, t] = s
                offset_ends[r, t] = e
                if labeled and s < a_end and e > a_start:
                    if tok_start is None:
                        tok_start = t
                        first_start = s
                    tok_end = t
            # only label spans that contain the FULL answer — head AND
            # tail; a window starting mid-answer (possible with
            # doc_stride overflow) or truncating its tail falls back to
            # (0,0)/CLS like the in-repo tiers and HF's run_qa
            if (tok_start is not None and first_start <= a_start
                    and offsets[r][tok_end][1] >= a_end):
                start_positions[r] = tok_start
                end_positions[r] = tok_end
        res = {"input_ids": out["input_ids"].astype(np.int32),
               "attention_mask": out["attention_mask"].astype(np.int32),
               "start_positions": start_positions,
               "end_positions": end_positions, "example_ids": example_ids}
        if "token_type_ids" in out:
            res["token_type_ids"] = out["token_type_ids"].astype(np.int32)
        if return_offsets:
            res["offset_starts"] = offset_starts
            res["offset_ends"] = offset_ends
        return res

    def save_pretrained(self, output_dir: str) -> None:
        self._tok.save_pretrained(output_dir)

    @classmethod
    def from_pretrained(cls, path: str) -> "HFTokenizer":
        from transformers import AutoTokenizer
        return cls(AutoTokenizer.from_pretrained(path, local_files_only=True))


def _wordpiece_config_supported(path: str) -> bool:
    """True when ``tokenizer_config.json`` (if any) only uses options the
    in-repo WordPiece implements. Configs that customise behavior it does
    not support (``strip_accents``, ``do_basic_tokenize=False``,
    ``never_split``, ``tokenize_chinese_chars=False``) must route to HF so
    users keep the exact semantics they asked for."""
    cfg_path = os.path.join(path, "tokenizer_config.json")
    if not os.path.exists(cfg_path):
        return True
    try:
        import json
        with open(cfg_path) as f:
            cfg = json.load(f)
    except (OSError, ValueError):
        return True
    if cfg.get("strip_accents") is not None:      # HF default None = follow
        return False                              # do_lower_case; ours does
    if not cfg.get("do_basic_tokenize", True):
        return False
    if cfg.get("never_split"):
        return False
    if not cfg.get("tokenize_chinese_chars", True):
        return False
    return True


def _wordpiece_config_supported(path: str) -> bool:
    """True when ``tokenizer_config.json`` (if any) only uses options the
    in-repo WordPiece implements. Configs that customise behavior it does
    not support (``strip_accents``, ``do_basic_tokenize=False``,
    ``never_split``, ``tokenize_chinese_chars=False``) route to HF so
    users keep the exact semantics they asked for."""
    cfg_path = os.path.join(path, "tokenizer_config.json")
    if not os.path.exists(cfg_path):
        return True
    try:
        with open(cfg_path) as f:
            cfg = json.load(f)
    except (OSError, ValueError):
        return True
    if cfg.get("strip_accents") is not None:      # HF default None = follow
        return False                              # do_lower_case; ours does
    if not cfg.get("do_basic_tokenize", True):
        return False
    if cfg.get("never_split"):
        return False
    if not cfg.get("tokenize_chinese_chars", True):
        return False
    return True


def load_tokenizer(model_name_or_path: str, vocab_size: int = 30522,
                   prefer_native: bool = True):
    """The JAX package's tokenizer choice, best implementation first: a
    saved hash tokenizer loads as such; a bare ``vocab.txt`` (with no
    ``tokenizer_config.json`` option the in-repo WordPiece lacks) loads the
    WordPiece, its C++ core unless ``prefer_native=False`` asks for the
    Python twin (a failed build raises); a vocab whose special tokens are
    not BERT's (``ValueError``) or an unreadable one (``OSError``) hands
    the directory to HF, as the reference does; other local HF tokenizer
    files load through HF; no tokenizer files at all give the hash
    tokenizer."""
    if os.path.isdir(model_name_or_path):
        if os.path.exists(os.path.join(model_name_or_path, "word_hash_tokenizer.json")):
            return WordHashTokenizer.from_pretrained(model_name_or_path)
        has_vocab = os.path.exists(os.path.join(model_name_or_path, "vocab.txt"))
        has_other = any(os.path.exists(os.path.join(model_name_or_path, f))
                        for f in ("tokenizer.json", "spiece.model"))
        if has_vocab and not has_other and _wordpiece_config_supported(
                model_name_or_path):
            from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.native import (
                load_wordpiece,
            )
            try:
                return load_wordpiece(model_name_or_path, prefer_native=prefer_native)
            except (ValueError, OSError):
                # e.g. non-BERT special tokens in vocab.txt: let HF's
                # tokenizer classes interpret the directory instead
                pass
        if has_vocab or has_other or os.path.exists(
                os.path.join(model_name_or_path, "tokenizer_config.json")):
            return HFTokenizer.from_pretrained(model_name_or_path)
    return WordHashTokenizer(vocab_size=vocab_size)
