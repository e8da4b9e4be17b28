"""WordPiece tokenizer: vocab-true BERT tokenization, the Python twin
(counterpart of the JAX package's ``data/wordpiece.py``).

- :func:`tokenize_batch_py`: the pure-Python tokenization core
  (BasicTokenizer + greedy longest-match WordPiece, HF semantics),
  emitting per-row token streams of (id, word_index, char_start,
  char_end). The C++ core (``csrc/host/wordpiece.cc``, bound in
  ``data/native.py``) implements the same contract multithreaded; the
  tests hold the two, and the JAX package's, token for token.
- :class:`WordPieceTokenizer`: the tokenizer interface (``__call__``,
  ``decode``, ``encode_words``, ``encode_qa``, ``save_pretrained``,
  ``from_pretrained``), with assembly (specials, pair segments,
  truncation, padding) done once here in numpy and shared by the C++-backed
  subclass (``data.native.CppWordPieceTokenizer``).

Offsets are code-point positions in the raw input string (HF
``offset_mapping`` semantics) so QA char spans map exactly.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Callable, Optional, Sequence

import numpy as np

MAX_WORD_CHARS = 100  # HF max_input_chars_per_word


# ---------------------------------------------------------------------------
# Pure-Python tokenization core (the twin the C++ core is held against)
# ---------------------------------------------------------------------------

def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def _clean_char(ch: str, lowercase: bool) -> str:
    """lowercase + NFD accent strip of one char; '' to drop it."""
    if lowercase:
        ch = ch.lower()
        out = []
        for d in unicodedata.normalize("NFD", ch):
            if unicodedata.category(d) != "Mn":
                out.append(d)
        ch = "".join(out)
    return ch


def tokenize_text_py(vocab: dict[str, int], text: str, lowercase: bool,
                     unk_id: int, cap: int) -> list[tuple[int, int, int, int]]:
    """One text → [(token_id, word_index, char_start, char_end)], at most
    ``cap`` tokens. Matches csrc/host/wordpiece.cc `tokenize_one`."""
    # basic tokenize: words of (cleaned_text, start, end, word_index)
    words: list[tuple[str, int, int, int]] = []
    cur: list[str] = []
    cur_start = -1
    word_index = -1
    in_space = True

    def flush(end_pos: int):
        nonlocal cur, cur_start
        if cur:
            words.append(("".join(cur), cur_start, end_pos, word_index))
            cur = []
        cur_start = -1

    for pos, ch in enumerate(text):
        if ch == "\0" or ch == "�" or _is_control(ch):
            continue
        if _is_whitespace(ch):
            flush(pos)
            in_space = True
            continue
        if in_space:
            word_index += 1
            in_space = False
        if lowercase:
            ch = _clean_char(ch, True)
            if not ch:
                continue
        # after folding, a char may expand (e.g. ß → ss is NOT in NFD; ß
        # stays) or become punctuation-bearing; treat each produced char
        if len(ch) == 1 and (_is_punctuation(ch) or _is_cjk(ord(ch))):
            flush(pos)
            words.append((ch, pos, pos + 1, word_index))
            continue
        if not cur:
            cur_start = pos
        cur.append(ch)
    flush(len(text))

    # wordpiece
    out: list[tuple[int, int, int, int]] = []
    for wtext, wstart, wend, widx in words:
        if len(out) >= cap:
            break
        if len(wtext) > MAX_WORD_CHARS:
            out.append((unk_id, widx, wstart, wend))
            continue
        exact = len(wtext) == wend - wstart
        pieces: list[tuple[int, int, int]] = []
        start = 0
        ok = True
        while start < len(wtext):
            end = len(wtext)
            found = -1
            while end > start:
                probe = ("##" if start else "") + wtext[start:end]
                pid = vocab.get(probe)
                if pid is not None:
                    found = pid
                    break
                end -= 1
            if found < 0:
                ok = False
                break
            pieces.append((found, start, end))
            start = end
        if not ok:
            out.append((unk_id, widx, wstart, wend))
            continue
        for pid, s, e in pieces:
            if len(out) >= cap:
                break
            if exact:
                out.append((pid, widx, wstart + s, wstart + e))
            else:
                out.append((pid, widx, wstart, wend))
    return out[:cap]


def tokenize_batch_py(vocab, texts: Sequence[str], lowercase: bool,
                      unk_id: int, cap: int):
    """Batch version of :func:`tokenize_text_py` with the array contract the
    native core uses: (ids, word_ids, starts, ends) int32 [n, cap] + counts."""
    n = len(texts)
    ids = np.zeros((n, cap), np.int32)
    word_ids = np.full((n, cap), -1, np.int32)
    starts = np.zeros((n, cap), np.int32)
    ends = np.zeros((n, cap), np.int32)
    counts = np.zeros(n, np.int32)
    for r, text in enumerate(texts):
        toks = tokenize_text_py(vocab, text, lowercase, unk_id, cap)
        counts[r] = len(toks)
        for t, (pid, widx, s, e) in enumerate(toks):
            ids[r, t] = pid
            word_ids[r, t] = widx
            starts[r, t] = s
            ends[r, t] = e
    return ids, word_ids, starts, ends, counts


# ---------------------------------------------------------------------------
# Full tokenizer interface (assembly shared with the native subclass)
# ---------------------------------------------------------------------------

class WordPieceTokenizer:
    """Vocab-true BERT tokenizer (pure Python core).

    Same interface as ``tokenization.WordHashTokenizer`` /
    ``tokenization.HFTokenizer``; construct from a BERT ``vocab.txt``
    (one token per line, line number = id).
    """

    model_max_length = 512

    def __init__(self, vocab: dict[str, int], lowercase: bool = True,
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", pad_token: str = "[PAD]"):
        self.vocab = vocab
        self.lowercase = lowercase
        self.unk_token, self.cls_token = unk_token, cls_token
        self.sep_token, self.pad_token = sep_token, pad_token
        for name in (unk_token, cls_token, sep_token, pad_token):
            if name not in vocab:
                raise ValueError(f"special token {name!r} missing from vocab")
        self.unk_token_id = vocab[unk_token]
        self.cls_token_id = vocab[cls_token]
        self.sep_token_id = vocab[sep_token]
        self.pad_token_id = vocab[pad_token]
        # optional: BERT vocabs ship [MASK]; None when absent (MLM
        # dataset building raises a clear error in that case)
        self.mask_token_id = vocab.get("[MASK]")
        self.vocab_size = len(vocab)
        self._inv_vocab = {i: t for t, i in vocab.items()}

    def convert_ids_to_tokens(self, ids) -> list[str]:
        return [self._inv_vocab.get(int(i), self.unk_token) for i in ids]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        """Ids → text with WordPiece continuation (##) re-joining."""
        specials = {self.pad_token, self.cls_token, self.sep_token,
                    self.unk_token, "[MASK]"}
        words: list[str] = []
        for tok in self.convert_ids_to_tokens(ids):
            if skip_special_tokens and tok in specials:
                continue
            if tok.startswith("##") and words:
                words[-1] += tok[2:]
            else:
                words.append(tok)
        return " ".join(words)

    # -- core: overridden by the C++-backed subclass ------------------------

    def _tokenize_batch(self, texts: Sequence[str], cap: int):
        return tokenize_batch_py(self.vocab, texts, self.lowercase,
                                 self.unk_token_id, cap)

    # -- interface ----------------------------------------------------------

    def __call__(self, texts, truncation: bool = True, padding: str = "max_length",
                 max_length: int | None = None, text_pairs=None,
                 add_special_tokens: bool = True):
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        n = len(texts)
        cap = max_length if truncation else max(max_length, 1 << 16)
        a_ids, _, _, _, a_cnt = self._tokenize_batch(texts, cap)
        if text_pairs is not None:
            b_ids, _, _, _, b_cnt = self._tokenize_batch(list(text_pairs), cap)

        rows, segs = [], []
        for r in range(n):
            a = list(a_ids[r, :a_cnt[r]])
            if text_pairs is None:
                if truncation and add_special_tokens:
                    a = a[:max_length - 2]
                ids = ([self.cls_token_id] + a + [self.sep_token_id]
                       if add_special_tokens else a[:max_length] if truncation else a)
                seg = [0] * len(ids)
            else:
                b = list(b_ids[r, :b_cnt[r]])
                n_special = 3 if add_special_tokens else 0
                if truncation:
                    # HF longest_first: drop tail tokens from whichever
                    # segment is currently longer until the pair fits,
                    # keeping both separators
                    # ties drop from the pair side, per HF truncate_sequences
                    budget = max_length - n_special
                    while len(a) + len(b) > budget and (a or b):
                        if len(a) > len(b):
                            a.pop()
                        else:
                            b.pop()
                if add_special_tokens:
                    ids = ([self.cls_token_id] + a + [self.sep_token_id]
                           + b + [self.sep_token_id])
                    seg = [0] * (len(a) + 2) + [1] * (len(b) + 1)
                else:
                    ids = a + b
                    seg = [0] * len(a) + [1] * len(b)
            if truncation and len(ids) > max_length:
                ids, seg = ids[:max_length], seg[:max_length]
            rows.append(ids)
            segs.append(seg)

        longest = max((len(i) for i in rows), default=1)
        if not truncation and longest > max_length:
            # HF semantics: truncation=False means rows are never clipped —
            # grow the padded width to the longest row, or refuse when the
            # caller pinned the width with padding="max_length"
            if padding == "max_length":
                raise ValueError(
                    f"row of {longest} tokens exceeds max_length={max_length} "
                    "and truncation is disabled; pass truncation=True or "
                    "padding='longest'")
            max_length = longest
        elif padding == "longest":
            max_length = min(max_length, longest)
        input_ids = np.full((n, max_length), self.pad_token_id, np.int32)
        attention_mask = np.zeros((n, max_length), np.int32)
        token_type_ids = np.zeros((n, max_length), np.int32)
        for r, (ids, seg) in enumerate(zip(rows, segs)):
            ids, seg = ids[:max_length], seg[:max_length]
            input_ids[r, :len(ids)] = ids
            attention_mask[r, :len(ids)] = 1
            token_type_ids[r, :len(seg)] = seg
        out = {"input_ids": input_ids, "attention_mask": attention_mask}
        if text_pairs is not None:
            out["token_type_ids"] = token_type_ids
        return out

    def encode_words(self, word_lists, max_length: int | None = None):
        """Pre-split words → subword ids + word alignment (NER path;
        fast-tokenizer ``word_ids()`` contract, -1 on specials/pads)."""
        max_length = max_length or self.model_max_length
        n = len(word_lists)
        # Tokenize each row's words joined by spaces: word_index from the
        # core is then exactly the source-word index (words contain no
        # whitespace in token-classification corpora).
        joined = [" ".join(words) for words in word_lists]
        ids, wids, _, _, cnt = self._tokenize_batch(joined, max_length)
        input_ids = np.full((n, max_length), self.pad_token_id, np.int32)
        attention_mask = np.zeros((n, max_length), np.int32)
        word_ids = np.full((n, max_length), -1, np.int32)
        for r in range(n):
            k = min(int(cnt[r]), max_length - 2)
            row = [self.cls_token_id] + list(ids[r, :k]) + [self.sep_token_id]
            wrow = [-1] + list(wids[r, :k]) + [-1]
            input_ids[r, :len(row)] = row
            attention_mask[r, :len(row)] = 1
            word_ids[r, :len(wrow)] = wrow
        return {"input_ids": input_ids, "attention_mask": attention_mask,
                "word_ids": word_ids}

    def encode_qa(self, questions, contexts, start_chars=None,
                  answer_texts=None, max_length: int | None = None,
                  return_offsets: bool = False, doc_stride: int = 0):
        """Question+context pairs → ids + answer token spans via the
        code-point offsets the core emits (HF offset_mapping semantics,
        truncation="only_second"). ``return_offsets`` adds
        ``offset_starts``/``offset_ends`` (char offsets into the context
        per CONTEXT token, -1 elsewhere) for answer-text decoding.
        ``start_chars``/``answer_texts`` may be None (inference).
        ``doc_stride > 0``: overlapping context windows instead of
        truncation, with ``example_ids`` mapping features → inputs
        (shared assembly with the WordHash tier, data/tokenization.py)."""
        from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.tokenization import (
            _qa_assemble,
            _qa_feature,
            _qa_windows,
        )

        max_length = max_length or self.model_max_length
        n = len(questions)
        q_ids, _, _, _, q_cnt = self._tokenize_batch(list(questions), max_length)
        if doc_stride <= 0:
            c_ids, _, c_starts, c_ends, c_cnt = self._tokenize_batch(
                list(contexts), max_length)
        else:
            # with stride the windows must see the WHOLE context, not a
            # max_length-truncated one. Tokenize in row chunks with a
            # per-chunk width bounded by the chunk's longest context in
            # CHARS (a wordpiece is >= 1 char), so the buffers stay
            # ~chunk x actual-need instead of n x 8192 for the split
            CHUNK, HARD_CAP = 128, 8192
            parts = []
            warned_cap = False
            for lo in range(0, n, CHUNK):
                chunk = list(contexts[lo:lo + CHUNK])
                cap = max(max_length,
                          min(HARD_CAP, max(len(c) for c in chunk)))
                part = self._tokenize_batch(chunk, cap)
                # stride mode promises windows covering the WHOLE
                # context; a row that FILLS a HARD_CAP-wide buffer was
                # (in all but the exact-fit edge case) truncated there —
                # answers past the cap become unlabeled and unfindable,
                # so make it loud. (A char-capped buffer can't truncate:
                # a wordpiece is >= 1 char, so tokens <= chars <= cap.)
                if (cap == HARD_CAP and not warned_cap
                        and int(np.max(part[4])) >= cap):
                    warned_cap = True
                    import logging
                    logging.getLogger(__name__).warning(
                        "doc-stride tokenization: a context filled the "
                        "%d-token buffer cap and was TRUNCATED — answers "
                        "past the cap are unreachable (warning once per "
                        "call)", HARD_CAP)
                parts.append(part)
            widest = max(p[0].shape[1] for p in parts)

            def pad_to(a, fill):
                out = np.full((a.shape[0], widest), fill, a.dtype)
                out[:, :a.shape[1]] = a
                return out

            c_ids = np.concatenate([pad_to(p[0], self.pad_token_id)
                                    for p in parts])
            c_starts = np.concatenate([pad_to(p[2], 0) for p in parts])
            c_ends = np.concatenate([pad_to(p[3], 0) for p in parts])
            c_cnt = np.concatenate([p[4] for p in parts])

        rows = []
        for r in range(n):
            # only_second truncation: question keeps its tokens (capped so
            # CLS/q/SEP/SEP still fit), context gets the remaining room
            nq = min(int(q_cnt[r]), max_length - 3)
            nc = int(c_cnt[r])
            spans = [(int(c_starts[r, t]), int(c_ends[r, t]))
                     for t in range(nc)]
            labeled = start_chars is not None
            a_start = start_chars[r] if labeled else 0
            a_end = a_start + (len(answer_texts[r]) if labeled else 0)
            for w0, nw in _qa_windows(nq, nc, max_length, doc_stride):
                rows.append(_qa_feature(
                    r, list(q_ids[r, :nq]), list(c_ids[r, w0:w0 + nw]),
                    spans[w0:w0 + nw], max_length, labeled, a_start, a_end,
                    self.cls_token_id, self.sep_token_id))
        return _qa_assemble(rows, max_length, self.pad_token_id,
                            return_offsets, token_type=True)

    # -- persistence (HF vocab.txt layout: save_pretrained parity,
    #    reference scripts/train.py:183) -----------------------------------

    def save_pretrained(self, output_dir: str) -> None:
        os.makedirs(output_dir, exist_ok=True)
        inv = sorted(self.vocab.items(), key=lambda kv: kv[1])
        with open(os.path.join(output_dir, "vocab.txt"), "w", encoding="utf-8") as f:
            for token, _ in inv:
                f.write(token + "\n")
        import json
        with open(os.path.join(output_dir, "tokenizer_config.json"), "w") as f:
            json.dump({"tokenizer_class": "BertTokenizer",
                       "do_lower_case": self.lowercase,
                       "model_max_length": self.model_max_length}, f)

    @classmethod
    def from_pretrained(cls, path: str, lowercase: Optional[bool] = None,
                        **kw) -> "WordPieceTokenizer":
        vocab_file = path if path.endswith(".txt") else os.path.join(path, "vocab.txt")
        vocab: dict[str, int] = {}
        with open(vocab_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\r\n")] = i
        cfg = {}
        cfg_path = os.path.join(os.path.dirname(vocab_file), "tokenizer_config.json")
        if os.path.exists(cfg_path):
            import json
            with open(cfg_path) as f:
                cfg = json.load(f)
        if lowercase is None:
            lowercase = bool(cfg.get("do_lower_case", True))
        tok = cls(vocab, lowercase=lowercase, **kw)
        tok.model_max_length = int(cfg.get("model_max_length", cls.model_max_length))
        return tok
