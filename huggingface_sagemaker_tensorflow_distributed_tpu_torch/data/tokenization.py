"""Tokenization (counterpart of the JAX package's ``data/tokenization.py``).

:class:`WordHashTokenizer` is the dependency-free tokenizer: words hash
(md5) into buckets, with PAD/CLS/SEP/UNK specials, so the same text gives
the same ids in every process and in both packages. The WordPiece and HF
tokenizer branches of :func:`load_tokenizer` raise until they are ported
(ROADMAP slice 2 follow-ups).
"""

from __future__ import annotations

import hashlib
import json
import os
import re

import numpy as np

_WORD = re.compile(r"\w+|[^\w\s]")


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


def load_tokenizer(model_name_or_path: str, vocab_size: int = 30522):
    """The JAX package's tokenizer choice: a saved hash tokenizer loads as
    such; ``vocab.txt``/``tokenizer.json``/``spiece.model`` files (the
    WordPiece and HF tokenizers) raise until ported; no tokenizer files at
    all give the hash tokenizer."""
    if os.path.isdir(model_name_or_path):
        if os.path.exists(os.path.join(model_name_or_path, "word_hash_tokenizer.json")):
            return WordHashTokenizer.from_pretrained(model_name_or_path)
        found = [f for f in ("vocab.txt", "tokenizer.json", "spiece.model",
                             "tokenizer_config.json")
                 if os.path.exists(os.path.join(model_name_or_path, f))]
        if found:
            raise NotImplementedError(
                f"{model_name_or_path!r} holds {found}: the WordPiece and HF "
                "tokenizers are not ported to the PyTorch package yet "
                "(ROADMAP slice 2 follow-ups)")
    return WordHashTokenizer(vocab_size=vocab_size)
