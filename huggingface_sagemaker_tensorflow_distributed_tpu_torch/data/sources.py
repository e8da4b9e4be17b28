"""Text-classification sources (counterpart of the JAX package's
``data/sources.py::load_text_classification``): the seeded ``synthetic``
corpus, the in-repo ``vendored_reviews`` corpus (``data/vendored/reviews``
beside the package), local ``{split}.jsonl`` files of ``{"text": ...,
"label": ...}`` records, ``datasets.load_from_disk`` directories, and HF
datasets by name (``imdb``, ``sst2``) through ``datasets.load_dataset``.
``datasets`` is imported only on those last two paths. All return plain
``(texts, labels)`` lists."""

from __future__ import annotations

import json
import os
import random
from pathlib import Path
from typing import Optional

_CLASS_WORDS = {
    0: ["terrible", "boring", "awful", "worst", "dull", "waste", "poor", "bad",
        "disappointing", "mess", "weak", "flat"],
    1: ["wonderful", "brilliant", "great", "best", "moving", "superb", "rich",
        "good", "delightful", "masterpiece", "strong", "sharp"],
}
_NOISE_WORDS = (
    "the a an of in on at this that movie film plot actor scene story it was is "
    "were be with and or but for from about into over after before very really "
    "quite some most one two three while during director camera script character"
).split()

_HF_TEXT_DATASETS = {
    # name -> (load args, text column, label column)
    "imdb": (("imdb",), "text", "label"),
    "sst2": (("glue", "sst2"), "sentence", "label"),
}

VENDORED_REVIEWS = Path(__file__).resolve().parents[2] / "data" / "vendored" / "reviews"


def synthetic_text_classification(n: int, seed: int = 0, num_labels: int = 2,
                                  min_len: int = 40, max_len: int = 160
                                  ) -> tuple[list[str], list[int]]:
    """IMDb-shaped synthetic corpus: label-correlated words in word noise
    (the JAX package's generator, draw for draw)."""
    rng = random.Random(seed)
    texts, labels = [], []
    for i in range(n):
        label = i % num_labels
        length = rng.randint(min_len, max_len)
        signal = _CLASS_WORDS[label % 2]
        words = [rng.choice(signal) if rng.random() < 0.25 else rng.choice(_NOISE_WORDS)
                 for _ in range(length)]
        texts.append(" ".join(words))
        labels.append(label)
    return texts, labels


def _from_jsonl(path: str) -> tuple[list[str], list[int]]:
    texts, labels = [], []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            texts.append(rec["text"])
            labels.append(int(rec["label"]))
    return texts, labels


def load_text_classification(dataset: str, split: str,
                             dataset_path: Optional[str] = None,
                             max_samples: Optional[int] = None,
                             seed: int = 0) -> tuple[list[str], list[int]]:
    """Load a text-classification split as (texts, labels)."""
    if dataset == "synthetic":
        n = max_samples or (2000 if split == "train" else 400)
        return synthetic_text_classification(n, seed=seed + (0 if split == "train" else 1))
    if dataset == "vendored_reviews" and not dataset_path:
        dataset_path = str(VENDORED_REVIEWS)
    if dataset_path:
        jsonl = os.path.join(dataset_path, f"{split}.jsonl")
        if os.path.exists(jsonl):
            texts, labels = _from_jsonl(jsonl)
        else:
            from datasets import load_from_disk
            ds = load_from_disk(dataset_path)[split]
            text_col = "text" if "text" in ds.column_names else "sentence"
            texts, labels = list(ds[text_col]), list(ds["label"])
    else:
        if dataset not in _HF_TEXT_DATASETS:
            raise ValueError(f"unknown dataset {dataset!r}")
        load_args, text_col, label_col = _HF_TEXT_DATASETS[dataset]
        from datasets import load_dataset
        ds = load_dataset(*load_args, split=split)
        texts, labels = list(ds[text_col]), list(ds[label_col])
    if max_samples is not None:
        texts, labels = texts[:max_samples], labels[:max_samples]
    return texts, labels
