"""Text-classification sources (counterpart of the JAX package's
``data/sources.py::load_text_classification``): the seeded ``synthetic``
corpus, the in-repo ``vendored_reviews`` corpus (``data/vendored/reviews``
beside the package), and local ``{split}.jsonl`` files of
``{"text": ..., "label": ...}`` records. HF ``datasets`` by name and
``load_from_disk`` directories raise until ported. All return plain
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
    if not dataset_path:
        raise NotImplementedError(
            f"dataset {dataset!r} needs HF datasets, which the PyTorch package "
            "does not load yet (ROADMAP slice 2 follow-ups); use synthetic, "
            "vendored_reviews or --dataset_path with {split}.jsonl files")
    jsonl = os.path.join(dataset_path, f"{split}.jsonl")
    if not os.path.exists(jsonl):
        raise NotImplementedError(
            f"{dataset_path!r} has no {split}.jsonl; load_from_disk datasets "
            "are not ported to the PyTorch package yet (ROADMAP slice 2 follow-ups)")
    texts, labels = _from_jsonl(jsonl)
    if max_samples is not None:
        texts, labels = texts[:max_samples], labels[:max_samples]
    return texts, labels
