"""Dataset sources (counterpart of the JAX package's ``data/sources.py``).

- Text classification (``load_text_classification``): the seeded
  ``synthetic`` corpus, the in-repo ``vendored_reviews`` corpus
  (``data/vendored/reviews`` beside the package), local ``{split}.jsonl``
  files of ``{"text": ..., "label": ...}`` records,
  ``datasets.load_from_disk`` directories, and HF datasets by name
  (``imdb``, ``sst2``) through ``datasets.load_dataset``. Returns
  ``(texts, labels)``.
- Token classification (``load_token_classification``): the seeded
  CoNLL-shaped ``synthetic`` NER corpus, ``conll2003`` from the hub, or
  ``{split}.jsonl`` of ``{"tokens": [...], "tags": [...]}``. Returns
  ``(sentences, per-word tags)``.
- Extractive QA (``load_qa``): the seeded SQuAD-shaped ``synthetic``
  corpus, ``squad`` from the hub, or ``{split}.jsonl`` of ``{"question",
  "context", "answer_start", "answer"}``. Returns ``(questions, contexts,
  answer start chars, answer texts)``.
- Seq2seq (``load_seq2seq``): the seeded CNN/DailyMail-shaped
  ``synthetic`` summarization corpus, ``cnn_dailymail`` (3.0.0) and
  ``xsum`` from the hub, or ``{split}.jsonl`` of ``{"source", "target"}``.
  Returns ``(sources, targets)``.

``datasets`` is imported only on the hub and ``load_from_disk`` paths;
the synthetic generators are the JAX package's, draw for draw."""

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


# -- token classification (NER) ----------------------------------------------

_ENTITY_WORDS = {
    1: ["alice", "bob", "carol", "david", "erin", "frank"],          # PER
    2: ["paris", "london", "berlin", "tokyo", "oslo", "cairo"],      # LOC
    3: ["acme", "globex", "initech", "umbrella", "stark", "wayne"],  # ORG
}


def synthetic_token_classification(n: int, seed: int = 0, min_len: int = 8,
                                   max_len: int = 24
                                   ) -> tuple[list[list[str]], list[list[int]]]:
    """CoNLL-shaped synthetic NER: word lists and per-word tag ids. Tag 0
    is O; tags 1/2/3 (PER/LOC/ORG) come with their own entity words, so
    the task is learnable offline."""
    rng = random.Random(seed)
    sents, tags = [], []
    for _ in range(n):
        length = rng.randint(min_len, max_len)
        words, wtags = [], []
        for _ in range(length):
            if rng.random() < 0.3:
                tag = rng.randint(1, 3)
                words.append(rng.choice(_ENTITY_WORDS[tag]))
                wtags.append(tag)
            else:
                words.append(rng.choice(_NOISE_WORDS))
                wtags.append(0)
        sents.append(words)
        tags.append(wtags)
    return sents, tags


def load_token_classification(dataset: str, split: str,
                              dataset_path: Optional[str] = None,
                              max_samples: Optional[int] = None, seed: int = 0
                              ) -> tuple[list[list[str]], list[list[int]]]:
    """Word-level NER data as (sentences, per-word tag ids)."""
    if dataset == "synthetic":
        n = max_samples or (2000 if split == "train" else 400)
        return synthetic_token_classification(n, seed=seed + (0 if split == "train" else 1))
    if dataset == "conll2003":
        from datasets import load_dataset
        ds = load_dataset("conll2003", split="validation" if split == "test" else split,
                          trust_remote_code=True)
        if max_samples is not None:
            ds = ds.select(range(min(max_samples, len(ds))))
        sents, tags = list(ds["tokens"]), list(ds["ner_tags"])
    elif dataset_path:
        sents, tags = [], []
        with open(os.path.join(dataset_path, f"{split}.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                sents.append(rec["tokens"])
                tags.append([int(t) for t in rec["tags"]])
    else:
        raise ValueError(f"unknown token-cls dataset {dataset!r}")
    if max_samples is not None:
        sents, tags = sents[:max_samples], tags[:max_samples]
    return sents, tags


# -- extractive QA (SQuAD) ----------------------------------------------------

def synthetic_qa(n: int, seed: int = 0, ctx_len: tuple[int, int] = (30, 80)
                 ) -> tuple[list[str], list[str], list[int], list[str]]:
    """SQuAD-shaped synthetic QA: (questions, contexts, answer start char,
    answer text). The answer is an entity word planted in word noise and
    the question names its class, so spans are learnable offline."""
    rng = random.Random(seed)
    questions, contexts, starts, answers = [], [], [], []
    class_names = {1: "person", 2: "place", 3: "company"}
    for _ in range(n):
        tag = rng.randint(1, 3)
        answer = rng.choice(_ENTITY_WORDS[tag])
        length = rng.randint(*ctx_len)
        words = [rng.choice(_NOISE_WORDS) for _ in range(length)]
        pos = rng.randint(1, length - 2)
        words[pos] = answer
        questions.append(f"which {class_names[tag]} is mentioned here ?")
        contexts.append(" ".join(words))
        starts.append(len(" ".join(words[:pos])) + (1 if pos else 0))
        answers.append(answer)
    return questions, contexts, starts, answers


def load_qa(dataset: str, split: str, dataset_path: Optional[str] = None,
            max_samples: Optional[int] = None, seed: int = 0
            ) -> tuple[list[str], list[str], list[int], list[str]]:
    """Extractive QA as (questions, contexts, answer start char, answer
    text); ``squad`` keeps each example's first answer and skips
    unanswerable ones."""
    if dataset == "synthetic":
        n = max_samples or (2000 if split == "train" else 400)
        return synthetic_qa(n, seed=seed + (0 if split == "train" else 1))
    questions, contexts, starts, answers = [], [], [], []
    if dataset == "squad":
        from datasets import load_dataset
        ds = load_dataset("squad", split="validation" if split == "test" else split)
        for rec in ds:
            if max_samples is not None and len(questions) >= max_samples:
                break
            ans = rec["answers"]
            if not ans["text"]:
                continue
            questions.append(rec["question"])
            contexts.append(rec["context"])
            starts.append(int(ans["answer_start"][0]))
            answers.append(ans["text"][0])
    elif dataset_path:
        with open(os.path.join(dataset_path, f"{split}.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                questions.append(rec["question"])
                contexts.append(rec["context"])
                starts.append(int(rec["answer_start"]))
                answers.append(rec["answer"])
    else:
        raise ValueError(f"unknown qa dataset {dataset!r}")
    if max_samples is not None:
        questions, contexts = questions[:max_samples], contexts[:max_samples]
        starts, answers = starts[:max_samples], answers[:max_samples]
    return questions, contexts, starts, answers


def synthetic_summarization(n: int, seed: int = 0, doc_len: tuple[int, int] = (60, 160)
                            ) -> tuple[list[str], list[str]]:
    """CNN/DM-shaped summarization pairs: each document plants 3 entity
    words in word noise, and its summary is those words in order."""
    rng = random.Random(seed)
    all_entities = [w for ws in _ENTITY_WORDS.values() for w in ws]
    docs, summaries = [], []
    for _ in range(n):
        length = rng.randint(*doc_len)
        keys = rng.sample(all_entities, 3)
        words = [rng.choice(_NOISE_WORDS) for _ in range(length)]
        for pos, key in zip(sorted(rng.sample(range(length), 3)), keys):
            words[pos] = key
        docs.append(" ".join(words))
        summaries.append(" ".join(keys))
    return docs, summaries


def load_seq2seq(dataset: str, split: str, dataset_path: Optional[str] = None,
                 max_samples: Optional[int] = None, seed: int = 0
                 ) -> tuple[list[str], list[str]]:
    """Seq2seq pairs as (source texts, target texts)."""
    if dataset == "synthetic":
        n = max_samples or (2000 if split == "train" else 400)
        return synthetic_summarization(n, seed=seed + (0 if split == "train" else 1))
    hub = {"cnn_dailymail": (("cnn_dailymail", "3.0.0"), {}, "article", "highlights"),
           "xsum": (("xsum",), {"trust_remote_code": True}, "document", "summary")}
    if dataset in hub:
        from datasets import load_dataset

        args, kw, src_col, tgt_col = hub[dataset]
        ds = load_dataset(*args, split="validation" if split == "test" else split, **kw)
        if max_samples is not None:
            ds = ds.select(range(min(max_samples, len(ds))))
        return list(ds[src_col]), list(ds[tgt_col])
    if dataset_path:
        sources, targets = [], []
        with open(os.path.join(dataset_path, f"{split}.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                sources.append(rec["source"])
                targets.append(rec["target"])
        if max_samples is not None:
            sources, targets = sources[:max_samples], targets[:max_samples]
        return sources, targets
    raise ValueError(f"unknown seq2seq dataset {dataset!r}")
