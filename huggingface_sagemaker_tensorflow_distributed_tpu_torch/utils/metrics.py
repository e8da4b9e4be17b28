"""Host-side text metrics (the port's copy of the JAX package's
``utils/metrics.py``): sentence-level ROUGE-L for generated summaries,
and SQuAD's official answer normalization, corpus exact match and token
F1, answer decoding from span logits, and the doc-stride aggregation over
a context's windows. Numpy-only; token-level micro-F1 is summed in the
eval step instead (``train/trainer.py::token_cls_loss``)."""

from __future__ import annotations

import re
import string
from collections import Counter
from typing import Sequence

import numpy as np

_ARTICLES = re.compile(r"\b(a|an|the)\b")


def _lcs_len(a: Sequence, b: Sequence) -> int:
    """Longest-common-subsequence length, one rolling row."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def _rouge_tokens(text: str) -> list[str]:
    """rouge_score's default tokenization: lowercase alphanumeric runs."""
    return re.findall(r"[a-z0-9]+", text.lower())


def rouge_l(predictions: Sequence[str], references: Sequence[str]) -> dict:
    """Corpus ROUGE-L: each pair's LCS precision, recall and F1 over its
    tokens, averaged over the pairs (``rougeL_precision``,
    ``rougeL_recall``, ``rougeL_f1``)."""
    if len(predictions) != len(references):
        raise ValueError("predictions and references must align")
    ps, rs, fs = [], [], []
    for pred, ref in zip(predictions, references):
        p_toks, r_toks = _rouge_tokens(pred), _rouge_tokens(ref)
        lcs = _lcs_len(p_toks, r_toks)
        p = lcs / len(p_toks) if p_toks else 0.0
        r = lcs / len(r_toks) if r_toks else 0.0
        ps.append(p)
        rs.append(r)
        fs.append(2 * p * r / (p + r) if p + r else 0.0)
    n = max(len(fs), 1)
    return {"rougeL_precision": sum(ps) / n, "rougeL_recall": sum(rs) / n,
            "rougeL_f1": sum(fs) / n}


def squad_normalize(text: str) -> str:
    """The official SQuAD answer normalization, in its order: lowercase,
    REMOVE punctuation ('U.S.' must equal 'US'), drop English articles,
    collapse whitespace."""
    text = text.lower()
    text = "".join(ch for ch in text if ch not in string.punctuation)
    text = _ARTICLES.sub(" ", text)
    return " ".join(text.split())


def squad_em_f1(predictions: Sequence[str], references: Sequence[str]) -> dict:
    """Corpus exact match and token-level F1 over normalized answer texts
    (official SQuAD v1 scoring, one reference per example), in percent."""
    if len(predictions) != len(references):
        raise ValueError("predictions and references must align")
    em_total = f1_total = 0.0
    for pred, ref in zip(predictions, references):
        p = squad_normalize(pred)
        r = squad_normalize(ref)
        em_total += float(p == r)
        p_toks, r_toks = p.split(), r.split()
        if not p_toks or not r_toks:
            f1_total += float(p_toks == r_toks)
            continue
        # multiset intersection (the official script's Counter overlap)
        common = sum((Counter(p_toks) & Counter(r_toks)).values())
        if common == 0:
            continue
        prec = common / len(p_toks)
        rec = common / len(r_toks)
        f1_total += 2 * prec * rec / (prec + rec)
    n = max(len(predictions), 1)
    return {"exact_match": 100.0 * em_total / n, "f1": 100.0 * f1_total / n}


def extract_answer_spans(start_logits, end_logits, offset_starts, offset_ends,
                         contexts: Sequence[str], max_answer_len: int = 30,
                         with_spans: bool = False, with_scores: bool = False):
    """Answer texts decoded from span logits (HF run_qa's n-best search
    collapsed to the argmax pair): the best (s, e) with s <= e <= s +
    ``max_answer_len`` over CONTEXT tokens only (offsets >= 0); a row
    without one decodes to "" (no answer).

    ``offset_starts``/``offset_ends`` are char offsets into each context,
    -1 outside it (``encode_qa(return_offsets=True)``). With
    ``with_spans`` each element is ``(text, start_token, end_token)``
    (-1/-1 for no answer); with ``with_scores`` the pair score (start +
    end logit; -inf for no answer) is appended, the doc-stride
    aggregation key."""
    out = []
    s_l = np.asarray(start_logits)
    e_l = np.asarray(end_logits)
    for r in range(len(contexts)):
        idx = np.flatnonzero(np.asarray(offset_starts[r]) >= 0)
        text, s_tok, e_tok, score = "", -1, -1, float("-inf")
        if len(idx):
            pair = s_l[r][idx][:, None] + e_l[r][idx][None, :]
            d = idx[None, :] - idx[:, None]
            pair = np.where((d >= 0) & (d <= max_answer_len), pair, -np.inf)
            s_i, e_i = np.unravel_index(np.argmax(pair), pair.shape)
            if np.isfinite(pair[s_i, e_i]):
                s_tok, e_tok = int(idx[s_i]), int(idx[e_i])
                score = float(pair[s_i, e_i])
                text = contexts[r][offset_starts[r][s_tok]:offset_ends[r][e_tok]]
        row = (text,)
        if with_spans:
            row += (s_tok, e_tok)
        if with_scores:
            row += (score,)
        out.append(row if len(row) > 1 else text)
    return out


def best_windowed_answers(texts: Sequence[str], scores: Sequence[float],
                          example_ids: Sequence[int], n_examples: int) -> list[str]:
    """Doc-stride aggregation (HF run_qa, argmax collapsed): each
    example's answer is its highest-scoring span across its windows; an
    example whose every window decodes no answer gets ""."""
    best = [""] * n_examples
    best_score = [float("-inf")] * n_examples
    for text, score, ex in zip(texts, scores, example_ids):
        ex = int(ex)
        if score > best_score[ex]:
            best_score[ex] = score
            best[ex] = text
    return best
