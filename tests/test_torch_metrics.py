"""PyTorch port: the QA answer metrics (``utils/metrics.py``) and the
token-cls micro-F1 (``train/trainer.py::token_cls_loss`` sums, the
``eval_f1`` of ``Trainer.evaluate``) against the JAX package over
hypothesis-drawn strings, logits and offsets: SQuAD's normalization,
exact match and F1, span decoding (with spans and scores), the
doc-stride aggregation over multi-window examples, and the F1 counts.

Tolerances: strings, spans and counts exact; scores and percentages
equal as floats (the same float64 arithmetic in the same order)."""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import (
    token_cls_loss,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils import metrics as t_m

SETTINGS = settings(max_examples=60, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])
# answer-like text: few words (so predictions and references overlap),
# articles, punctuation, case and spacing
WORDS = st.sampled_from(["the", "a", "an", "U.S.", "us", "Paris", "paris", "New", "york",
                         "alice's", "1,000", "co-op", "é", "théâtre", "!", "(b)"])
TEXT = st.lists(WORDS, max_size=6).map(" ".join) | st.text(max_size=20)
SPACED = st.tuples(TEXT, st.sampled_from(["", " ", "  ", "\t", "\n"])).map(
    lambda t: t[1] + t[0].replace(" ", t[1] or " ") + t[1])


@pytest.fixture(autouse=True, scope="module")
def _detached_compile_trackers():
    """A compile tracker that an earlier telemetry test installed in this
    worker rejects the ``fun_name`` keyword jax 0.9 passes to duration
    listeners, failing every later jax compile in the worker. Remove every
    installed tracker before and after this module, leaving the worker as a
    fresh one would be (a later telemetry test installs its own). (The
    card's machine runs the ``gpu`` tests without JAX: nothing to remove.)"""
    _drop_compile_trackers()
    yield
    _drop_compile_trackers()


def _drop_compile_trackers():
    try:
        from jax import monitoring

        from huggingface_sagemaker_tensorflow_distributed_tpu.obs import watchdog
    except ImportError:
        return
    for tracker in watchdog._INSTALLED:
        try:
            monitoring.unregister_event_duration_listener(tracker.observe)
        except AssertionError:
            pass
    watchdog._INSTALLED.clear()


def _jax_metrics():
    from huggingface_sagemaker_tensorflow_distributed_tpu.utils import metrics

    return metrics


@SETTINGS
@given(SPACED)
def test_squad_normalize_matches_jax(text):
    assert t_m.squad_normalize(text) == _jax_metrics().squad_normalize(text)


@SETTINGS
@given(st.lists(st.tuples(SPACED, SPACED), max_size=8))
def test_squad_em_f1_matches_jax(pairs):
    preds, refs = [p for p, _ in pairs], [r for _, r in pairs]
    got = t_m.squad_em_f1(preds, refs)
    assert got == _jax_metrics().squad_em_f1(preds, refs)
    assert 0.0 <= got["exact_match"] <= got["f1"] + 1e-9 and got["f1"] <= 100.0 + 1e-9


def test_squad_em_f1_known_values_and_misaligned():
    got = t_m.squad_em_f1(["The U.S.", "new york city", ""], ["us", "New York", ""])
    assert got["exact_match"] == pytest.approx(200 / 3)
    assert got["f1"] == pytest.approx(100 * (1 + 0.8 + 1) / 3)
    with pytest.raises(ValueError, match="align"):
        t_m.squad_em_f1(["a"], [])


@st.composite
def span_rows(draw):
    """Logits for R rows of width S, each row's context tokens (char
    offsets, -1 elsewhere, sometimes none) and its context string."""
    rows = draw(st.integers(1, 4))
    width = draw(st.integers(2, 24))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    rng = np.random.RandomState(seed)
    # coarse values make exact ties between pairs likely
    scale = draw(st.sampled_from([1.0, 0.5]))
    s_l = rng.randint(-3, 4, (rows, width)).astype(np.float32) * scale
    e_l = rng.randint(-3, 4, (rows, width)).astype(np.float32)
    starts = np.full((rows, width), -1, np.int32)
    ends = np.full((rows, width), -1, np.int32)
    contexts = []
    for r in range(rows):
        n_words = draw(st.integers(0, width - 1))
        first = draw(st.integers(1, width - n_words)) if n_words else 1
        words = [draw(st.sampled_from(["alice", "paris", "the", "acme", "x"]))
                 for _ in range(n_words)]
        ctx, pos = "", 0
        for i, w in enumerate(words):
            starts[r, first + i], ends[r, first + i] = pos, pos + len(w)
            ctx += w + " "
            pos += len(w) + 1
        contexts.append(ctx)
    max_len = draw(st.sampled_from([0, 1, 3, 30]))
    return s_l, e_l, starts, ends, contexts, max_len


@SETTINGS
@given(span_rows(), st.booleans(), st.booleans())
def test_extract_answer_spans_matches_jax(rows, with_spans, with_scores):
    s_l, e_l, starts, ends, contexts, max_len = rows
    kw = dict(max_answer_len=max_len, with_spans=with_spans, with_scores=with_scores)
    got = t_m.extract_answer_spans(s_l, e_l, starts, ends, contexts, **kw)
    assert got == _jax_metrics().extract_answer_spans(s_l, e_l, starts, ends, contexts, **kw)
    for r, row in enumerate(got):
        text = row if isinstance(row, str) else row[0]
        assert text in contexts[r]
        if with_spans and text:
            assert 0 <= row[2] - row[1] <= max_len


@SETTINGS
@given(st.lists(st.tuples(st.integers(0, 5), st.sampled_from(["", "alice", "paris", "acme"]),
                          st.sampled_from([float("-inf"), -1.0, 0.0, 0.5, 2.0, 2.0])),
                min_size=1, max_size=20))
def test_best_windowed_answers_matches_jax(windows):
    """Examples with several windows each, ties and no-answer windows:
    the best-scoring window's text, the first among equals, "" when every
    window decodes no answer."""
    ex = [w[0] for w in windows]
    texts = [w[1] if np.isfinite(w[2]) else "" for w in windows]
    scores = [w[2] for w in windows]
    got = t_m.best_windowed_answers(texts, scores, ex, 6)
    assert got == _jax_metrics().best_windowed_answers(texts, scores, ex, 6)
    for e in range(6):
        mine = [(s, t) for x, t, s in zip(ex, texts, scores) if x == e and np.isfinite(s)]
        if not mine:
            assert got[e] == ""
        else:
            best = max(s for s, _ in mine)
            assert got[e] == next(t for s, t in mine if s == best)


class _Logits(torch.nn.Module):
    """A stand-in model that returns the given logits."""

    def __init__(self, logits):
        super().__init__()
        self.logits = torch.from_numpy(logits)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        return self.logits


@settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 4), st.integers(1, 12),
       st.integers(2, 9), st.booleans())
def test_token_cls_f1_counts_match_jax(seed, b, s, c, with_valid):
    """The micro-F1 components (true and false positives and false
    negatives over the non-O tags) and the masked sums equal the JAX
    loss's on drawn logits (ties in the argmax included), labels (-100
    included), masks and valid rows, and the counts taken in numpy."""
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.train.trainer import (
        token_cls_loss as j_loss,
    )

    rng = np.random.RandomState(seed)
    logits = rng.randint(-2, 3, (b, s, c)).astype(np.float32)
    labels = rng.randint(-1, c, (b, s)).astype(np.int32)
    labels[labels < 0] = -100
    mask = (rng.rand(b, s) < 0.8).astype(np.int32)
    batch = {"input_ids": np.zeros((b, s), np.int32), "attention_mask": mask,
             "labels": labels}
    if with_valid:
        batch["valid"] = (rng.rand(b) < 0.7).astype(np.int32)
    _, want = j_loss(lambda *a, **k: jnp.asarray(logits), None,
                     {k: jnp.asarray(v) for k, v in batch.items()}, None, False)
    _, got = token_cls_loss(_Logits(logits), {k: torch.from_numpy(v).long()
                                             for k, v in batch.items()})
    assert set(got) == set(want)
    for key in want:
        if key == "loss_sum":
            assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-6, abs=1e-6)
        else:
            assert float(got[key]) == float(want[key]), key
    valid = (labels != -100) & (mask > 0)
    if with_valid:
        valid &= batch["valid"][:, None] > 0
    pred, gold = logits.argmax(-1), np.maximum(labels, 0)
    ok = pred == gold
    assert float(got["f1_tp"]) == ((pred != 0) & ok & valid).sum()
    assert float(got["f1_fp"]) == ((pred != 0) & ~ok & valid).sum()
    assert float(got["f1_fn"]) == ((gold != 0) & ~ok & valid).sum()
