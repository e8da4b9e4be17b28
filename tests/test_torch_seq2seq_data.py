"""PyTorch port: the seq2seq data stack and ROUGE-L against the JAX package
on the same inputs: the synthetic CNN/DM-shaped corpus and ``.jsonl``
pairs (``data/sources.py``), ``ArrayDataset.from_seq2seq`` and T5's span
corruption (``data/pipeline.py``, with the JAX test's lossless
reconstruction and corruption-rate checks), the streaming ``seq2seq``
tier (``data/streaming.py``) and ``rouge_l`` (``utils/metrics.py``).

Tolerances: columns, texts and the ROUGE-L figures exact."""

import json

import numpy as np
import pytest

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import pipeline as t_pipe
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import sources as t_src
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import streaming as t_stream
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import tokenization as t_tok
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils import metrics as t_metrics
# removes a JAX compile tracker an earlier telemetry test left in the worker
from torch_decode_pairs import detached_compile_trackers  # noqa: F401  (autouse fixture)

VOCAB = 1024
EOS = 1


def _jax_tok():
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import WordHashTokenizer

    return WordHashTokenizer(vocab_size=VOCAB)


def _assert_columns_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]),
                                      err_msg=key)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("seed", [0, 5, 42])
def test_synthetic_summarization_equals_jax(seed, split):
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import sources as j_src

    assert t_src.load_seq2seq("synthetic", split, max_samples=40, seed=seed) == \
        j_src.load_seq2seq("synthetic", split, max_samples=40, seed=seed)


def test_jsonl_pairs_equal_jax(tmp_path):
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import sources as j_src

    docs, sums = t_src.synthetic_summarization(12, seed=3)
    with open(tmp_path / "train.jsonl", "w") as f:
        for d, s in zip(docs, sums):
            f.write(json.dumps({"source": d, "target": s}) + "\n")
    got = t_src.load_seq2seq("local", "train", dataset_path=str(tmp_path), max_samples=10)
    assert got == j_src.load_seq2seq("local", "train", dataset_path=str(tmp_path),
                                     max_samples=10)
    assert got == (docs[:10], sums[:10])
    with pytest.raises(ValueError, match="unknown seq2seq dataset"):
        t_src.load_seq2seq("mystery", "train")


@pytest.mark.parametrize("start,pad,eos", [(0, 0, 1), (2, 1, 2)], ids=["t5", "bart"])
@pytest.mark.parametrize("seed", [0, 9])
def test_from_seq2seq_columns_equal_jax(seed, start, pad, eos):
    """LM-style targets (raw tokens and the model's EOS), ``-100`` labels,
    the shifted decoder inputs and the decoder mask: the JAX columns
    exactly, with T5's and BART's special ids; one target long enough to
    be truncated."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.pipeline import (
        ArrayDataset,
    )

    docs, sums = t_src.synthetic_summarization(16, seed=seed)
    sums[3] = " ".join([sums[3]] * 10)
    kw = dict(max_source_length=96, max_target_length=12, decoder_start_token_id=start,
              pad_token_id=pad, eos_token_id=eos)
    got = t_pipe.ArrayDataset.from_seq2seq(t_tok.WordHashTokenizer(VOCAB), docs, sums, **kw)
    want = ArrayDataset.from_seq2seq(_jax_tok(), docs, sums, **kw)
    _assert_columns_equal(got.columns, want.columns)
    labels = got.columns["labels"]
    assert (labels[3] != -100).all() and labels[3, -1] == eos
    assert got.columns["decoder_input_ids"][0, 0] == start


@pytest.mark.parametrize("seed", [0, 1, 17])
def test_span_corruption_columns_equal_jax(seed):
    """Span corruption draws from ``RandomState(seed)`` in the JAX order:
    every column equal, tiny rows (the EOS-only target) included."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.pipeline import (
        ArrayDataset,
    )

    texts, _ = t_src.load_text_classification("synthetic", "train", max_samples=24,
                                              seed=seed)
    texts += ["hi", "a b", ""]
    kw = dict(max_source_length=64, max_target_length=20, eos_token_id=EOS, seed=seed)
    got = t_pipe.ArrayDataset.from_span_corruption_texts(t_tok.WordHashTokenizer(VOCAB),
                                                         texts, **kw)
    want = ArrayDataset.from_span_corruption_texts(_jax_tok(), texts, **kw)
    _assert_columns_equal(got.columns, want.columns)
    assert (got.columns["decoder_attention_mask"].sum(1) >= 1).all()


def _safe_words(tok, n):
    """Words whose hash buckets stay clear of the sentinel range (a real
    T5 vocab reserves its top ids for the sentinels; the hash tokenizer
    does not)."""
    words, i = [], 0
    while len(words) < n:
        if tok._word_id(f"w{i}") < VOCAB - 120:
            words.append(f"w{i}")
        i += 1
    return words


def _sentinels():
    return set(range(VOCAB - 100, VOCAB))


def test_span_corruption_is_lossless():
    """The JAX test's reconstruction: splicing each target span back into
    its source sentinel gives the clean token stream; the final sentinel
    opens the one empty span; sources end with EOS; sentinels descend."""
    tok = t_tok.WordHashTokenizer(VOCAB)
    texts = [" ".join(_safe_words(tok, 12))] * 8
    ds = t_pipe.ArrayDataset.from_span_corruption_texts(
        tok, texts, max_source_length=64, max_target_length=32, eos_token_id=EOS, seed=0)
    clean = tok(texts, max_length=64, add_special_tokens=False)
    for r in range(len(texts)):
        src = ds.columns["input_ids"][r][ds.columns["attention_mask"][r] > 0]
        tgt = ds.columns["labels"][r]
        tgt = tgt[tgt != -100]
        assert tgt[-1] == EOS and src[-1] == EOS
        spans, cur = {}, None
        for t in tgt[:-1]:
            if int(t) in _sentinels():
                cur = int(t)
                spans[cur] = []
            else:
                spans[cur].append(int(t))
        finals = [s for s, v in spans.items() if not v]
        assert finals == [min(spans)]
        rebuilt = []
        for t in src[:-1]:
            rebuilt += spans[int(t)] if int(t) in _sentinels() else [int(t)]
        np.testing.assert_array_equal(rebuilt, clean["input_ids"][r][clean["attention_mask"][r] > 0])
        sents = [int(t) for t in src if int(t) in _sentinels()]
        assert sents == sorted(sents, reverse=True)


def test_span_corruption_rate():
    """About 15% of the clean tokens land in the targets (the JAX test's
    band, 8-25%), and an extreme rate still partitions."""
    tok = t_tok.WordHashTokenizer(VOCAB)
    texts = [" ".join(_safe_words(tok, 60))] * 20
    ds = t_pipe.ArrayDataset.from_span_corruption_texts(
        tok, texts, max_source_length=64, max_target_length=32, eos_token_id=EOS,
        corruption_rate=0.15, seed=0)
    n_clean = tok(texts, max_length=64, add_special_tokens=False)["attention_mask"].sum()
    dropped = 0
    for r in range(len(texts)):
        tgt = ds.columns["labels"][r]
        dropped += sum(1 for t in tgt[tgt != -100][:-1] if int(t) not in _sentinels())
    assert 0.08 < dropped / n_clean < 0.25
    t_pipe.ArrayDataset.from_span_corruption_texts(
        tok, [" ".join(_safe_words(tok, 10))], max_source_length=64, corruption_rate=0.8)


def _corpus(tmp_path, n=40, seed=2):
    docs, sums = t_src.synthetic_summarization(n, seed=seed)
    path = tmp_path / "train.jsonl"
    with open(path, "w") as f:
        for d, s in zip(docs, sums):
            f.write(json.dumps({"source": d, "target": s}) + "\n")
    return str(path), docs, sums


@pytest.mark.parametrize("seed", [0, 4])
def test_streaming_seq2seq_columns_equal_jax(tmp_path, seed):
    """A batch window of the streaming tier equals the JAX streaming
    tier's and the port's materialized ``from_seq2seq`` rows exactly."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import streaming as j_stream

    path, docs, sums = _corpus(tmp_path, seed=seed)
    kw = dict(max_target_length=10, decoder_start_token_id=0, pad_token_id=0,
              eos_token_id=1)
    idx = np.random.RandomState(seed).permutation(40)[:8]
    got = t_stream.StreamingTextDataset(t_stream.LineCorpus(path), t_tok.WordHashTokenizer(VOCAB),
                                        task="seq2seq", max_length=48,
                                        seq2seq_kwargs=kw)[idx]
    want = j_stream.StreamingTextDataset(j_stream.LineCorpus(path), _jax_tok(), task="seq2seq",
                                         max_length=48, seq2seq_kwargs=kw)[idx]
    _assert_columns_equal(got, want)
    mat = t_pipe.ArrayDataset.from_seq2seq(t_tok.WordHashTokenizer(VOCAB), docs, sums,
                                           max_source_length=48, **kw)
    _assert_columns_equal(got, mat[idx])


def test_streaming_seq2seq_needs_a_jsonl_corpus(tmp_path):
    """A ``.txt`` corpus carries no source/target fields: the JAX
    package's ``ValueError`` at construction."""
    path = tmp_path / "train.txt"
    path.write_text("one line\nanother line\n")
    with pytest.raises(ValueError, match="jsonl"):
        t_stream.StreamingTextDataset(t_stream.LineCorpus(str(path)),
                                      t_tok.WordHashTokenizer(VOCAB), task="seq2seq")


ROUGE_CASES = [
    (["the cat sat on the mat"], ["the cat is on the mat"]),
    (["Paris, France!", "", "a b c"], ["paris france", "nothing here", ""]),
    (["alpha beta gamma delta"] * 3, ["gamma alpha delta", "beta", "ALPHA-BETA gamma"]),
    (["<12> <7> <99>", "x1 y2 z3 x1"], ["<7> <99> <12>", "x1 z3"]),
]


@pytest.mark.parametrize("preds,refs", ROUGE_CASES, ids=["one", "punct-empty", "order",
                                                        "ids"])
def test_rouge_l_equals_jax(preds, refs):
    from huggingface_sagemaker_tensorflow_distributed_tpu.utils.metrics import rouge_l

    assert t_metrics.rouge_l(preds, refs) == rouge_l(preds, refs)


def test_rouge_l_of_identical_and_disjoint_texts():
    assert t_metrics.rouge_l(["a b c"], ["A, b. c!"]) == {
        "rougeL_precision": 1.0, "rougeL_recall": 1.0, "rougeL_f1": 1.0}
    assert t_metrics.rouge_l(["a b"], ["c d"])["rougeL_f1"] == 0.0
    with pytest.raises(ValueError, match="align"):
        t_metrics.rouge_l(["a"], [])
