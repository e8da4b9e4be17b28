"""PyTorch port: the streaming tier (``data/streaming.py``: ``LineCorpus``
and ``StreamingTextDataset`` for ``seq-cls`` and ``causal-lm``) against
the JAX package's on the same seeded corpora: the same line index (C++
and Python), the same rows read back through the coalescing reader, whose
gap moves as the JAX one does, and the same columns for the same indices
with the word-hash and the WordPiece tokenizers; a batcher over the
stream yields the materialized dataset's batches, and the CLI with
``--streaming true`` trains to the materialized run's weights bit for
bit."""

import json
import shutil

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import pipeline as t_pipe
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import sources as t_src
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import streaming as t_stream
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import tokenization as t_tok
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import wordpiece as t_wp

SEQ = 32
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ on PATH: the host library cannot be built")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _detached_compile_trackers():
    """A compile tracker that an earlier telemetry test installed in this
    worker rejects the ``fun_name`` keyword jax 0.9 passes to duration
    listeners, failing every later jax compile in the worker. Remove every
    installed tracker before and after this module, leaving the worker as a
    fresh one would be (a later telemetry test installs its own)."""
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


def _write_jsonl(path, texts, labels=None):
    with open(path, "w") as f:
        for i, t in enumerate(texts):
            rec = {"text": t}
            if labels is not None:
                rec["label"] = int(labels[i])
            f.write(json.dumps(rec) + "\n")
    return str(path)


def _vocab(texts) -> dict:
    """BERT's specials, the corpus's words, then every character alone and
    as a continuation: real WordPiece splits on a small vocab."""
    words = sorted({w for t in texts for w in t.lower().split()})[:60]
    chars = sorted({c for t in texts for c in t.lower() if not c.isspace()})
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words + chars + \
        ["##" + c for c in chars]
    return {t: i for i, t in enumerate(dict.fromkeys(tokens))}


@pytest.fixture()
def corpus(tmp_path):
    texts, labels = t_src.synthetic_text_classification(64, seed=0)
    texts[5] = "naïve café — über " + texts[5]
    return _write_jsonl(tmp_path / "train.jsonl", texts, labels), texts, labels


@needs_gxx
@pytest.mark.parametrize("native", [True, False], ids=["cpp", "python"])
def test_line_corpus_matches_jax(tmp_path, corpus, native):
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.streaming import LineCorpus

    path, texts, labels = corpus
    txt = tmp_path / "lines.txt"
    txt.write_text("first\r\nsecond line\n\nfourth\n\n")
    for p, kw in ((path, {}), (path, {"max_rows": 10}), (str(txt), {})):
        got, want = t_stream.LineCorpus(p, native=native, **kw), LineCorpus(p, **kw)
        np.testing.assert_array_equal(got._offsets, want._offsets)
        idx = np.random.RandomState(len(want)).randint(0, len(want), size=12)
        assert got.read_rows(idx) == want.read_rows(idx)
    assert len(t_stream.LineCorpus(str(txt), native=native)) == 4
    got = t_stream.LineCorpus(path, native=native)
    assert got.read_rows(np.arange(64))[0] == texts
    assert got.read_records(np.array([3]))[0] == {"text": texts[3], "label": labels[3]}
    with pytest.raises(ValueError, match="jsonl"):
        t_stream.LineCorpus(str(txt), native=native).read_records(np.array([0]))


@needs_gxx
def test_coalesced_reads_move_the_gap_as_jax_does(tmp_path):
    """Dense reads grow the gap, sparse ones shrink it, step for step as
    in the JAX reader, and the rows come back exact, duplicates and
    reverse order included; each move is an ``autotune`` event."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.streaming import LineCorpus

    path = tmp_path / "c.txt"
    lines = [f"row {i} " + "x" * (i % 97) for i in range(400)]
    path.write_text("\n".join(lines) + "\n")
    got, want = t_stream.LineCorpus(str(path)), LineCorpus(str(path))
    rng = np.random.RandomState(9)
    reads = [np.arange(64), np.arange(0, 400, 97)] * 3 + [np.asarray([5, 5, 300, 2])] + \
        [rng.randint(0, 400, size=rng.randint(1, 80)) for _ in range(20)]
    obs.reset(out_dir=str(tmp_path / "tel"))
    try:
        gaps = []
        for idx in reads:
            assert got._read_lines(idx) == want._read_lines(idx) == [lines[i] for i in idx]
            assert got._coalesce_gap == want._coalesce_gap
            gaps.append(got._coalesce_gap)
    finally:
        obs.reset()
    assert max(gaps) > 64 * 1024 and min(gaps) < 64 * 1024
    events = [json.loads(x) for x in (tmp_path / "tel" / "events.jsonl").read_text().splitlines()]
    moves = [e for e in events if e["type"] == "autotune"]
    assert moves and {e["name"] for e in moves} == {"data/read_coalesce_gap"}
    assert sum(a != b for a, b in zip([64 * 1024] + gaps, gaps)) == len(moves)


@needs_gxx
@pytest.mark.parametrize("task", ["seq-cls", "causal-lm"])
@pytest.mark.parametrize("tokenizer", ["word_hash", "wordpiece"])
def test_columns_match_jax(corpus, task, tokenizer):
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import (
        ArrayDataset,
        LineCorpus,
        StreamingTextDataset,
        WordHashTokenizer,
        WordPieceTokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.native import (
        CppWordPieceTokenizer,
    )

    path, texts, labels = corpus
    if tokenizer == "word_hash":
        port_tok, jax_tok = t_tok.WordHashTokenizer(512), WordHashTokenizer(512)
    else:
        vocab = _vocab(texts)
        port_tok, jax_tok = CppWordPieceTokenizer(vocab), WordPieceTokenizer(vocab)
    got = t_stream.StreamingTextDataset(t_stream.LineCorpus(path), port_tok, task=task,
                                        max_length=SEQ, num_labels=2)
    want = StreamingTextDataset(LineCorpus(path), jax_tok, task=task, max_length=SEQ,
                                num_labels=2)
    assert len(got) == len(want) == 64 and got.resident_bytes() == 65 * 8
    rng = np.random.RandomState(4)
    for idx in (np.arange(8), rng.randint(0, 64, size=16), np.array([63, 0, 5, 5])):
        g, w = got[idx], want[idx]
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    if task == "seq-cls":
        mat = ArrayDataset.from_texts(jax_tok, texts, labels, SEQ)
        for key, col in got[np.arange(64)].items():
            np.testing.assert_array_equal(col, mat.columns[key], err_msg=key)


@needs_gxx
def test_unported_tasks_and_bad_rows_raise(tmp_path, corpus):
    path, texts, _ = corpus
    corpus_ = t_stream.LineCorpus(path)
    tok = t_tok.WordHashTokenizer(512)
    txt = tmp_path / "lines.txt"
    txt.write_text("\n".join(texts[:4]) + "\n", encoding="utf-8")
    with pytest.raises(ValueError, match="jsonl"):
        t_stream.StreamingTextDataset(t_stream.LineCorpus(str(txt)), tok, task="seq2seq")
    with pytest.raises(ValueError, match="supports"):
        t_stream.StreamingTextDataset(corpus_, tok, task="qa")
    with pytest.raises(ValueError, match="num_labels"):
        t_stream.StreamingTextDataset(corpus_, tok, num_labels=1, max_length=SEQ)[np.arange(4)]
    unlabeled = t_stream.LineCorpus(_write_jsonl(tmp_path / "u.jsonl", texts[:4]))
    with pytest.raises(ValueError, match="labels"):
        t_stream.StreamingTextDataset(unlabeled, tok, max_length=SEQ)[np.arange(4)]
    stream = t_stream.StreamingTextDataset(corpus_, tok, max_length=SEQ)
    with pytest.raises(ValueError, match="streaming"):
        t_pipe.ShardedBatcher(stream, 8, bucket_sizes=[16, 32])


@needs_gxx
@pytest.mark.parametrize("prefetch", ["auto", 0])
def test_batches_equal_the_materialized_batches(corpus, prefetch):
    path, texts, labels = corpus
    tok = t_tok.WordHashTokenizer(512)
    stream = t_stream.StreamingTextDataset(t_stream.LineCorpus(path), tok, max_length=SEQ)
    mat = t_pipe.ArrayDataset.from_texts(tok, texts, labels, SEQ)
    for epoch in (0, 1):
        got = list(t_pipe.ShardedBatcher(stream, 8, seed=3, process_index=1,
                                         process_count=2).global_arrays(epoch, 2, prefetch))
        want = list(t_pipe.ShardedBatcher(mat, 8, seed=3, process_index=1,
                                          process_count=2).global_arrays(epoch, 2, prefetch))
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            for key in w:
                assert torch.equal(g[key], w[key]), key


def _tiny_model_dir(path):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps({
        "model_type": "bert", "vocab_size": 512, "hidden_size": 32,
        "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 64,
        "max_position_embeddings": SEQ, "hidden_dropout_prob": 0.1,
        "attention_probs_dropout_prob": 0.1}))
    return str(path)


@needs_gxx
def test_cli_streaming_run_equals_the_materialized_run(tmp_path):
    """``--streaming true`` reads and tokenizes the train split batch by
    batch on the prefetch thread; the weights after 6 steps (dropout on)
    and the results equal the materialized run's bit for bit."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli

    model_dir = _tiny_model_dir(tmp_path / "cfg")
    common = ["--model_name_or_path", model_dir, "--from_scratch", "true",
              "--dataset", "vendored_reviews", "--dataset_path", str(t_src.VENDORED_REVIEWS),
              "--max_train_samples", "64", "--max_eval_samples", "8", "--epochs", "1",
              "--steps_per_epoch", "6", "--dtype", "float32", "--log_every_steps", "0",
              "--max_seq_length", str(SEQ), "--device", "cpu"]
    runs = {}
    for name, flag in (("stream", "true"), ("mat", "false")):
        res, trainer = cli.run(common + ["--streaming", flag,
                                         "--output_data_dir", str(tmp_path / name / "out"),
                                         "--model_dir", str(tmp_path / name / "model")])
        runs[name] = (res, trainer.model.state_dict(), trainer.step)
    (res_s, w_s, n_s), (res_m, w_m, n_m) = runs["stream"], runs["mat"]
    assert n_s == n_m == 6
    assert res_s["train"]["loss"] == res_m["train"]["loss"]
    assert res_s["eval"] == res_m["eval"]
    for key in w_m:
        assert torch.equal(w_s[key], w_m[key]), key
