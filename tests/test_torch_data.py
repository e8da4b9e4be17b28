"""PyTorch port: the data layer (``data/sources.py``,
``data/tokenization.py``, ``data/pipeline.py``) against the JAX package:
the same corpora (jsonl, ``load_from_disk``, ``load_dataset`` by name),
the same tokenizer choice and token ids for every kind of tokenizer
directory, the same epoch permutation, and the same batches batch for
batch (train, eval with ``valid`` tails, a rank's slice of each global
batch, and length-bucketed batches); then the trainer on that data: a
5-step fp32 tiny-BERT fit with bucketing, WordPiece and the autotuned
prefetch within 1e-5 of the JAX ``Trainer`` (fp32 sums in other orders),
and a resumed fit equal to an uninterrupted one bit for bit."""

import collections
import json

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import pipeline as t_pipe
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import sources as t_src
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import tokenization as t_tok

SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread per test worker runs
    them faster than a pool contending with the other workers."""
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


# -- data ----------------------------------------------------------------------

def test_sources_and_tokenization_match_jax():
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import (
        ArrayDataset,
        WordHashTokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.sources import (
        load_text_classification,
    )

    for split in ("train", "test"):
        assert (t_src.load_text_classification("vendored_reviews", split)
                == load_text_classification("vendored_reviews", split))
    train = t_src.load_text_classification("vendored_reviews", "train")
    assert len(train[0]) == 4000 and len(t_src.load_text_classification(
        "vendored_reviews", "test")[0]) == 1000
    assert (t_src.load_text_classification("synthetic", "test", max_samples=50, seed=3)
            == load_text_classification("synthetic", "test", max_samples=50, seed=3))
    texts, labels = train[0][:40], train[1][:40]
    got = t_pipe.ArrayDataset.from_texts(t_tok.WordHashTokenizer(512), texts, labels, SEQ)
    want = ArrayDataset.from_texts(WordHashTokenizer(512), texts, labels, SEQ)
    assert sorted(got.columns) == sorted(want.columns)
    for key in want.columns:
        np.testing.assert_array_equal(got.columns[key], want.columns[key], err_msg=key)
    pair_got = t_tok.WordHashTokenizer(512)(texts[:3], max_length=SEQ, text_pairs=texts[3:6])
    pair_want = WordHashTokenizer(512)(texts[:3], max_length=SEQ, text_pairs=texts[3:6])
    for key in pair_want:
        np.testing.assert_array_equal(pair_got[key], pair_want[key])


def test_tokenizer_save_load_and_unported_kinds(tmp_path):
    """A saved word-hash tokenizer loads back with its ids; the kinds that
    raised before they were ported now load: a ``vocab.txt`` directory as
    the WordPiece, a hub name that is no directory as the word-hash
    tokenizer, and a dataset name through ``datasets.load_dataset``
    (stubbed here: no download)."""
    tok = t_tok.WordHashTokenizer(vocab_size=300)
    tok.save_pretrained(str(tmp_path))
    again = t_tok.load_tokenizer(str(tmp_path))
    assert again.vocab_size == 300 and again("a b c")["input_ids"].tolist() == \
        tok("a b c")["input_ids"].tolist()
    (tmp_path / "wp").mkdir()
    (tmp_path / "wp" / "vocab.txt").write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\na\n")
    wp = t_tok.load_tokenizer(str(tmp_path / "wp"), prefer_native=False)
    assert type(wp).__name__ == "WordPieceTokenizer"
    assert wp("a b", max_length=6)["input_ids"].tolist() == [[2, 4, 1, 3, 0, 0]]
    assert isinstance(t_tok.load_tokenizer("bert-base-uncased"), t_tok.WordHashTokenizer)
    with pytest.raises(ValueError, match="unknown dataset"):
        t_src.load_text_classification("bogus", "train")


def _vocab_tokens(texts, n_words: int = 300) -> list:
    """A ``vocab.txt`` built from ``texts``: BERT's specials, the most
    frequent lowercased words, then every character alone and as a
    continuation (real WordPiece splits on a small vocab)."""
    import collections

    counts = collections.Counter(w for t in texts for w in t.lower().split())
    words = [w for w, _ in counts.most_common(n_words)]
    chars = sorted({c for t in texts for c in t.lower() if not c.isspace()})
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words + chars + \
        ["##" + c for c in chars]
    return list(dict.fromkeys(tokens))


def _hf_fast_dir(path, tokens):
    """A ``tokenizer.json`` directory built with ``tokenizers`` (no
    download): BERT's WordPiece, pre-tokenizer and template."""
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast

    vocab = {t: i for i, t in enumerate(tokens)}
    tok = Tokenizer(models.WordPiece(vocab, unk_token="[UNK]"))
    tok.normalizer = normalizers.BertNormalizer(lowercase=True)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
        special_tokens=[("[CLS]", vocab["[CLS]"]), ("[SEP]", vocab["[SEP]"])])
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]", pad_token="[PAD]",
                                   cls_token="[CLS]", sep_token="[SEP]", mask_token="[MASK]",
                                   model_max_length=64)
    fast.save_pretrained(str(path))


TOKENIZER_DIRS = ["word_hash", "vocab", "vocab_python", "vocab_unsupported_config",
                  "tokenizer_json", "non_bert_specials", "no_files"]


@pytest.mark.parametrize("kind", TOKENIZER_DIRS)
def test_load_tokenizer_routing_matches_jax(tmp_path, kind):
    """Each kind of directory gives the JAX package's tokenizer class (the
    port's of the same name) and the same ids."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.tokenization import (
        WordHashTokenizer,
        load_tokenizer,
    )

    texts = t_src.load_text_classification("vendored_reviews", "train", max_samples=40)[0]
    tokens = _vocab_tokens(texts)
    d = tmp_path / kind
    d.mkdir()
    if kind == "word_hash":
        WordHashTokenizer(700).save_pretrained(str(d))
    elif kind in ("vocab", "vocab_python"):
        (d / "vocab.txt").write_text("\n".join(tokens) + "\n")
    elif kind == "vocab_unsupported_config":
        (d / "vocab.txt").write_text("\n".join(tokens) + "\n")
        (d / "tokenizer_config.json").write_text(json.dumps(
            {"tokenizer_class": "BertTokenizer", "do_lower_case": True,
             "strip_accents": False}))
    elif kind == "tokenizer_json":
        _hf_fast_dir(d, tokens)
    elif kind == "non_bert_specials":
        (d / "vocab.txt").write_text("\n".join(["<pad>", "<unk>", "<s>", "</s>"] + tokens[5:]))
        (d / "tokenizer_config.json").write_text(json.dumps(
            {"tokenizer_class": "BertTokenizer", "unk_token": "<unk>", "pad_token": "<pad>",
             "cls_token": "<s>", "sep_token": "</s>"}))
    native = kind != "vocab_python"
    got = t_tok.load_tokenizer(str(d), vocab_size=600, prefer_native=native)
    want = load_tokenizer(str(d), vocab_size=600)
    expected = {"word_hash": "WordHashTokenizer", "vocab": "CppWordPieceTokenizer",
                "vocab_python": "WordPieceTokenizer", "no_files": "WordHashTokenizer"}
    assert type(got).__name__ == expected.get(kind, "HFTokenizer")
    if kind != "vocab_python":
        assert type(got).__name__ == type(want).__name__
    assert got.vocab_size == want.vocab_size
    enc_g, enc_w = got(texts, max_length=48), want(texts, max_length=48)
    pair_g = got(texts[:8], max_length=48, text_pairs=texts[8:16])
    pair_w = want(texts[:8], max_length=48, text_pairs=texts[8:16])
    for g, w in ((enc_g, enc_w), (pair_g, pair_w)):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert got.decode(enc_w["input_ids"][0]) == want.decode(enc_w["input_ids"][0])
    if kind != "no_files":
        # the export this directory's tokenizer writes loads back the same
        got.save_pretrained(str(tmp_path / "export"))
        back = load_tokenizer(str(tmp_path / "export"), vocab_size=600)
        np.testing.assert_array_equal(back(texts, max_length=48)["input_ids"],
                                      enc_w["input_ids"])


def _disk_dataset(path, column: str):
    from datasets import Dataset, DatasetDict

    rng = np.random.RandomState(2)
    splits = {}
    for split, n in (("train", 30), ("test", 12)):
        words = t_src._NOISE_WORDS
        texts = [" ".join(words[i] for i in rng.randint(0, len(words), size=rng.randint(3, 20)))
                 for _ in range(n)]
        splits[split] = Dataset.from_dict({column: texts,
                                           "label": rng.randint(0, 2, size=n).tolist()})
    DatasetDict(splits).save_to_disk(str(path))
    return splits


@pytest.mark.parametrize("column", ["text", "sentence"])
def test_load_from_disk_matches_jax(tmp_path, column):
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.sources import (
        load_text_classification,
    )

    splits = _disk_dataset(tmp_path / "ds", column)
    for split in ("train", "test"):
        for max_samples in (None, 5):
            got = t_src.load_text_classification("local", split, str(tmp_path / "ds"),
                                                 max_samples=max_samples)
            want = load_text_classification("local", split, str(tmp_path / "ds"),
                                            max_samples=max_samples)
            assert got == want
            assert got[0] == splits[split][column][:max_samples]


@pytest.mark.parametrize("name,args,column", [("imdb", ("imdb",), "text"),
                                               ("sst2", ("glue", "sst2"), "sentence")])
def test_load_dataset_by_name_matches_jax(monkeypatch, name, args, column):
    """The hub branch, with ``datasets.load_dataset`` replaced by a stub
    that records its arguments (nothing is downloaded)."""
    import datasets

    from huggingface_sagemaker_tensorflow_distributed_tpu.data.sources import (
        load_text_classification,
    )

    calls = []

    def stub(*a, split):
        calls.append((a, split))
        return datasets.Dataset.from_dict({column: [f"{split} {i}" for i in range(6)],
                                           "label": [i % 2 for i in range(6)]})

    monkeypatch.setattr(datasets, "load_dataset", stub)
    got = t_src.load_text_classification(name, "test", max_samples=4)
    assert got == load_text_classification(name, "test", max_samples=4)
    assert got == (["test 0", "test 1", "test 2", "test 3"], [0, 1, 0, 1])
    assert calls == [(args, "test")] * 2


BATCH_CASES = [  # shuffle, drop_remainder, gbs, rank, ranks
    (True, True, 8, 0, 1), (False, False, 8, 0, 1), (True, True, 8, 1, 2),
    (False, False, 6, 1, 2)]


@pytest.mark.parametrize("case", BATCH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_batches_match_jax(case):
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import (
        ArrayDataset,
        ShardedBatcher,
        WordHashTokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )

    shuffle, drop, gbs, rank, ranks = case
    texts, labels = t_src.synthetic_text_classification(37)
    port = t_pipe.ShardedBatcher(
        t_pipe.ArrayDataset.from_texts(t_tok.WordHashTokenizer(512), texts, labels, SEQ),
        gbs, shuffle=shuffle, seed=5, drop_remainder=drop, process_index=rank,
        process_count=ranks)
    ref = ShardedBatcher(ArrayDataset.from_texts(WordHashTokenizer(512), texts, labels, SEQ),
                         gbs, build_mesh(MeshConfig()), shuffle=shuffle, seed=5,
                         drop_remainder=drop, process_index=rank, process_count=ranks)
    assert port.steps_per_epoch() == ref.steps_per_epoch()
    for epoch in (0, 1):
        got, want = list(port.local_batches(epoch)), list(ref.local_batches(epoch))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    if not drop:
        assert got[-1]["valid"].sum() < len(got[-1]["valid"]) or ranks > 1
    tensors = next(iter(port.global_arrays(0)))
    assert tensors["input_ids"].dtype == torch.int64 and tensors["valid"].dtype == torch.int32


def test_epoch_permutation_matches_jax_native():
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.native import (
        native_permutation,
    )

    for n, seed in ((1, 0), (37, 5), (1000, 43)):
        np.testing.assert_array_equal(t_pipe.epoch_permutation(n, seed),
                                      native_permutation(n, seed))


# -- length bucketing ------------------------------------------------------------

def _ragged_columns(n, width=64, seed=0):
    """Token columns with seeded ragged lengths (4..width, most short)."""
    rng = np.random.RandomState(seed)
    ids = np.zeros((n, width), np.int32)
    mask = np.zeros((n, width), np.int32)
    lengths = np.minimum(width, 4 + rng.exponential(10, size=n).astype(int))
    for i, length in enumerate(lengths):
        ids[i, :length] = rng.randint(5, 100, size=length)
        mask[i, :length] = 1
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": (ids % 2).astype(np.int32),
            "labels": rng.randint(0, 2, size=n).astype(np.int32)}


BUCKET_CASES = [  # shuffle, drop_remainder, gbs, rank, ranks, start_step, window
    (True, True, 8, 0, 1, 0, 16), (True, True, 8, 1, 2, 0, 1), (True, True, 8, 0, 2, 3, 16),
    (False, False, 6, 1, 2, 0, 16), (False, False, 8, 0, 1, 2, 1), (True, False, 8, 0, 1, 0, 1)]


@pytest.mark.parametrize("case", BUCKET_CASES, ids=lambda c: "-".join(map(str, c)))
def test_bucketed_batches_match_jax(case):
    """Bucketed batches equal JAX ``ShardedBatcher(bucket_sizes=...)``'s
    batch for batch, widths, values and ``valid`` included, over two
    epochs (an eval tail's width from its real rows only)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import (
        ArrayDataset,
        ShardedBatcher,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )

    shuffle, drop, gbs, rank, ranks, start, window = case
    cols = _ragged_columns(77, seed=sum(case))
    buckets = [16, 32, 48, 64]
    port = t_pipe.ShardedBatcher(t_pipe.ArrayDataset(dict(cols)), gbs, shuffle=shuffle,
                                 seed=5, drop_remainder=drop, process_index=rank,
                                 process_count=ranks, bucket_sizes=buckets,
                                 bucket_window=window)
    ref = ShardedBatcher(ArrayDataset(dict(cols)), gbs, build_mesh(MeshConfig()),
                         shuffle=shuffle, seed=5, drop_remainder=drop, process_index=rank,
                         process_count=ranks, bucket_sizes=buckets, bucket_window=window)
    widths = set()
    for epoch in (0, 1):
        got, want = list(port.local_batches(epoch, start)), list(ref.local_batches(epoch, start))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for key in w:
                assert g[key].shape == w[key].shape, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            widths.add(g["input_ids"].shape[1])
        tensors = list(port.global_arrays(epoch, start))
        assert [t["input_ids"].shape for t in tensors] == [g["input_ids"].shape for g in got]
    assert len(widths) > 1 and widths <= set(buckets)
    py = t_pipe.ShardedBatcher(t_pipe.ArrayDataset(dict(cols)), gbs, shuffle=shuffle, seed=5,
                               drop_remainder=drop, process_index=rank, process_count=ranks,
                               bucket_sizes=buckets, bucket_window=window, native=False)
    for g, w in zip(py.local_batches(1, start), ref.local_batches(1, start)):
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


# -- the compile-budget cap of the bucket ladder ------------------------------------

CAP_BUCKETS = [16, 32, 48, 64]


@pytest.fixture
def _fresh_obs():
    """Both packages' telemetry states fresh (no sink, no tracker, the
    agreed latch clear) before and after."""
    from huggingface_sagemaker_tensorflow_distributed_tpu import obs as jax_obs
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs

    obs.reset()
    jax_obs.reset()
    yield obs, jax_obs
    obs.reset()
    jax_obs.reset()


def _jax_batcher(cols, gbs, **kw):
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import (
        ArrayDataset,
        ShardedBatcher,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )

    return ShardedBatcher(ArrayDataset(dict(cols)), gbs, build_mesh(MeshConfig()),
                          bucket_sizes=CAP_BUCKETS, **kw)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("cross_after", [0, 2, 5])
def test_capped_ladder_widths_match_jax(_fresh_obs, monkeypatch, cross_after, shuffle):
    """The same dataset and buckets under a compile tracker that crosses
    its budget after batch ``cross_after``: the port's batches equal the
    JAX ``ShardedBatcher``'s batch for batch over two epochs, widths
    included (the JAX tracker made visible through its installed list,
    its listener never registered)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.obs import watchdog as j_watchdog

    obs, jax_obs = _fresh_obs
    cols = _ragged_columns(80, seed=11)
    kw = dict(shuffle=shuffle, seed=4, process_index=0, process_count=1, bucket_window=2)
    port = t_pipe.ShardedBatcher(t_pipe.ArrayDataset(dict(cols)), 8, bucket_sizes=CAP_BUCKETS,
                                 **kw)
    ref = _jax_batcher(cols, 8, **kw)
    j_tracker = j_watchdog.CompileTracker(jax_obs.state(), budget_s=0.5)
    monkeypatch.setattr(j_watchdog, "_INSTALLED", [j_tracker])
    tracker = obs.compile_tracker()
    tracker.budget_s = 0.5
    step, widths = 0, []
    for epoch in (0, 1):
        for g, w in zip(port.local_batches(epoch), ref.local_batches(epoch), strict=True):
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            widths.append(g["input_ids"].shape[1])
            if step == cross_after:
                for t in (tracker, j_tracker):
                    t.observe("/hstd/compile/load/flash_attention", 1.0)
                assert obs.compile_budget_exceeded() and jax_obs.compile_budget_exceeded()
            step += 1
    after = widths[cross_after + 1:]
    before = set(widths[:cross_after + 1])
    assert all(w in before or w == 64 for w in after)
    # where the uncapped ladder would have minted a width, the cap moved it
    obs.reset()
    free = t_pipe.ShardedBatcher(t_pipe.ArrayDataset(dict(cols)), 8, bucket_sizes=CAP_BUCKETS,
                                 **kw)
    nominal = [b["input_ids"].shape[1] for epoch in (0, 1) for b in free.local_batches(epoch)]
    assert nominal[:cross_after + 1] == widths[:cross_after + 1]
    if any(w not in before for w in nominal[cross_after + 1:]):
        assert widths != nominal


def test_multi_process_ladder_caps_only_on_the_agreed_latch(_fresh_obs):
    """With several processes the local crossing does not cap (the ranks
    would cut different widths); the agreed latch does, from the next
    batch, as in the JAX batcher under the same latches; ``obs.reset``
    clears it."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel.distributed import (
        agree_compile_budget_crossed as jax_agree,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.distributed import (
        agree_compile_budget_crossed,
    )

    obs, jax_obs = _fresh_obs
    n, width = 16, 64
    ids = np.zeros((n, width), np.int32)
    mask = np.zeros((n, width), np.int32)
    for i in range(n):
        length = 10 if i < 8 else 40
        ids[i, :length] = 7
        mask[i, :length] = 1
    cols = {"input_ids": ids, "attention_mask": mask, "labels": np.zeros(n, np.int32)}

    def widths(pkg):
        kw = dict(shuffle=False, process_index=0, process_count=2)
        b = (t_pipe.ShardedBatcher(t_pipe.ArrayDataset(dict(cols)), 8,
                                   bucket_sizes=CAP_BUCKETS, **kw)
             if pkg == "port" else _jax_batcher(cols, 8, **kw))
        return [batch["input_ids"].shape[1] for batch in b.local_batches(0)]

    tracker = obs.compile_tracker()
    tracker.budget_s = 0.1
    tracker.observe("/hstd/compile/nvcc/flash_attention", 1.0)
    assert obs.compile_budget_exceeded() and not obs.compile_budget_capped(2)
    assert obs.compile_budget_capped(1)
    assert widths("port") == widths("jax") == [16, 48]
    assert agree_compile_budget_crossed(obs.compile_budget_exceeded()) is True
    assert agree_compile_budget_crossed(False) is jax_agree(False) is False
    obs.set_compile_budget_agreed()
    jax_obs.set_compile_budget_agreed()
    assert obs.compile_budget_agreed() and obs.compile_budget_capped(2)
    assert widths("port") == widths("jax") == [64, 64]
    obs.reset()
    assert not obs.compile_budget_agreed() and not obs.compile_budget_capped(2)


def test_compile_budget_with_bucketing_builds(monkeypatch, _fresh_obs):
    """``HSTD_COMPILE_BUDGET_S`` with bucketing builds a batcher (the raise
    it once met is gone), and an installed tracker reads the budget."""
    obs, _ = _fresh_obs
    monkeypatch.setenv("HSTD_COMPILE_BUDGET_S", "30")
    b = t_pipe.ShardedBatcher(t_pipe.ArrayDataset(_ragged_columns(16)), 8,
                              bucket_sizes=[32, 64])
    assert b.bucket_sizes == [32, 64] and len(list(b.local_batches(0))) == 2
    assert obs.compile_tracker().budget_s == 30.0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ladder_batcher(rank, world):
    # data whose later epochs cut a width (48) its first epoch never did
    return t_pipe.ShardedBatcher(t_pipe.ArrayDataset(_ragged_columns(48, seed=15)), 8, seed=0,
                                 bucket_sizes=CAP_BUCKETS, bucket_window=1, process_index=rank,
                                 process_count=world)


def _ladder_worker(rank, world, port, out_path):
    """One rank of a 3-epoch fit with bucketing under
    ``HSTD_COMPILE_BUDGET_S=1``: rank 1's tracker has crossed before the
    fit, rank 0's has not. Saves each train batch's width and whether the
    agreed latch was set when it was cut."""
    import os

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                      RANK=str(rank), HSTD_COMPILE_BUDGET_S="1")
    torch.set_num_threads(1)
    import torch.distributed as dist

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch import config as t_config
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import layers as t_layers
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import init_bert
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer

    initialize_distributed("cpu")
    try:
        if rank == 1:
            obs.compile_tracker().observe("/hstd/compile/nvcc/flash_attention", 5.0)
        seen = []
        real = t_pipe.ShardedBatcher._trim_to_buckets

        def trim(self, batch, real_idx):
            out = real(self, batch, real_idx)
            seen.append((int(out["input_ids"].shape[1]), obs.compile_budget_agreed()))
            return out

        t_pipe.ShardedBatcher._trim_to_buckets = trim
        cfg = t_config.TrainConfig(epochs=3, learning_rate=1e-3, scale_lr_by_world_size=False,
                                   max_seq_length=64, log_every_steps=0)
        trainer = Trainer(cfg, init_bert(t_layers.EncoderConfig(**FIT_TINY), seed=0,
                                         device="cpu"))
        trainer.fit(_ladder_batcher(rank, world))
        torch.save({"seen": seen, "exceeded": obs.compile_budget_exceeded()}, out_path)
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_latch_the_crossing_at_one_epoch_boundary(tmp_path):
    """Rank 1 crosses the budget before the fit, rank 0 never does: neither
    caps in epoch 0 (rank 1 alone would cut other widths than rank 0), both
    latch the agreed crossing at the first epoch boundary, and from then on
    both cut the same capped widths at every step."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_ladder_worker, args=(r, 2, port, str(tmp_path / f"{r}.pt")))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs)
    r0, r1 = (torch.load(str(tmp_path / f"{r}.pt")) for r in range(2))
    assert r1["exceeded"] and not r0["exceeded"]
    assert r0["seen"] == r1["seen"]
    b = _ladder_batcher(0, 2)
    steps = b.steps_per_epoch()
    flags = [agreed for _, agreed in r0["seen"]]
    assert flags == [False] * steps + [True] * 2 * steps
    # epoch 0 uncapped on both ranks, then the cap on the widths cut so far
    nominal = [x["input_ids"].shape[1] for epoch in range(3) for x in b.local_batches(epoch)]
    expected, used = nominal[:steps], set(nominal[:steps])
    for w in nominal[steps:]:
        if w not in used:
            w = min((u for u in used if u >= w), default=64)
        used.add(w)
        expected.append(w)
    assert [w for w, _ in r0["seen"]] == expected != nominal


# -- training on the new data path -------------------------------------------------

FIT_TINY = dict(vocab_size=512, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64, max_position_embeddings=128,
                hidden_dropout=0.0, attention_dropout=0.0)
FIT_SEQ = 128
FIT_BUCKETS = [32, 64, 96, 128]
FIT_KW = dict(epochs=1, steps_per_epoch=5, dtype="float32", learning_rate=1e-3,
              scale_lr_by_world_size=False, weight_decay=0.01, max_grad_norm=1.0,
              warmup_ratio=0.4, lr_schedule="cosine", log_every_steps=0)


@pytest.fixture
def _jax_telemetry_off():
    """The JAX trainer runs with its telemetry off: it then installs no
    compile tracker."""
    from huggingface_sagemaker_tensorflow_distributed_tpu import obs as jax_obs

    jax_obs.reset(enabled=False)
    yield
    jax_obs.reset()


def _reviews_wordpiece(n=96):
    """Vendored reviews and a WordPiece vocab of at most 512 tokens built
    from them."""
    texts, labels = t_src.load_text_classification("vendored_reviews", "train",
                                                   max_samples=n)
    tokens = _vocab_tokens(texts, n_words=300)
    assert len(tokens) <= FIT_TINY["vocab_size"]
    return texts, labels, {t: i for i, t in enumerate(tokens)}


def _tiny_pair(cfg: dict, seed: int = 0):
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.auto import init_params
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.bert import (
        BertForSequenceClassification as JaxBert,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.layers import (
        EncoderConfig as JaxConfig,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import layers as t_layers
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.bert import (
        BertForSequenceClassification,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
        params_from_jax,
    )

    jmodel = JaxBert(JaxConfig(dtype=jnp.float32, **cfg), num_labels=2)
    params = init_params(jmodel, seed=seed)
    model = BertForSequenceClassification(t_layers.EncoderConfig(**cfg), num_labels=2)
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    model.load_state_dict(params_from_jax(flat), strict=True)
    return jmodel, params, model


def test_bucketed_wordpiece_prefetched_fit_matches_jax_trainer(_jax_telemetry_off):
    """5 fp32 steps of ``fit`` over bucketed WordPiece batches with the
    autotuned prefetch and the stager, against the JAX ``Trainer.fit`` over
    its own bucketed batcher: the same widths, losses within 1e-5."""
    import jax

    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import (
        ArrayDataset,
        ShardedBatcher,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.wordpiece import (
        WordPieceTokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.train import Trainer as JaxTrainer
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch import config as t_config
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.native import (
        CppWordPieceTokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer

    texts, labels, vocab = _reviews_wordpiece()
    jmodel, params, model = _tiny_pair(FIT_TINY)
    port_ds = t_pipe.ArrayDataset.from_texts(CppWordPieceTokenizer(vocab), texts, labels,
                                             FIT_SEQ)
    jax_ds = ArrayDataset.from_texts(WordPieceTokenizer(vocab), texts, labels, FIT_SEQ)
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jtrainer = JaxTrainer(TrainConfig(**FIT_KW), jmodel, params, mesh, total_steps=5)
    trainer = Trainer(t_config.TrainConfig(**FIT_KW), model, total_steps=5)
    want, got, widths = [], [], []
    step = jtrainer._train_step

    def jax_step(state, batch):
        state, m = step(state, batch)
        want.append(float(jax.device_get(m["loss"])))
        return state, m

    jtrainer._train_step = jax_step
    port_step = trainer.train_step

    def recorded(batch):
        widths.append(batch["input_ids"].shape[1])
        out = port_step(batch)
        got.append(out["loss"].item())
        return out

    trainer.train_step = recorded
    jtrainer.fit(ShardedBatcher(jax_ds, 8, mesh, seed=1, bucket_sizes=FIT_BUCKETS))
    trainer.fit(t_pipe.ShardedBatcher(port_ds, 8, seed=1, bucket_sizes=FIT_BUCKETS))
    assert len(got) == len(want) == 5 and len(set(widths)) > 1
    assert set(widths) <= set(FIT_BUCKETS) and min(widths) < FIT_SEQ
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the first step and each new width's first step are left out of the meter
    assert trainer.meter.excluded_steps == len(set(widths))


def test_bucketed_prefetched_resume_equals_the_uninterrupted_fit(tmp_path):
    """Two epochs of bucketed WordPiece batches through the autotuned
    prefetch, dropout on: stopped after step 4 (last save at 3), restored
    and finished, the losses and weights equal the uninterrupted fit's bit
    for bit; tokens are popped once per dispatched step."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch import config as t_config
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.native import (
        CppWordPieceTokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import layers as t_layers
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.bert import (
        BertForSequenceClassification,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.checkpoint import (
        Checkpointer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer

    class Stop(Exception):
        pass

    texts, labels, vocab = _reviews_wordpiece(48)
    ds = t_pipe.ArrayDataset.from_texts(CppWordPieceTokenizer(vocab), texts, labels, FIT_SEQ)
    tiny = dict(FIT_TINY, hidden_dropout=0.1, attention_dropout=0.1)
    torch.manual_seed(3)
    initial = BertForSequenceClassification(t_layers.EncoderConfig(**tiny),
                                            num_labels=2).state_dict()
    cfg = t_config.TrainConfig(**dict(FIT_KW, epochs=2, steps_per_epoch=None,
                                      checkpoint_every_steps=3))

    def fit(ckpt_dir, stop_after=None, restore=False):
        model = BertForSequenceClassification(t_layers.EncoderConfig(**tiny), num_labels=2)
        model.load_state_dict(initial)
        torch.manual_seed(7)
        trainer = Trainer(cfg, model, total_steps=12)
        losses, tokens = [], []
        step = trainer.train_step

        def run(batch):
            if stop_after is not None and len(losses) == stop_after:
                raise Stop
            out = step(batch)
            losses.append(out["loss"].item())
            tokens.append(int(batch["attention_mask"].sum()))
            return out

        trainer.train_step = run
        ckpt = Checkpointer(str(ckpt_dir))
        kw = {}
        if restore:
            state, epoch, step_in_epoch = ckpt.restore()
            trainer.load_state_dict(state)
            kw = dict(start_epoch=epoch, start_step_in_epoch=step_in_epoch)
        batcher = t_pipe.ShardedBatcher(ds, 8, seed=2, bucket_sizes=FIT_BUCKETS)
        batcher._count_tokens = True
        popped = []

        class Log(collections.deque):
            def popleft(self):
                popped.append(super().popleft())
                return popped[-1]

        batcher.token_log = Log(maxlen=8192)
        try:
            trainer.fit(batcher, checkpointer=ckpt, **kw)
        finally:
            ckpt.close()
        return losses, trainer.model.state_dict(), tokens, popped

    full, weights, tokens, popped = fit(tmp_path / "full")
    assert len(full) == 12 and [t for t, _ in popped] == tokens
    with pytest.raises(Stop):
        fit(tmp_path / "cut", stop_after=4)
    resumed, resumed_weights, _, _ = fit(tmp_path / "cut", restore=True)
    assert resumed == full[3:]
    for key in weights:
        assert torch.equal(resumed_weights[key], weights[key]), key


@pytest.mark.parametrize("kind", ["vocab", "tokenizer_json"])
def test_cli_trains_from_a_tokenizer_dir_and_a_saved_dataset(tmp_path, kind):
    """The CLI on the CPU from a model directory holding a ``vocab.txt``
    (the C++ WordPiece) or a ``tokenizer.json`` (HF), over a
    ``datasets.save_to_disk`` directory, with length buckets: it trains,
    and the tokenizer it exports loads back through the JAX
    ``load_tokenizer`` to the same ids."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.tokenization import (
        load_tokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli

    splits = _disk_dataset(tmp_path / "ds", "text")
    tokens = _vocab_tokens(splits["train"]["text"], n_words=20)
    model_dir = tmp_path / "cfg"
    model_dir.mkdir()
    if kind == "vocab":
        (model_dir / "vocab.txt").write_text("\n".join(tokens) + "\n")
    else:
        _hf_fast_dir(model_dir, tokens)
    (model_dir / "config.json").write_text(json.dumps({
        "model_type": "bert", "vocab_size": len(tokens), "hidden_size": 32,
        "num_hidden_layers": 1, "num_attention_heads": 2, "intermediate_size": 64,
        "max_position_embeddings": 64}))
    res = cli.main(["--model_name_or_path", str(model_dir), "--from_scratch", "true",
                    "--dataset", "local", "--dataset_path", str(tmp_path / "ds"),
                    "--bucket_multiple", "16", "--epochs", "1", "--train_batch_size", "4",
                    "--dtype", "float32", "--max_seq_length", "64", "--device", "cpu",
                    "--output_data_dir", str(tmp_path / "out"),
                    "--model_dir", str(tmp_path / "model")])
    assert len(res["train"]["loss"]) == 1 and np.isfinite(res["eval"]["eval_loss"])
    texts = list(splits["test"]["text"])
    port = t_tok.load_tokenizer(str(model_dir))
    assert type(port).__name__ == ("CppWordPieceTokenizer" if kind == "vocab" else
                                   "HFTokenizer")
    back = load_tokenizer(str(tmp_path / "model"))
    np.testing.assert_array_equal(back(texts, max_length=64)["input_ids"],
                                  port(texts, max_length=64)["input_ids"])
