"""PyTorch port: the data layer (``data/sources.py``,
``data/tokenization.py``, ``data/pipeline.py``) against the JAX package:
the same corpora, the same token ids, the same epoch permutation, and the
same batches batch for batch (train, eval with ``valid`` tails, and a
rank's slice of each global batch)."""

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
    tok = t_tok.WordHashTokenizer(vocab_size=300)
    tok.save_pretrained(str(tmp_path))
    again = t_tok.load_tokenizer(str(tmp_path))
    assert again.vocab_size == 300 and again("a b c")["input_ids"].tolist() == \
        tok("a b c")["input_ids"].tolist()
    (tmp_path / "wp").mkdir()
    (tmp_path / "wp" / "vocab.txt").write_text("[PAD]\n")
    with pytest.raises(NotImplementedError):
        t_tok.load_tokenizer(str(tmp_path / "wp"))
    assert isinstance(t_tok.load_tokenizer("bert-base-uncased"), t_tok.WordHashTokenizer)
    with pytest.raises(NotImplementedError):
        t_src.load_text_classification("imdb", "train")


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
