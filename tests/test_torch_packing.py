"""PyTorch port: token packing against the JAX package on the same numpy
inputs (``data/pipeline.py``: ``pack_examples``, ``ArrayDataset.pack``,
``MlmDataset.pack``, ``from_lm_texts(packed=True)``,
``ShardedBatcher(pack=True)``; ``ops/attention.py``'s segment mask;
``models/gpt2.py`` and ``models/bert.py`` taking ``segment_ids`` and
``position_ids``; the trainer's losses passing them through; the CLI's
``--segment_packing`` and ``--packed_sequences``; the config's checks).
Mirrors the JAX ``tests/test_packing.py`` test for test.

Tolerances: packed columns, masks and counts exact; loss sums 1e-5
relative (fp32 through two layers, sums in other orders), packed against
unpacked in the port and the port against JAX, fused (the JAX fused loss
with its Pallas kernels in interpret mode, hidden 128) and plain; the
5-step packed GPT-2 loss curve 1e-5 relative of the JAX ``Trainer``'s."""

import functools
import json

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import config as t_config
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import pipeline as t_pipe
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import sources as t_src
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import tokenization as t_tok
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import bert as t_bert
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import gpt2 as t_gpt2
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import layers as t_layers
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
    params_from_jax,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import attention as t_attn
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import trainer as t_trainer
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.results import (
    read_results_file,
)

VOCAB = 300
GPT2 = dict(vocab_size=VOCAB, max_position_embeddings=64, hidden_size=128, num_layers=2,
            num_heads=4, intermediate_size=256, hidden_dropout=0.0, embd_dropout=0.0,
            attention_dropout=0.0, eos_token_id=VOCAB - 1, pad_token_id=0)
BERT = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2, num_heads=4,
            intermediate_size=256, max_position_embeddings=64, hidden_dropout=0.0,
            attention_dropout=0.0, use_pooler=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _detached_compile_trackers():
    """Remove any JAX compile tracker an earlier telemetry test left in
    this worker (it fails every later jax compile; ROADMAP queue 3)."""
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


def _ragged_lm_columns(n=24, width=32, vocab=120, seed=0, tie=False):
    """Causal-LM shaped columns with ragged real lengths (labels = ids, -100
    on padding: ``from_lm_texts(packed=False)``'s); ``tie`` gives every
    other row the same length, so the sort's stability decides."""
    rng = np.random.RandomState(seed)
    ids = np.zeros((n, width), np.int32)
    mask = np.zeros((n, width), np.int32)
    lengths = rng.randint(3, width // 2 + 1, size=n)
    if tie:
        lengths[::2] = width // 4
    for i, L in enumerate(lengths):
        ids[i, :L] = rng.randint(3, vocab, size=L)
        mask[i, :L] = 1
    labels = np.where(mask > 0, ids, -100).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}


PACK_CASES = {
    "causal": dict(cols=dict(), width=32, causal=True),
    "mlm": dict(cols=dict(seed=2), width=48, causal=False),
    "ties": dict(cols=dict(seed=3, tie=True), width=32, causal=True),
    "pad-rows": dict(cols=dict(seed=4), width=40, causal=False, empty=(0, 5, 6)),
    "pad-id": dict(cols=dict(seed=5), width=32, causal=True, pad=7),
}


# -- layout -------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_examples_columns_equal_jax(case):
    """Every column, the added ``segment_ids``/``position_ids`` included,
    equals the JAX ``pack_examples``'s exactly: first-fit decreasing,
    stable on ties, all-padding rows dropped, the JAX layout invariants."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.pipeline import (
        pack_examples,
    )

    spec = PACK_CASES[case]
    cols = _ragged_lm_columns(**spec["cols"])
    for r in spec.get("empty", ()):
        cols["attention_mask"][r] = 0
        cols["labels"][r] = -100
    kw = dict(causal=spec["causal"], pad_token_id=spec.get("pad", 0))
    got = t_pipe.pack_examples(cols, spec["width"], **kw)
    want = pack_examples(cols, spec["width"], **kw)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n_tokens = int((cols["attention_mask"] > 0).sum())
    assert int(got["attention_mask"].sum()) == n_tokens
    assert got["input_ids"].shape[0] < cols["input_ids"].shape[0]
    seg, pos = got["segment_ids"], got["position_ids"]
    assert ((seg == 0) == (got["attention_mask"] == 0)).all()
    for r in range(seg.shape[0]):
        for s in range(1, seg[r].max() + 1):
            span = pos[r][seg[r] == s]
            np.testing.assert_array_equal(span, np.arange(len(span)))
            if spec["causal"]:
                assert got["labels"][r][seg[r] == s][0] == -100


def test_pack_examples_rejects_scalar_columns_and_oversize():
    cols = _ragged_lm_columns()
    with pytest.raises(ValueError, match="token columns"):
        t_pipe.pack_examples({**cols, "labels": np.zeros(len(cols["input_ids"]), np.int32)},
                             32)
    with pytest.raises(ValueError, match="exceeds"):
        t_pipe.pack_examples(cols, max_length=8)
    with pytest.raises(ValueError, match="input_ids"):
        t_pipe.pack_examples({"input_ids": cols["input_ids"]}, 32)


def _texts(n, seed=0):
    texts, _ = t_src.synthetic_text_classification(n, seed=seed)
    return [" ".join(t.split()[:3 + 4 * (i % 6)]) for i, t in enumerate(texts)]


def test_from_lm_texts_packed_rows_equal_jax():
    """EOS-joined rows: the port's equal the JAX ones exactly, with the
    tokenizer's SEP standing in for a missing EOS, an explicit EOS, the
    tail dropped, and the JAX ``ValueError``s (an EOS outside the vocab, a
    corpus shorter than one row)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import (
        ArrayDataset,
        WordHashTokenizer,
    )

    texts = _texts(30, seed=1)
    for eos in (None, 5):
        got = t_pipe.ArrayDataset.from_lm_texts(t_tok.WordHashTokenizer(VOCAB), texts, 24,
                                                packed=True, eos_token_id=eos)
        want = ArrayDataset.from_lm_texts(WordHashTokenizer(VOCAB), texts, 24, packed=True,
                                          eos_token_id=eos)
        assert list(got.columns) == list(want.columns)
        for k, v in want.columns.items():
            np.testing.assert_array_equal(got.columns[k], np.asarray(v), err_msg=k)
        assert (got.columns["attention_mask"] == 1).all()
        assert (got.columns["input_ids"] == (2 if eos is None else eos)).sum() >= 20
    with pytest.raises(ValueError, match="outside the tokenizer vocab"):
        t_pipe.ArrayDataset.from_lm_texts(t_tok.WordHashTokenizer(VOCAB), texts, 24,
                                          packed=True, eos_token_id=50256)
    with pytest.raises(ValueError, match="shorter than one"):
        t_pipe.ArrayDataset.from_lm_texts(t_tok.WordHashTokenizer(VOCAB), ["a b"], 64,
                                          packed=True)


def test_sharded_batcher_pack_mode_equals_jax():
    """``pack=True`` packs the dataset before batching: the port's batches
    equal the JAX batcher's; combined with buckets it raises "pick one", and
    on a streaming dataset it raises."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.pipeline import (
        ArrayDataset,
        ShardedBatcher,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )

    cols = _ragged_lm_columns()
    port = t_pipe.ShardedBatcher(t_pipe.ArrayDataset(dict(cols)), 2, shuffle=False,
                                 pack=True, pack_causal=True, process_index=0,
                                 process_count=1, native=False)
    ref = ShardedBatcher(ArrayDataset(dict(cols)), 2, build_mesh(MeshConfig()), shuffle=False,
                         pack=True, pack_causal=True, process_index=0, process_count=1)
    got, want = list(port.local_batches(0)), list(ref.local_batches(0))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)
    batch = got[0]
    assert "segment_ids" in batch and "position_ids" in batch
    assert (batch["segment_ids"].max(axis=1) > 1).any()
    # the feed carries both columns to the model's device
    staged = next(iter(port.global_arrays(0, prefetch=0)))
    assert staged["segment_ids"].dtype == torch.int64
    np.testing.assert_array_equal(staged["position_ids"].numpy(), batch["position_ids"])
    with pytest.raises(ValueError, match="pick one"):
        t_pipe.ShardedBatcher(t_pipe.ArrayDataset(dict(cols)), 2, pack=True,
                              bucket_sizes=[16, 32], process_index=0, process_count=1)
    with pytest.raises(ValueError, match="materialized"):
        t_pipe.ShardedBatcher(object(), 2, pack=True, process_index=0, process_count=1)


def test_mlm_dataset_pack_requires_static_masking():
    """``MlmDataset.pack`` freezes the masking draw: it raises without
    ``static_masking`` and with it packs epoch 0's columns exactly as the
    JAX ``MlmDataset.pack``."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import (
        ArrayDataset,
        WordHashTokenizer,
    )

    texts = [f"doc {i} " + "word " * (3 + i % 5) for i in range(12)]
    ours = t_tok.WordHashTokenizer(vocab_size=512)
    with pytest.raises(ValueError, match="static_masking"):
        t_pipe.ArrayDataset.from_mlm_texts(ours, texts, max_length=24).pack(48)
    packed = t_pipe.ArrayDataset.from_mlm_texts(ours, texts, max_length=24,
                                                static_masking=True).pack(48)
    want = ArrayDataset.from_mlm_texts(WordHashTokenizer(vocab_size=512), texts,
                                       max_length=24, static_masking=True).pack(48)
    assert list(packed.columns) == list(want.columns)
    for k, v in want.columns.items():
        np.testing.assert_array_equal(packed.columns[k], np.asarray(v), err_msg=k)
    assert (packed.columns["segment_ids"].max(axis=1) > 1).any()


@pytest.mark.parametrize("seg", [
    [[1, 1, 2, 2, 0]],
    [[1, 2, 2, 3, 3, 3, 0, 0], [1, 1, 1, 1, 1, 1, 1, 1], [0, 0, 0, 0, 0, 0, 0, 0]],
], ids=["jax-example", "ragged-and-all-pad"])
def test_segment_mask_blocks_cross_example_attention(seg):
    """The additive segment mask (and ``make_attention_mask`` with
    ``segment_ids``) equals the JAX one exactly; a padding query keeps
    nothing, an all-padding row is all ``-1e9``."""
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.ops import attention as j_attn

    seg = np.asarray(seg, np.int32)
    got = t_attn.make_segment_mask(torch.from_numpy(seg)).numpy()
    want = np.asarray(j_attn.make_segment_mask(jnp.asarray(seg)))
    np.testing.assert_array_equal(got, want)
    via = t_attn.make_attention_mask(torch.from_numpy((seg > 0).astype(np.int32)),
                                     segment_ids=torch.from_numpy(seg)).numpy()
    np.testing.assert_array_equal(via, want)
    assert got.shape == (len(seg), 1, seg.shape[1], seg.shape[1])
    if seg.shape == (1, 5):
        keep = got[0, 0] == 0.0
        np.testing.assert_array_equal(keep, np.array([
            [1, 1, 0, 0, 0], [1, 1, 0, 0, 0], [0, 0, 1, 1, 0], [0, 0, 1, 1, 0],
            [0, 0, 0, 0, 0]], bool))
    else:
        assert (got[2] == -1e9).all()


# -- loss equivalence (the acceptance gate) ---------------------------------------

def _gpt2_pair(seed=0):
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.auto import init_params
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.gpt2 import (
        Gpt2Config,
        Gpt2LMHeadModel,
    )

    jmodel = Gpt2LMHeadModel(Gpt2Config(dtype=jnp.float32, **GPT2))
    params = init_params(jmodel, seed=seed)
    model = t_gpt2.Gpt2LMHeadModel(t_gpt2.Gpt2Config(**GPT2))
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    model.load_state_dict(params_from_jax(flat), strict=True)
    return jmodel, params, model


def _bert_pair(seed=1):
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.auto import init_params
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.bert import (
        BertForMaskedLM,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.layers import (
        EncoderConfig,
    )

    cfg = EncoderConfig(**BERT)
    jmodel = BertForMaskedLM(cfg)
    params = init_params(jmodel, cfg, seed=seed)
    # the MLM bias away from its zero init, so a head that drops it shows
    params["mlm_head"]["bias"] = jnp.asarray(
        np.random.RandomState(seed).randn(VOCAB) * 0.1, jnp.float32)
    model = t_bert.BertForMaskedLM(t_layers.EncoderConfig(**BERT))
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    model.load_state_dict(params_from_jax(flat), strict=True)
    return jmodel, params, model


def _jax_sums(loss_fn, jmodel, params, batch):
    import jax
    import jax.numpy as jnp

    _, sums = loss_fn(jmodel.apply, params, {k: jnp.asarray(v) for k, v in batch.items()},
                      {}, False)
    return {k: float(v) for k, v in jax.device_get(sums).items()}


def _port_sums(loss_fn, model, batch):
    with torch.no_grad():
        _, sums = loss_fn(model.eval(), {k: torch.from_numpy(v).long()
                                         for k, v in batch.items()})
    return {k: float(v) for k, v in sums.items()}


def _assert_sums(got, want):
    assert got["count"] == want["count"]
    np.testing.assert_allclose(got["loss_sum"], want["loss_sum"], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got["correct"], want["correct"])


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_packed_causal_lm_loss_matches_unpacked(fused):
    """The same examples packed and one per row: equal loss sums, counts
    and correct counts through the port's causal-LM loss (fused: K2's
    plain versions here) and through the JAX one (fused: its Pallas
    kernels in interpret mode), each package equal to the other."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.train import trainer as j_trainer

    jmodel, params, model = _gpt2_pair()
    cols = _ragged_lm_columns(n=16, width=24, vocab=VOCAB, seed=3)
    packed = t_pipe.pack_examples(cols, max_length=48, causal=True)
    if fused:
        port_fn = t_trainer.make_fused_causal_lm_loss(model)
        jax_fn = j_trainer.make_fused_causal_lm_loss(jmodel, interpret=True)
    else:
        port_fn, jax_fn = t_trainer.causal_lm_loss, j_trainer.causal_lm_loss
    ref = _port_sums(port_fn, model, cols)
    got = _port_sums(port_fn, model, packed)
    _assert_sums(got, ref)
    _assert_sums(got, _jax_sums(jax_fn, jmodel, params, packed))
    _assert_sums(ref, _jax_sums(jax_fn, jmodel, params, cols))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_packed_mlm_loss_matches_unpacked(fused):
    """MLM-shaped packing (no shift): sparse labels survive packing, the
    masked sums equal the unpacked batch's, in the port (fused: the
    gathered K rows from packed rows) and against the JAX package."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.train import trainer as j_trainer

    jmodel, params, model = _bert_pair()
    cols = _ragged_lm_columns(n=16, width=24, vocab=VOCAB, seed=5)
    rng = np.random.RandomState(7)
    supervise = (cols["attention_mask"] > 0) & (rng.rand(16, 24) < 0.2)
    cols["labels"] = np.where(supervise, cols["input_ids"], -100).astype(np.int32)
    packed = t_pipe.pack_examples(cols, max_length=48)
    if fused:
        port_fn = t_trainer.make_fused_mlm_loss(0.25)
        jax_fn = j_trainer.make_fused_mlm_loss(jmodel, interpret=True)
    else:
        port_fn = functools.partial(t_trainer.token_cls_loss, with_f1=False)
        jax_fn = functools.partial(j_trainer.token_cls_loss, with_f1=False)
    ref = _port_sums(port_fn, model, cols)
    got = _port_sums(port_fn, model, packed)
    _assert_sums(got, ref)
    want = _jax_sums(jax_fn, jmodel, params, packed)
    _assert_sums(got, want)
    if fused:
        assert got["ce_dropped"] == want["ce_dropped"] == 0.0


def test_packed_gpt2_five_fp32_steps_match_jax_trainer():
    """A packed GPT-2 fit: the same weights and the same packed batches
    (``ShardedBatcher(pack=True, pack_causal=True)``), AdamW with decay and
    clipping, ``segment_packing`` set: the port's fp32 loss curve is the
    JAX Trainer's within 1e-5."""
    import jax
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.train import Trainer as JaxTrainer

    kw = dict(task="causal-lm", segment_packing=True, epochs=1, dtype="float32",
              learning_rate=1e-3, scale_lr_by_world_size=False, weight_decay=0.01,
              max_grad_norm=1.0, log_every_steps=0)
    jmodel, params, model = _gpt2_pair(seed=2)
    ds = t_pipe.ArrayDataset(_ragged_lm_columns(n=80, width=24, vocab=VOCAB, seed=6))
    batches = list(t_pipe.ShardedBatcher(ds, 4, seed=0, pack=True, pack_causal=True,
                                         native=False).local_batches(0))[:5]
    assert len(batches) == 5 and all(b["segment_ids"].max() > 1 for b in batches)
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jtrainer = JaxTrainer(TrainConfig(**kw), jmodel, params, mesh, total_steps=5)
    trainer = t_trainer.Trainer(t_config.TrainConfig(**kw), model, total_steps=5)
    want, got = [], []
    for b in batches:
        jtrainer.state, m = jtrainer._train_step(jtrainer.state,
                                                 {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(jax.device_get(m["loss"])))
        got.append(trainer.train_step({k: torch.from_numpy(v).long() if k != "valid"
                                       else torch.from_numpy(v)
                                       for k, v in b.items()})["loss"].item())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert len(set(np.round(want, 6))) == 5


# -- config and CLI -----------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(task="causal-lm", segment_packing=True),
    dict(task="mlm", segment_packing=True, mlm_static_masking=True),
    dict(task="causal-lm", packed_sequences=True),
], ids=["causal-segment", "mlm-segment", "causal-packed"])
def test_packing_configs_build_as_jax(kw):
    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig

    assert t_config.TrainConfig(**kw).to_dict() == {
        k: v for k, v in TrainConfig(**kw).to_dict().items()
        if k in t_config.TrainConfig().to_dict()}


@pytest.mark.parametrize("kw", [
    dict(task="seq-cls", packed_sequences=True),
    dict(task="causal-lm", packed_sequences=True, streaming=True),
    dict(task="seq-cls", segment_packing=True),
    dict(task="causal-lm", segment_packing=True, packed_sequences=True),
    dict(task="mlm", segment_packing=True, streaming=True),
    dict(task="causal-lm", segment_packing=True, bucket_multiple=64),
], ids=["packed-seq-cls", "packed-streaming", "segment-seq-cls", "segment-and-packed",
        "segment-streaming", "segment-buckets"])
def test_invalid_packing_configs_raise_the_jax_value_error(kw):
    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig

    with pytest.raises(ValueError) as want:
        TrainConfig(**kw)
    with pytest.raises(ValueError) as got:
        t_config.TrainConfig(**kw)
    assert str(got.value) == str(want.value)


def _gpt2_dir(path):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(t_gpt2.gpt2_config_to_hf(t_gpt2.Gpt2Config(
        **{**GPT2, "hidden_size": 32, "intermediate_size": 64}))))
    return str(path)


def _bert_dir(path, model_type="bert"):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps({
        "model_type": model_type, "vocab_size": VOCAB, "hidden_size": 32,
        "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 64,
        "max_position_embeddings": 66, "type_vocab_size": 1, "pad_token_id": 1}))
    return str(path)


def _cli_argv(tmp_path, model_dir, *extra):
    return ["--model_name_or_path", model_dir, "--from_scratch", "true",
            "--dataset", "vendored_reviews", "--max_seq_length", "64", "--epochs", "1",
            "--steps_per_epoch", "3", "--max_train_samples", "64",
            "--max_eval_samples", "16", "--dtype", "float32", "--device", "cpu",
            "--output_data_dir", str(tmp_path / "out"), "--model_dir",
            str(tmp_path / "model"), "--log_every_steps", "0", *extra]


@pytest.mark.parametrize("task,extra", [
    ("causal-lm", ["--segment_packing", "true", "--fused_vocab_ce", "true"]),
    ("causal-lm", ["--packed_sequences", "true"]),
    ("mlm", ["--segment_packing", "true", "--mlm_static_masking", "true",
             "--fused_vocab_ce", "true"]),
], ids=["gpt2-segment", "gpt2-packed", "bert-mlm-segment"])
def test_cli_packs_both_splits_as_the_jax_cli(tmp_path, task, extra):
    """``build_dataset`` packs the train and test splits into the JAX
    CLI's columns exactly; the CLI trains on them (finite losses, the JAX
    results keys) and warns once where the flash route would meet the
    segment mask."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.config import (
        parse_args as jax_parse,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.tokenization import (
        load_tokenizer as jax_load_tokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto
    from scripts.train import build_dataset as jax_build

    model_dir = (_gpt2_dir(tmp_path / "m") if task == "causal-lm"
                 else _bert_dir(tmp_path / "m"))
    argv = _cli_argv(tmp_path, model_dir, "--task", task, *extra)
    tc, jc = t_config.parse_args(argv), jax_parse(argv)
    hf = json.loads((tmp_path / "m" / "config.json").read_text())
    family = j_auto.detect_family(hf)
    jcfg = j_auto.CONFIG_BUILDERS[family](hf)
    tcfg = cli.auto.CONFIG_BUILDERS[family](hf)
    for split in ("train", "test"):
        got = cli.build_dataset(tc, t_tok.load_tokenizer(model_dir, vocab_size=VOCAB), split,
                                64, 64, tcfg)
        want = jax_build(jc, jax_load_tokenizer(model_dir, vocab_size=VOCAB), split, 64, 64,
                         jcfg)
        assert list(got.columns) == list(want.columns)
        for k, v in want.columns.items():
            np.testing.assert_array_equal(got.columns[k], np.asarray(v), err_msg=k)
    results = cli.main(argv)
    assert all(np.isfinite(results["train"]["loss"]))
    assert list(read_results_file(str(tmp_path / "out" / "eval_results.txt"))) == [
        "eval_loss", "eval_accuracy"]


def test_cli_segment_packing_refusals_and_flash_warning(tmp_path, capsys):
    """The JAX CLI's refusals: a family other than gpt2 or bert, and MLM
    without static masking; with the flash route the CLI warns that the
    segment mask runs the plain attention."""
    rob = _bert_dir(tmp_path / "rob", "roberta")
    with pytest.raises(ValueError, match="got family 'roberta'"):
        cli.main(_cli_argv(tmp_path, rob, "--task", "mlm", "--segment_packing", "true",
                           "--mlm_static_masking", "true"))
    bert = _bert_dir(tmp_path / "bert")
    with pytest.raises(ValueError, match="--mlm_static_masking true"):
        cli.main(_cli_argv(tmp_path, bert, "--task", "mlm", "--segment_packing", "true"))
    capsys.readouterr()
    cli.main(_cli_argv(tmp_path, _gpt2_dir(tmp_path / "g"), "--task", "causal-lm",
                       "--segment_packing", "true", "--attention_impl", "flash"))
    out = capsys.readouterr()
    assert (out.out + out.err).count("O(S^2)") == 1
