"""PyTorch port: masked-LM and replaced-token-detection pretraining against
the JAX package on the same weights (carried across with
``params_from_jax``) and the same numpy inputs from a seed: the five
families' MLM heads and ELECTRA's RTD head (``models/``), whole-word
masking and the RTD corpus (``data/pipeline.py``: ``encode_mlm_clean``,
``apply_mlm_masking``, ``MlmDataset`` re-drawn per epoch through the
batcher, ``from_rtd_texts``), streaming ``mlm`` (``data/streaming.py``),
the losses (``train/trainer.py``: ``mlm``'s token CE, ``rtd_loss`` and the
sparse-gather fused ``make_fused_mlm_loss``, held against the JAX one with
its Pallas kernels in interpret mode at hidden 128), a resumed MLM fit,
HF exports read across both packages, the CLI's ``--task mlm|rtd`` runs,
the parsed flags, and the ROADMAP item every "not ported" raise names.

Tolerances: logits 1e-4 (fp32 through two layers in two frameworks);
5-step loss curves 1e-5 relative (fp32, sums in other orders), and the
port's fused and unfused curves 1e-5 of each other; loss sums 1e-5
relative and counts exact; masking columns, selected rows and resumed
losses and weights exact."""

import collections
import contextlib
import io
import json
import math

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import config as t_config
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import pipeline as t_pipe
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import sources as t_src
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import streaming as t_stream
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import tokenization as t_tok
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import wordpiece as t_wp
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto as t_auto
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
    encoder_to_hf,
    params_from_jax,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import trainer as t_trainer
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.results import (
    read_results_file,
)

SEQ = 32
VOCAB = 512


def _hf(family: str, hidden: int = 64) -> dict:
    """A tiny config in the family's own HF dialect, dropout 0; ELECTRA and
    ALBERT embed at half the hidden width."""
    common = {"vocab_size": VOCAB, "max_position_embeddings": 66}
    if family == "distilbert":
        return {"model_type": "distilbert", "dim": hidden, "n_layers": 2, "n_heads": 2,
                "hidden_dim": 2 * hidden, "dropout": 0.0, "attention_dropout": 0.0,
                **common}
    cfg = {"model_type": family, "hidden_size": hidden, "num_hidden_layers": 2,
           "num_attention_heads": 2, "intermediate_size": 2 * hidden,
           "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0, **common}
    if family == "roberta":
        cfg.update(type_vocab_size=1, pad_token_id=1)
    if family in ("electra", "albert"):
        cfg["embedding_size"] = hidden // 2
    if family == "albert":
        cfg["classifier_dropout_prob"] = 0.0
    return cfg


FAMILIES = ["bert", "roberta", "distilbert", "electra", "albert"]
HEADS = [(f, "mlm") for f in FAMILIES] + [("electra", "rtd")]
HEAD_IDS = [f"{f}-{t}" for f, t in HEADS]


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
    installed tracker before and after this module, and run the JAX
    package with its telemetry off (it then installs none)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu import obs as jax_obs

    _drop_compile_trackers()
    jax_obs.reset(enabled=False)
    yield
    jax_obs.reset()
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


def _model_dir(path, family, hidden=64):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(_hf(family, hidden)))
    return str(path)


def _pair(tmp_path, family, task, seed=0, hidden=64, **overrides):
    """(JAX model, JAX params, port model) on the same weights; the MLM
    bias drawn away from its zero init so a head that drops it shows."""
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto

    path = _model_dir(tmp_path / f"{family}-{task}-{hidden}", family, hidden)
    jmodel, params, _, _ = j_auto.from_pretrained(path, task=task, seed=seed)
    if "mlm_head" in params:
        params["mlm_head"]["bias"] = jnp.asarray(
            np.random.RandomState(seed + 5).randn(VOCAB) * 0.1, jnp.float32)
    model, _, _ = t_auto.from_pretrained(path, task=task, device="cpu", **overrides)
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    model.load_state_dict(params_from_jax(flat), strict=True)
    return jmodel, params, model


def _reviews(n=48, split="train"):
    texts, _ = t_src.load_text_classification("vendored_reviews", split, max_samples=n)
    return texts


def _vocab(texts=None, n_words=120) -> dict:
    """BERT's specials, the reviews' most frequent words, then every
    character alone and as a continuation: the rarer words split into
    ``##`` pieces, so whole-word masking has multi-piece words to mask."""
    texts = texts or _reviews(200)
    counts = collections.Counter(w for t in texts for w in t.lower().split())
    words = [w for w, _ in counts.most_common(n_words)]
    chars = sorted({c for t in texts for c in t.lower() if not c.isspace()})
    tokens = list(dict.fromkeys(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
                                + chars + ["##" + c for c in chars]))
    assert len(tokens) <= VOCAB
    return {t: i for i, t in enumerate(tokens)}


def _tokenizers():
    """(port, JAX) WordPiece tokenizers over the same vocab."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.wordpiece import (
        WordPieceTokenizer,
    )

    vocab = _vocab()
    return t_wp.WordPieceTokenizer(vocab), WordPieceTokenizer(vocab)


def _to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() if k != "valid"
            else torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax_batch(batch):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in batch.items()}


def _inputs(seed=0, rows=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, VOCAB, (rows, SEQ))
    mask = np.ones((rows, SEQ), np.int64)
    mask[1, 20:] = 0
    types = np.zeros_like(ids)
    types[:, SEQ // 2:] = 1
    return ids, mask, types


# -- the heads ------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("family,task", HEADS, ids=HEAD_IDS)
def test_head_logits_match_jax(tmp_path, family, task, impl):
    """Each head's logits (MLM ``[B, S, V]``, RTD ``[B, S]``, fp32) within
    1e-4 of the JAX head on the plain and the flash path; the fused
    inputs ``(x, table, bias)`` give the same logits as ``x·tableᵀ + b``
    and equal the JAX ``return_fused_inputs``."""
    import jax.numpy as jnp

    jmodel, params, model = _pair(tmp_path, family, task, attention_impl=impl)
    ids, mask, types = _inputs(seed=1)
    if family == "roberta":
        types = np.zeros_like(types)
    args = [jnp.asarray(ids), jnp.asarray(mask)]
    want = np.asarray(jmodel.apply({"params": params}, *args,
                                   token_type_ids=jnp.asarray(types)))
    t_args = [torch.from_numpy(ids), torch.from_numpy(mask)]
    with torch.no_grad():
        got = model.eval()(*t_args, token_type_ids=torch.from_numpy(types))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    if task != "mlm":
        return
    with torch.no_grad():
        x, table, bias = model(*t_args, token_type_ids=torch.from_numpy(types),
                               return_fused_inputs=True)
    width = _hf(family).get("embedding_size", 64)
    assert x.shape == (3, SEQ, width) and table.shape == (VOCAB, width)
    torch.testing.assert_close(x @ table.t() + bias, got, rtol=1e-5, atol=1e-5)
    jx, _, jbias = jmodel.apply({"params": params}, *args, token_type_ids=jnp.asarray(types),
                                return_fused_inputs=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(bias.detach().numpy(), np.asarray(jbias))


# -- the data --------------------------------------------------------------------

@pytest.mark.parametrize("whole_word", [True, False], ids=["whole_word", "per_token"])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_masking_equals_jax_exactly(seed, whole_word):
    """``encode_mlm_clean`` and ``apply_mlm_masking`` on WordPiece rows
    give the JAX package's columns exactly, with the JAX test's statistics
    (about 15% of the real tokens predicted, about 80% of them [MASK], -100
    elsewhere) and, whole-word, every piece of a word predicted together."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import pipeline as j_pipe

    ours, theirs = _tokenizers()
    texts = _reviews(64)
    clean = t_pipe.encode_mlm_clean(ours, texts, SEQ * 2)
    want_clean = j_pipe.encode_mlm_clean(theirs, texts, SEQ * 2)
    for g, w in zip(clean, want_clean):
        np.testing.assert_array_equal(g, w)
    ids, am, wid = clean
    args = (ours.mask_token_id, ours.vocab_size, 0.15, whole_word)
    got = t_pipe.apply_mlm_masking(ids, wid, np.random.RandomState(seed), *args)
    want = j_pipe.apply_mlm_masking(ids, wid, np.random.RandomState(seed), *args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    masked_ids, labels = got
    sel = labels != -100
    assert 0.08 < sel.sum() / (wid >= 0).sum() < 0.25
    assert 0.6 < (masked_ids[sel] == ours.mask_token_id).mean() < 0.95
    np.testing.assert_array_equal(labels[sel], ids[sel])
    np.testing.assert_array_equal(masked_ids[~sel], ids[~sel])
    assert sel.any(axis=1).all()                       # at least one a row
    if whole_word:
        pieces = 0
        for r in range(len(texts)):
            for w in range(wid[r].max() + 1):
                flags = sel[r][wid[r] == w]
                assert flags.all() or not flags.any()
                pieces += flags.all() and len(flags) > 1
        assert pieces > 0                               # multi-piece words masked


@pytest.mark.parametrize("seed", [0, 7])
def test_rtd_corpus_equals_jax_exactly(seed):
    """``from_rtd_texts`` gives the JAX package's columns exactly: about
    15% of the real tokens replaced, labels 1 where the id changed, 0 on
    untouched tokens and -100 on specials and pads."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import pipeline as j_pipe

    ours, theirs = _tokenizers()
    texts = _reviews(64)
    got = t_pipe.ArrayDataset.from_rtd_texts(ours, texts, SEQ * 2, seed=seed)
    want = j_pipe.ArrayDataset.from_rtd_texts(theirs, texts, SEQ * 2, seed=seed)
    assert list(got.columns) == list(want.columns) == ["input_ids", "attention_mask", "labels"]
    for key in want.columns:
        np.testing.assert_array_equal(got.columns[key], np.asarray(want.columns[key]), key)
    clean = ours(texts, truncation=True, padding="max_length", max_length=SEQ * 2)
    labels, ids = got.columns["labels"], got.columns["input_ids"]
    real = labels != -100
    assert 0.1 < (labels == 1).sum() / real.sum() < 0.2
    np.testing.assert_array_equal(ids != np.asarray(clean["input_ids"]), labels == 1)
    assert (labels[:, 0] == -100).all() and (labels[got.columns["attention_mask"] == 0]
                                             == -100).all()


def test_mlm_dataset_redraws_per_epoch_and_batches_as_jax():
    """``MlmDataset`` draws new masks each epoch from ``seed + epoch``
    (``static_masking`` pins epoch 0's); the batcher gives the JAX
    ``ShardedBatcher``'s batches epoch by epoch, also from a mid-epoch
    ``start_step`` and with an eval batcher over the same dataset at epoch
    0 between two of its batches; the prefetching feed yields them too."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import (
        ArrayDataset,
        ShardedBatcher,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )

    ours, theirs = _tokenizers()
    texts = _reviews(40)
    ds = t_pipe.ArrayDataset.from_mlm_texts(ours, texts, SEQ, seed=4)
    jds = ArrayDataset.from_mlm_texts(theirs, texts, SEQ, seed=4)
    assert list(ds.columns) == list(jds.columns)
    epoch0 = ds.columns["labels"].copy()
    ds.begin_epoch(1)
    assert not np.array_equal(ds.columns["labels"], epoch0)
    static = t_pipe.ArrayDataset.from_mlm_texts(ours, texts, SEQ, seed=4, static_masking=True)
    static.begin_epoch(3)
    np.testing.assert_array_equal(static.columns["labels"], epoch0)
    with pytest.raises(ValueError, match="static_masking"):
        ds.pack()
    # packing the pinned draw is ported: epoch 0's columns packed as JAX packs them
    packed = static.pack()
    want = ArrayDataset.from_mlm_texts(theirs, texts, SEQ, seed=4, static_masking=True).pack()
    assert list(packed.columns) == list(want.columns)
    for key, value in want.columns.items():
        np.testing.assert_array_equal(packed.columns[key], np.asarray(value), err_msg=key)

    port = t_pipe.ShardedBatcher(ds, 8, seed=5, native=False)
    ref = ShardedBatcher(jds, 8, build_mesh(MeshConfig()), seed=5)
    evals = t_pipe.ShardedBatcher(ds, 8, shuffle=False, drop_remainder=False, native=False)
    for epoch, start in ((0, 0), (1, 0), (2, 0), (1, 2)):
        want = list(ref.local_batches(epoch, start))
        got = []
        for i, b in enumerate(port.local_batches(epoch, start)):
            got.append(b)
            if i == 0:
                next(iter(evals.local_batches(0)))     # re-masks the dataset to epoch 0
        assert len(got) == len(want) == port.steps_per_epoch() - start
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    fed = list(port.global_arrays(1))
    for g, w in zip(fed, ref.local_batches(1)):
        np.testing.assert_array_equal(g["labels"].numpy(), w["labels"])


def test_streaming_mlm_columns_equal_jax(tmp_path):
    """Streaming ``mlm`` masks each row from ``RandomState([seed, epoch,
    row])``: the same columns as the JAX stream for any rows and epoch,
    whichever batch gathers them."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.streaming import (
        LineCorpus,
        StreamingTextDataset,
    )

    ours, theirs = _tokenizers()
    texts = _reviews(48)
    path = tmp_path / "train.jsonl"
    path.write_text("".join(json.dumps({"text": t}) + "\n" for t in texts))
    got = t_stream.StreamingTextDataset(t_stream.LineCorpus(str(path), native=False), ours,
                                        task="mlm", max_length=SEQ, seed=9)
    want = StreamingTextDataset(LineCorpus(str(path)), theirs, task="mlm", max_length=SEQ,
                                seed=9)
    for epoch in (0, 2):
        got.begin_epoch(epoch)
        want.begin_epoch(epoch)
        for idx in (np.arange(8), np.array([40, 3, 3, 17])):
            g, w = got[idx], want[idx]
            assert list(g) == list(w)
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    got.begin_epoch(0)
    np.testing.assert_array_equal(got[np.array([17])]["labels"][0],
                                  got[np.array([2, 17])]["labels"][1])
    no_mask = t_wp.WordPieceTokenizer({t: i for i, t in enumerate(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a"])})
    with pytest.raises(ValueError, match="MASK"):
        t_stream.StreamingTextDataset(t_stream.LineCorpus(str(path), native=False), no_mask,
                                      task="mlm")


# -- the losses ------------------------------------------------------------------

FIT_CASES = [("bert", "mlm", False), ("bert", "mlm", True), ("distilbert", "mlm", True),
             ("electra", "rtd", False)]


@pytest.mark.parametrize("family,task,fused", FIT_CASES,
                         ids=["bert-mlm", "bert-mlm-fused", "distilbert-mlm-fused",
                              "electra-rtd"])
def test_five_fp32_steps_match_jax_trainer(tmp_path, family, task, fused):
    """Same weights, same batches, AdamW with decay and clipping: the
    port's loss curve is the JAX Trainer's within 1e-5, the fused MLM one
    against the JAX fused loss with its Pallas kernels in interpret mode
    (hidden 128: the kernel's tiles), and within 1e-5 of the port's own
    unfused curve."""
    import jax

    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.train import Trainer as JaxTrainer
    from huggingface_sagemaker_tensorflow_distributed_tpu.train.trainer import (
        make_fused_mlm_loss as jax_fused_mlm,
    )

    kw = dict(task=task, fused_vocab_ce=fused, epochs=1, dtype="float32",
              learning_rate=1e-3, scale_lr_by_world_size=False, weight_decay=0.01,
              max_grad_norm=1.0, log_every_steps=0)
    jmodel, params, model = _pair(tmp_path, family, task, hidden=128)
    ours, _ = _tokenizers()
    texts = _reviews(48)
    ds = (t_pipe.ArrayDataset.from_mlm_texts(ours, texts, SEQ, seed=1) if task == "mlm"
          else t_pipe.ArrayDataset.from_rtd_texts(ours, texts, SEQ, seed=1))
    batches = list(t_pipe.ShardedBatcher(ds, 8, seed=0, native=False).local_batches(0))[:5]
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jtrainer = JaxTrainer(TrainConfig(**kw), jmodel, params, mesh, total_steps=5)
    if fused:
        jtrainer.loss_fn = jax_fused_mlm(jmodel, interpret=True)
    trainer = t_trainer.Trainer(t_config.TrainConfig(**kw), model, total_steps=5)
    plain = None
    if fused:
        _, _, twin = _pair(tmp_path, family, task, hidden=128)
        plain = t_trainer.Trainer(t_config.TrainConfig(**dict(kw, fused_vocab_ce=False)),
                                  twin, total_steps=5)
    want, got, unfused = [], [], []
    for b in batches:
        jtrainer.state, m = jtrainer._train_step(jtrainer.state, _jax_batch(b))
        want.append(float(jax.device_get(m["loss"])))
        got.append(trainer.train_step(_to_torch(b))["loss"].item())
        if plain is not None:
            unfused.append(plain.train_step(_to_torch(b))["loss"].item())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if plain is not None:
        np.testing.assert_allclose(got, unfused, rtol=1e-5)
    assert trainer.updates == 5 and len(set(np.round(want, 6))) == 5


def test_mask_cap_drops_the_rows_jax_drops(tmp_path):
    """With more labelled tokens than K (``mask_cap`` 0.05, 60% masking):
    the port keeps exactly the rows the JAX ``lax.top_k`` keeps, and its
    fused loss's sums, ``ce_dropped`` among them, equal the JAX fused
    loss's (Pallas in interpret mode)."""
    import jax
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.train.trainer import (
        make_fused_mlm_loss as jax_fused_mlm,
    )

    jmodel, params, model = _pair(tmp_path, "bert", "mlm", hidden=128)
    ours, _ = _tokenizers()
    ds = t_pipe.ArrayDataset.from_mlm_texts(ours, _reviews(16), 64, seed=2,
                                            mlm_probability=0.6)
    batch = ds[np.arange(16)]
    batch["valid"] = np.array([1] * 15 + [0], np.int32)
    flags = ((batch["labels"] != -100) & (batch["attention_mask"] > 0)
             & (batch["valid"][:, None] > 0)).reshape(-1)
    k = t_trainer.mlm_gather_rows(flags.size, 0.05)
    assert k == 256 and flags.sum() > k
    sel, sel_valid = t_trainer.mlm_gather_index(torch.from_numpy(flags), k)
    _, want_sel = jax.lax.top_k(jnp.asarray(flags.astype(np.int32)), k)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(want_sel))
    assert bool(sel_valid.all())
    _, want = jax_fused_mlm(jmodel, mask_cap=0.05, interpret=True)(
        jmodel.apply, params, _jax_batch(batch), None, False)
    with torch.no_grad():
        _, got = t_trainer.make_fused_mlm_loss(mask_cap=0.05)(model.eval(),
                                                                     _to_torch(batch))
    assert set(got) == set(want) == {"loss_sum", "correct", "count", "ce_dropped"}
    np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]), rtol=1e-5)
    for key in ("correct", "count", "ce_dropped"):
        assert float(got[key]) == float(want[key]), key
    assert float(got["count"]) == k and float(got["ce_dropped"]) == flags.sum() - k


def test_resumed_mlm_fit_equals_the_uninterrupted_fit(tmp_path):
    """Two epochs of MLM over a per-epoch re-masked dataset, fused loss,
    dropout on, through the prefetch thread: stopped in epoch 1 after step
    3 (last save at its step 2), restored and finished, the losses and
    weights equal the uninterrupted fit's bit for bit."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.bert import (
        BertForMaskedLM,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.checkpoint import (
        Checkpointer,
    )

    class Stop(Exception):
        pass

    ours, _ = _tokenizers()
    ds = t_pipe.ArrayDataset.from_mlm_texts(ours, _reviews(48), SEQ, seed=3)
    enc_cfg = t_auto.CONFIG_BUILDERS["bert"](
        dict(_hf("bert"), hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1))
    torch.manual_seed(3)
    initial = BertForMaskedLM(enc_cfg).state_dict()
    cfg = t_config.TrainConfig(task="mlm", fused_vocab_ce=True, epochs=2, dtype="float32",
                               learning_rate=1e-3, scale_lr_by_world_size=False,
                               log_every_steps=0, checkpoint_every_steps=3)

    def fit(ckpt_dir, stop_after=None, restore=False):
        model = BertForMaskedLM(enc_cfg)
        model.load_state_dict(initial)
        torch.manual_seed(7)
        trainer = t_trainer.Trainer(cfg, model, total_steps=12)
        losses = []
        step = trainer.train_step

        def run(batch):
            if stop_after is not None and len(losses) == stop_after:
                raise Stop
            out = step(batch)
            losses.append(out["loss"].item())
            return out

        trainer.train_step = run
        ckpt = Checkpointer(str(ckpt_dir))
        kw = {}
        if restore:
            state, epoch, step_in_epoch = ckpt.restore()
            trainer.load_state_dict(state)
            kw = dict(start_epoch=epoch, start_step_in_epoch=step_in_epoch)
            assert (epoch, step_in_epoch) == (1, 3)
        try:
            trainer.fit(t_pipe.ShardedBatcher(ds, 8, seed=2), checkpointer=ckpt, **kw)
        finally:
            ckpt.close()
        return losses, trainer.model.state_dict()

    full, weights = fit(tmp_path / "full")
    assert len(full) == 12
    with pytest.raises(Stop):
        fit(tmp_path / "cut", stop_after=10)
    resumed, resumed_weights = fit(tmp_path / "cut", restore=True)
    assert resumed == full[9:]
    for key in weights:
        assert torch.equal(resumed_weights[key], weights[key]), key


# -- exports and the CLI ---------------------------------------------------------------

@pytest.mark.parametrize("family,task", HEADS, ids=HEAD_IDS)
def test_hf_exports_read_across_both_packages(tmp_path, family, task):
    """The port's export holds the JAX ``params_to_hf`` keys (no tied
    decoder weight) and the JAX ``from_pretrained`` reads it to the same
    logits; the JAX export reads into the port to the same logits."""
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict
    from safetensors.numpy import load_file

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.convert import (
        params_to_hf,
    )

    jmodel, params, model = _pair(tmp_path, family, task, seed=3)
    cfg = t_auto.CONFIG_BUILDERS[family](_hf(family))
    ids, mask, _ = _inputs(seed=4)
    out = tmp_path / "port_export"
    t_auto.save_pretrained(str(out), model, family, cfg)
    written = load_file(str(out / "model.safetensors"))
    assert sorted(written) == sorted(params_to_hf(params, family))
    assert not any("decoder" in k or k.endswith(("lm_head.weight", "projector.weight"))
                   for k in written)
    jm, jp, fam, _ = j_auto.from_pretrained(str(out), task=task)
    assert fam == family
    flat = flatten_dict(jp, sep="/")
    for key, value in flatten_dict(params, sep="/").items():
        np.testing.assert_array_equal(np.asarray(flat[key]), np.asarray(value), key)
    jout = tmp_path / "jax_export"
    j_auto.save_pretrained(str(jout), params, family, j_auto.CONFIG_BUILDERS[family](
        _hf(family)))
    reloaded, _, _ = t_auto.from_pretrained(str(jout), task=task, device="cpu")
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = reloaded.eval()(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _cli_args(model_dir, task, extra=()):
    return ["--model_name_or_path", model_dir, "--from_scratch", "true", "--task", task,
            "--dataset", "vendored_reviews", "--max_train_samples", "16",
            "--max_eval_samples", "8", "--epochs", "1", "--train_batch_size", "4",
            "--eval_batch_size", "4", "--dtype", "float32", "--log_every_steps", "0",
            "--max_seq_length", str(SEQ), *extra]


CLI_CASES = [("bert", "mlm", True), ("electra", "rtd", True), ("roberta", "mlm", False),
             ("distilbert", "mlm", False), ("albert", "mlm", False), ("electra", "mlm", False)]


@pytest.mark.parametrize("family,task,with_jax", CLI_CASES,
                         ids=[f"{f}-{t}" for f, t, _ in CLI_CASES])
def test_cli_on_cpu_writes_the_jax_cli_files(tmp_path, family, task, with_jax):
    """``--task mlm --fused_vocab_ce true`` for every family and ``--task
    rtd`` for ELECTRA: the JAX CLI's results keys and export files (run
    beside the JAX CLI on the same argv for BERT MLM and ELECTRA RTD), an
    export that both packages read, finite results."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto

    model_dir = _model_dir(tmp_path / "cfg", family)
    extra = ["--fused_vocab_ce", "true"] if task == "mlm" else []
    out, mdir = tmp_path / "port" / "out", tmp_path / "port" / "model"
    res = cli.main(_cli_args(model_dir, task, extra)
                   + ["--device", "cpu", "--output_data_dir", str(out), "--model_dir", str(mdir)])
    got = {f: list(read_results_file(str(out / f)))
           for f in ("train_results.txt", "eval_results.txt")}
    assert got["eval_results.txt"] == ["eval_loss", "eval_accuracy"]
    assert all(math.isfinite(v) for v in res["eval"].values())
    assert all(math.isfinite(v) for v in res["train"]["loss"])
    jm, jp, fam, _ = j_auto.from_pretrained(str(mdir), task=task)
    reloaded, _, _ = t_auto.from_pretrained(str(mdir), task=task, device="cpu")
    assert fam == family
    assert sorted(encoder_to_hf(reloaded.state_dict(), family)) == sorted(_written_keys(mdir))
    if not with_jax:
        return
    from scripts.train import main as jax_main

    jout, jmdir = tmp_path / "jax" / "out", tmp_path / "jax" / "model"
    jax_main(_cli_args(model_dir, task, extra)
             + ["--output_data_dir", str(jout), "--model_dir", str(jmdir)])
    for fname, keys in got.items():
        assert keys == list(read_results_file(str(jout / fname))), fname
    assert sorted(p.name for p in mdir.iterdir()) == sorted(p.name for p in jmdir.iterdir())
    assert json.loads((mdir / "config.json").read_text()) == \
        json.loads((jmdir / "config.json").read_text())


def _written_keys(model_dir):
    from safetensors.numpy import load_file

    return load_file(str(model_dir / "model.safetensors")).keys()


# -- flags and raises --------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--task", "mlm"], ["--task", "rtd"],
    ["--task", "mlm", "--fused_vocab_ce", "true", "--fused_mlm_mask_cap", "0.1",
     "--mlm_static_masking", "true"],
    ["--task", "causal-lm", "--remat", "true"]],
    ids=["mlm", "rtd", "mlm-fused-static", "causal-lm-remat"])
def test_ported_flags_parse_as_jax(argv):
    from huggingface_sagemaker_tensorflow_distributed_tpu.config import parse_args

    assert t_config.parse_args(argv).to_dict() == parse_args(argv).to_dict()


def _raise_sites():
    """(name, call that raises NotImplementedError, the item it must
    name): every "not ported" raise of the port's modules."""
    from types import SimpleNamespace

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import bart as t_bart
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import generate as t_gen
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import gpt2 as t_gpt2
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import layers as t_layers
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import llama as t_llama
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import t5 as t_t5
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import attention as t_attn
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import optim as t_optim

    q = torch.zeros(1, 1, 4, 8)
    return [
        ("config-lora", lambda: _ported_config(dict(lora_rank=4),
                                               dict(lora_rank=4, lora_alpha=0.0)), None),
        ("config-moe", lambda: t_config.TrainConfig(num_experts=4), None),
        ("config-ep", lambda: t_config.TrainConfig(num_experts=4, ep=2), "11"),
        ("config-packing", lambda: _ported_config(
            dict(task="mlm", segment_packing=True),
            dict(task="mlm", segment_packing=True, streaming=True)), None),
        ("config-lamb", lambda: _ported_config(
            dict(optimizer="lamb", weight_decay=0.01),
            dict(optimizer="lamb", optimizer_state_dtype="bfloat16")), None),
        ("config-bf16-moments", lambda: _ported_config(
            dict(optimizer_state_dtype="bfloat16"),
            dict(optimizer="adafactor", optimizer_state_dtype="bfloat16")), None),
        ("config-remat-policy", lambda: _ported_config(
            dict(remat=True, remat_policy="dots"),
            dict(remat=True, remat_policy="dots_with_batch")), None),
        ("config-ring", lambda: t_config.TrainConfig(attention_impl="ring"), "11"),
        ("config-tp", lambda: t_config.TrainConfig(tp=2), "11"),
        ("layers-moe", lambda: t_layers.EncoderConfig(num_experts=2), None),
        ("layers-pipeline", lambda: t_layers.EncoderConfig(pipeline_stages=2), "11"),
        ("layers-remat-policy", lambda: _ported_remat(
            lambda: t_layers.EncoderConfig(remat=True, remat_policy="dots")), None),
        ("layers-ring", lambda: t_layers.EncoderConfig(attention_impl="ring"), "11"),
        ("gpt2-remat-policy", lambda: _ported_remat(
            lambda: t_gpt2.Gpt2Config(remat=True, remat_policy="dots_no_batch")), None),
        ("gpt2-moe", lambda: t_gpt2.Gpt2Config(num_experts=4), None),
        ("gpt2-pipeline", lambda: t_gpt2.Gpt2Config(pipeline_stages=2), "11"),
        ("gpt2-quant", lambda: _ported_quant("gpt2"), None),
        ("gpt2-ring", lambda: t_gpt2.Gpt2Config(attention_impl="ring"), "11"),
        ("attention-ring", lambda: t_attn.dot_product_attention(q, q, q, impl="ring"), "11"),
        ("optim-lamb", lambda: _lamb_steps(t_optim), None),
        ("pipeline-packed", _ported_packed_lm_rows, None),
        ("auto-family", _ported_llama_family, None),
        ("auto-export", _ported_llama_export, None),
        ("llama-pipeline", lambda: t_llama.LlamaConfig(pipeline_stages=2), "11"),
        ("llama-ring", lambda: t_llama.LlamaConfig(attention_impl="ring"), "11"),
        ("t5-ring", lambda: t_t5.T5Config(attention_impl="ring"), "11"),
        ("t5-pipeline", lambda: t_t5.T5Config(pipeline_stages=2), "11"),
        ("t5-quant", lambda: _ported_quant("t5"), None),
        ("t5-remat-policy", lambda: _ported_remat(
            lambda: t_t5.T5Config(remat=True, remat_policy="dots")), None),
        ("bart-ring", lambda: t_bart.BartConfig(attention_impl="ring"), "11"),
        ("bart-pipeline", lambda: t_bart.BartConfig(pipeline_stages=2), "11"),
        ("bart-quant", lambda: _ported_quant("bart"), None),
        ("bart-remat-policy", lambda: _ported_remat(
            lambda: t_bart.BartConfig(remat=True, remat_policy="dots_no_batch")), None),
        ("generate-sampling", lambda: _ported_decoding("sampling"), None),
        ("generate-beam", lambda: _ported_decoding("beam"), None),
        ("generate-speculative-seq2seq", lambda: _ported_decoding("speculative"), None),
        ("beam-causal-experts", _beam_experts_raise_jax_error, None),
        ("engine-int8-kv", lambda: _int8_engine(), None),
        ("engine-tp", lambda: _tiny_engine(mesh=2), "11"),
        ("engine-mesh", lambda: _tiny_engine(mesh=SimpleNamespace(shape={"tensor": 2})),
         "11"),
        ("serve-cli-tp", lambda: _serve_cli("--tp", "2"), "11"),
        ("serve-cli-replicas", lambda: _serve_cli("--replicas", "2"), None),
        ("serve-cli-placement", lambda: _serve_cli("--replicas", "2", "--placement",
                                                   "affinity"), None),
        ("serve-cli-roles", lambda: _serve_cli("--roles", "prefill:1,decode:1"), None),
        ("serve-cli-arrival", lambda: _serve_cli("--arrival", "poisson:20"), None),
        ("serve-cli-rate-limit", lambda: _serve_cli("--rate_limit", "*=0.001:1",
                                                    requests=2), None),
        ("obs-lint", _obs_lint, "12"),
    ]


def _obs_lint():
    """``python -m <port>.obs lint``: the JAX package's static analysis is
    not ported."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.__main__ import (
        build_parser,
    )

    args = build_parser().parse_args(["lint"])
    args.func(args)


def _ported_llama_family():
    for mt in ("llama", "mistral", "qwen2", "gemma", "mixtral"):
        assert t_auto.detect_family({"model_type": mt}) == "llama"


def _ported_llama_export():
    """A tiny Llama exports in HF layout and reads back to the same
    weights."""
    import tempfile

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import init_llama
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                      num_kv_heads=1, intermediate_size=32, max_position_embeddings=32)
    model = init_llama(cfg, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        t_auto.save_pretrained(d, model, "llama", cfg)
        back, family, cfg2 = t_auto.from_pretrained(d, task="causal-lm", device="cpu")
    assert family == "llama" and cfg2 == cfg
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def _beam_experts_raise_jax_error():
    """Beam search refuses an MoE model with the JAX package's ValueError."""
    from types import SimpleNamespace

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import generate as t_gen

    with pytest.raises(ValueError, match="beam_search_causal does not support MoE models"):
        t_gen.beam_search_causal(SimpleNamespace(config=SimpleNamespace(num_experts=2)),
                                 np.ones((1, 4)))


def _tiny_engine(**kw):
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import gpt2 as t_gpt2
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import init_gpt2
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import ServeEngine

    cfg = t_gpt2.Gpt2Config(vocab_size=64, max_position_embeddings=32, hidden_size=8,
                            num_layers=1, num_heads=1, intermediate_size=16)
    return ServeEngine(init_gpt2(cfg, device="cpu"), num_blocks=9, block_size=4,
                       max_model_len=32, device="cpu", **kw)


def _serve_cli(*argv, requests=1):
    """The serving CLI on the CPU; a flag of item 10 (ported) serves every
    request it admits (one line each) and its summary."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--device", "cpu", "--requests", str(requests), "--max_new_tokens", "4",
                  *argv])
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert lines[-1]["summary"] and lines[-1]["requests"] == len(lines) - 1 >= 1
    if "--replicas" in argv or "--roles" in argv:
        assert lines[-1]["replicas"] == 2 and all("replica" in r for r in lines[:-1])


def _ported_config(valid: dict, invalid: dict) -> None:
    """A config of ROADMAP item 6, now ported: ``valid`` builds as in
    the JAX package and ``invalid`` raises the JAX package's ``ValueError``
    word for word."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig

    assert t_config.TrainConfig(**valid).to_dict().items() <= TrainConfig(**valid).to_dict().items()
    with pytest.raises(ValueError) as want:
        TrainConfig(**invalid)
    with pytest.raises(ValueError) as got:
        t_config.TrainConfig(**invalid)
    assert str(got.value) == str(want.value)


def _ported_remat(make) -> None:
    """A remat policy of ROADMAP item 4, now ported: the config ``make``
    builds, and an unknown policy raises the JAX package's ``ValueError``
    word for word."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.layers import remat_policy

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import layers as t_layers

    cfg = make()
    assert cfg.remat and cfg.remat_policy in ("dots", "dots_no_batch")
    assert callable(t_layers.remat_policy(cfg.remat_policy))
    with pytest.raises(ValueError) as want:
        remat_policy("dots_with_batch")
    with pytest.raises(ValueError) as got:
        t_layers.remat_policy("dots_with_batch")
    assert str(got.value) == str(want.value)


def _lamb_steps(t_optim) -> None:
    """LAMB (ROADMAP item 4, ported) builds from a config and steps: the
    parameter moves and the state holds both moments."""
    p = torch.nn.Parameter(torch.ones(3, 2))
    opt, _, _ = t_optim.build_optimizer(
        t_config.TrainConfig(optimizer="lamb", weight_decay=0.01), [p])
    p.grad = torch.full((3, 2), 0.5)
    opt.step()
    assert isinstance(opt, t_optim.Lamb) and not torch.equal(p.detach(), torch.ones(3, 2))
    assert set(opt.state[p]) == {"step", "exp_avg", "exp_avg_sq"}


def _ported_packed_lm_rows() -> None:
    """``from_lm_texts(packed=True)`` (ROADMAP item 6, ported): the JAX rows."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import (
        ArrayDataset,
        WordHashTokenizer,
    )

    texts = ["a b c d e", "f g h", "i j k l m n o p"] * 3
    got = t_pipe.ArrayDataset.from_lm_texts(t_tok.WordHashTokenizer(64), texts, 8, packed=True)
    want = ArrayDataset.from_lm_texts(WordHashTokenizer(64), texts, 8, packed=True)
    for key, value in want.columns.items():
        np.testing.assert_array_equal(got.columns[key], np.asarray(value), err_msg=key)


def _ported_quant(family: str) -> None:
    """Int8 weight-only quantization (ROADMAP item 8, ported): the config
    builds a model whose denses on the family's JAX target regex are
    ``Int8Linear`` and only those, and ``quantize_for_generation`` on a
    BERT raises the JAX package's ``ValueError`` word for word."""
    import re
    from types import SimpleNamespace

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import quant as j_quant
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import bart as t_bart
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import gpt2 as t_gpt2
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import layers as t_layers
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import quant as t_quant
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import t5 as t_t5
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import init_bert
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.lora import (
        jax_param_paths,
    )

    model, targets = {
        "gpt2": lambda: (t_gpt2.Gpt2LMHeadModel(t_gpt2.Gpt2Config(
            vocab_size=64, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
            max_position_embeddings=16, weight_quant="int8")), j_quant.GPT2_QUANT_TARGETS),
        "t5": lambda: (t_t5.T5ForConditionalGeneration(t_t5.T5Config(
            vocab_size=64, d_model=16, d_kv=4, d_ff=32, num_layers=1, num_heads=4,
            feed_forward_proj="gated-gelu", tie_word_embeddings=False,
            weight_quant="int8")), j_quant.T5_QUANT_TARGETS),
        "bart": lambda: (t_bart.BartForConditionalGeneration(t_bart.BartConfig(
            vocab_size=64, d_model=16, encoder_layers=1, decoder_layers=1,
            encoder_attention_heads=2, decoder_attention_heads=2, encoder_ffn_dim=32,
            decoder_ffn_dim=32, max_position_embeddings=16, weight_quant="int8")),
            j_quant.BART_QUANT_TARGETS)}[family]()
    paths = list(jax_param_paths(model).values())
    int8 = [p[: -len("_q")] for p in paths if p.endswith("/kernel_q")]
    assert int8 and all(re.search(targets, p) for p in int8)
    assert not any(re.search(targets, p) for p in paths if p.endswith("/kernel"))
    enc = t_layers.EncoderConfig(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                                 intermediate_size=32, max_position_embeddings=16)
    with pytest.raises(ValueError) as got:
        t_quant.quantize_for_generation(init_bert(enc, device="cpu"))
    with pytest.raises(ValueError) as want:
        j_quant.quantize_for_generation(SimpleNamespace(config=enc), None)
    assert str(got.value) == str(want.value)


def _ported_decoding(which: str) -> None:
    """Decoding (ROADMAP item 8, ported): the call runs on a tiny T5 and
    returns what the JAX package returns on the same weights —
    ``[B, max_new_tokens]`` int32 in-vocab ids for sampling (the random
    streams differ), the same ids for beam search and for speculative
    decoding (the target's greedy ids)."""
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import generate as j_gen
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import generate as t_gen
    from torch_decode_pairs import seq2seq_pair

    jmodel, params, model = seq2seq_pair("t5", seed=0)
    src = np.random.RandomState(0).randint(3, 96, (2, 6)).astype(np.int32)
    if which == "sampling":
        got = t_gen.generate(model, src, max_new_tokens=5, temperature=1.0, top_k=20)
        want = np.asarray(j_gen.generate(jmodel, params, jnp.asarray(src), max_new_tokens=5,
                                         temperature=1.0, top_k=20))
        assert got.shape == want.shape and got.dtype == torch.int32
        assert bool(((got >= 0) & (got < 96)).all())
        return
    if which == "beam":
        got = t_gen.beam_search_generate(model, src, num_beams=3, max_new_tokens=5)
        want = j_gen.beam_search_generate(jmodel, params, jnp.asarray(src), num_beams=3,
                                          max_new_tokens=5)
    else:
        draft = seq2seq_pair("t5", num_layers=1, seed=1)[2]
        got = t_gen.generate_speculative_seq2seq(model, draft, src, max_new_tokens=5,
                                                 speculate_k=3)
        want = j_gen.generate(jmodel, params, jnp.asarray(src), max_new_tokens=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _int8_engine():
    """Int8 KV pools in the engine (ROADMAP item 10's piece, ported): the
    engine serves from int8 pools with fp32 scales, its tokens equal to
    ``generate_causal`` on the int8 dense cache of the same config."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import gpt2 as t_gpt2
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import init_gpt2
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.generate import (
        generate_causal,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import ServeEngine

    cfg = t_gpt2.Gpt2Config(vocab_size=64, max_position_embeddings=32, hidden_size=8,
                            num_layers=1, num_heads=1, intermediate_size=16,
                            kv_cache_dtype="int8")
    model = init_gpt2(cfg, device="cpu")
    engine = ServeEngine(model, num_slots=2, block_size=4, num_blocks=17, prefill_chunk=8,
                         max_model_len=32, device="cpu")
    assert engine.kv_cache_dtype == "int8"
    assert {p.dtype for p in engine.k_pools} == {torch.int8}
    prompt = np.arange(1, 8, dtype=np.int32)
    req = engine.submit(prompt, 6)
    engine.run()
    want = generate_causal(model, prompt[None], max_new_tokens=6)[0].tolist()
    eos = cfg.eos_token_id
    assert engine.output_ids(req).tolist() == (want[:want.index(eos) + 1] if eos in want
                                               else want)


@pytest.mark.parametrize("site", range(len(_raise_sites())),
                         ids=[s[0] for s in _raise_sites()])
def test_unported_raises_name_their_roadmap_item(site):
    """No raise names a slice letter any more: each names its ROADMAP
    queue 1 item. The sites of items 4, 6, 8 and 9, of item 10's int8 pools
    and of item 10's fleet flags, now ported, run instead (LAMB builds and
    steps, the remat policies build and an unknown one raises the JAX
    ``ValueError``, MoE configs
    build, the Llama family is detected and exports, beam search refuses
    experts with the JAX ValueError; a ported config
    builds and its invalid form raises the JAX ``ValueError``; the packed
    LM rows equal the JAX ones; an int8 config builds its ``Int8Linear``s;
    the decoders return the JAX package's ids; the int8 engine serves; the
    serving CLI serves with ``--replicas``, ``--placement``, ``--roles``,
    ``--arrival`` and ``--rate_limit``)."""
    _, call, item = _raise_sites()[site]
    if item is None:
        call()
        return
    with pytest.raises(NotImplementedError, match=rf"ROADMAP queue 1, item {item}\b") as err:
        call()
    assert "slice" not in str(err.value)
