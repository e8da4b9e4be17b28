"""PyTorch port: the token-cls and extractive-QA tasks against the JAX
package: the losses' sums (``train/trainer.py``: ``token_cls_loss`` with
its micro-F1 counts, ``qa_loss``), ``Trainer.evaluate``'s ``eval_f1``,
5-step fp32 fits of RoBERTa token-cls, BERT QA over doc-stride windows
and DistilBERT seq-cls (and RoBERTa token-cls under length bucketing)
beside the JAX ``Trainer``, the datasets (``data/sources.py`` generators
and jsonl branches, ``ArrayDataset.from_token_classification`` and
``from_qa`` with the word-hash and the WordPiece tokenizers), and the
training CLI's token-cls and QA runs (results keys, the ``--num_labels``
check, QA's answer EM/F1 over windows).

Tolerances: loss sums 1e-6 relative, the counts exact; 5-step loss curves
1e-5 relative (fp32; the two frameworks sum in other orders); columns and
EM/F1 exact."""

import json
import math

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import config as t_config
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import pipeline as t_pipe
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import sources as t_src
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import tokenization as t_tok
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import wordpiece as t_wp
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto as t_auto
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
    params_from_jax,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import trainer as t_trainer
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.results import (
    read_results_file,
)

SEQ = 32
VOCAB = 512
HF = {
    "bert": {"model_type": "bert", "vocab_size": VOCAB, "hidden_size": 64,
             "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 128,
             "max_position_embeddings": 64, "hidden_dropout_prob": 0.0,
             "attention_probs_dropout_prob": 0.0},
    "roberta": {"model_type": "roberta", "vocab_size": VOCAB, "hidden_size": 64,
                "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 128,
                "max_position_embeddings": 66, "type_vocab_size": 1, "pad_token_id": 1,
                "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0},
    "distilbert": {"model_type": "distilbert", "vocab_size": VOCAB, "dim": 64, "n_layers": 2,
                   "n_heads": 2, "hidden_dim": 128, "max_position_embeddings": 64,
                   "dropout": 0.0, "attention_dropout": 0.0},
    "electra": {"model_type": "electra", "vocab_size": VOCAB, "hidden_size": 64,
                "embedding_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
                "intermediate_size": 128, "max_position_embeddings": 64,
                "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0},
    "albert": {"model_type": "albert", "vocab_size": VOCAB, "hidden_size": 64,
               "embedding_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
               "intermediate_size": 128, "max_position_embeddings": 64,
               "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
               "classifier_dropout_prob": 0.0},
}
NUM_LABELS = 4   # the synthetic NER's O/PER/LOC/ORG


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


def _model_dir(path, family):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(HF[family]))
    return str(path)


def _pair(tmp_path, family, task, seed=0):
    """(JAX model, JAX params, port model) on the same weights."""
    from flax.traverse_util import flatten_dict

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import auto as j_auto

    path = _model_dir(tmp_path / f"{family}-{task}", family)
    jmodel, params, _, _ = j_auto.from_pretrained(path, task=task, num_labels=NUM_LABELS,
                                                  seed=seed)
    model, _, _ = t_auto.from_pretrained(path, task=task, num_labels=NUM_LABELS,
                                         device="cpu")
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    model.load_state_dict(params_from_jax(flat), strict=True)
    return jmodel, params, model


def _ner(n, seed, tok=None, max_len=SEQ):
    sents, tags = t_src.synthetic_token_classification(n, seed=seed)
    tok = tok or t_tok.WordHashTokenizer(VOCAB)
    return t_pipe.ArrayDataset.from_token_classification(tok, sents, tags, max_len)


def _qa(n, seed, doc_stride=8, tok=None, max_len=SEQ):
    q, c, s, a = t_src.synthetic_qa(n, seed=seed)
    tok = tok or t_tok.WordHashTokenizer(VOCAB)
    return t_pipe.ArrayDataset.from_qa(tok, q, c, s, a, max_len, doc_stride=doc_stride)


def _seq(n, seed):
    texts, labels = t_src.synthetic_text_classification(n, seed=seed)
    return t_pipe.ArrayDataset.from_texts(t_tok.WordHashTokenizer(VOCAB), texts, labels, SEQ)


def _to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() if k != "valid"
            else torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax_batch(batch):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in batch.items()}


# -- the losses ----------------------------------------------------------------

# RoBERTa QA: the word-hash QA rows carry token type 1, past RoBERTa's one
LOSS_CASES = [("roberta", "token-cls"), ("albert", "token-cls"), ("distilbert", "token-cls"),
              ("bert", "qa"), ("electra", "qa"), ("albert", "qa"), ("roberta", "qa")]


@pytest.mark.parametrize("family,task", LOSS_CASES, ids=[f"{f}-{t}" for f, t in LOSS_CASES])
def test_loss_sums_match_jax(tmp_path, family, task):
    """``token_cls_loss`` (with its F1 counts) and ``qa_loss``: the same
    sums as the JAX losses on a batch with padded rows and an invalid
    row."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.train import trainer as j_trainer

    jmodel, params, model = _pair(tmp_path, family, task)
    ds = _ner(8, seed=3) if task == "token-cls" else _qa(6, seed=3)
    batch = dict(ds[np.arange(4)])
    batch["valid"] = np.array([1, 1, 1, 0], np.int32)
    j_fn = {"token-cls": j_trainer.token_cls_loss, "qa": j_trainer.qa_loss}[task]
    p_fn = t_trainer.TASK_LOSSES[task]
    _, want = j_fn(jmodel.apply, params, _jax_batch(batch), None, False)
    with torch.no_grad():
        _, got = p_fn(model.eval(), _to_torch(batch))
    assert set(got) == set(want)
    for key, w in want.items():
        w = float(w)
        if key == "loss_sum":
            assert float(got[key]) == pytest.approx(w, rel=1e-6), key
        else:
            assert float(got[key]) == w, key
    if task == "token-cls":
        assert want["count"] > 0 and float(want["f1_tp"]) + float(want["f1_fn"]) > 0


# -- five-step fits -------------------------------------------------------------

FIT_CASES = [("roberta", "token-cls", None), ("bert", "qa", None),
             ("distilbert", "seq-cls", None), ("roberta", "token-cls", 8)]


@pytest.mark.parametrize("family,task,bucket", FIT_CASES,
                         ids=["roberta-token-cls", "bert-qa-doc-stride", "distilbert-seq-cls",
                              "roberta-token-cls-bucketed"])
def test_five_fp32_steps_match_jax_trainer(tmp_path, family, task, bucket):
    """Same weights, same batches, AdamW with decay and clipping: the
    port's loss curve is the JAX Trainer's. The QA rows are doc-stride
    windows (contexts of 30-80 words in rows of 32); the bucketed run
    feeds batches cut to multiples of 8."""
    import jax

    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.train import Trainer as JaxTrainer

    kw = dict(task=task, num_labels=NUM_LABELS, epochs=1, dtype="float32",
              learning_rate=1e-3, scale_lr_by_world_size=False, weight_decay=0.01,
              max_grad_norm=1.0, log_every_steps=0, qa_doc_stride=8 if task == "qa" else 0,
              bucket_multiple=bucket or 0)
    jmodel, params, model = _pair(tmp_path, family, task)
    ds = {"token-cls": lambda: _ner(48, seed=1), "qa": lambda: _qa(12, seed=1),
          "seq-cls": lambda: _seq(48, seed=1)}[task]()
    if task == "qa":
        assert len(ds) > 24 and (ds.columns["start_positions"] == 0).any()
    batcher = t_pipe.ShardedBatcher(ds, 8, seed=0, native=False,
                                    bucket_sizes=t_config.TrainConfig(**kw).bucket_sizes(SEQ))
    batches = list(batcher.local_batches(0))[:5]
    if bucket:
        assert len({b["input_ids"].shape[1] for b in batches}) > 1
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jtrainer = JaxTrainer(TrainConfig(**kw), jmodel, params, mesh, total_steps=5)
    trainer = t_trainer.Trainer(t_config.TrainConfig(**kw), model, total_steps=5)
    want, got = [], []
    for b in batches:
        jtrainer.state, m = jtrainer._train_step(jtrainer.state, _jax_batch(b))
        want.append(float(jax.device_get(m["loss"])))
        got.append(trainer.train_step(_to_torch(b))["loss"].item())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert trainer.updates == 5 and len(set(np.round(want, 6))) == 5


def test_evaluate_eval_f1_matches_jax(tmp_path):
    """``Trainer.evaluate`` on token-cls: eval loss, accuracy and the
    micro-F1 over the non-O tags equal the JAX Trainer's over the same
    padded eval batches."""
    import jax

    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import (
        ArrayDataset,
        ShardedBatcher,
        WordHashTokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.parallel import (
        MeshConfig,
        build_mesh,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.train import Trainer as JaxTrainer

    jmodel, params, model = _pair(tmp_path, "electra", "token-cls", seed=2)
    kw = dict(task="token-cls", num_labels=NUM_LABELS, dtype="float32")
    got = t_trainer.Trainer(t_config.TrainConfig(**kw), model).evaluate(
        t_pipe.ShardedBatcher(_ner(10, seed=6), 4, shuffle=False, drop_remainder=False))
    sents, tags = t_src.synthetic_token_classification(10, seed=6)
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    want = JaxTrainer(TrainConfig(**kw), jmodel, params, mesh).evaluate(ShardedBatcher(
        ArrayDataset.from_token_classification(WordHashTokenizer(VOCAB), sents, tags, SEQ),
        4, mesh, shuffle=False, drop_remainder=False))
    assert list(got) == list(want) == ["eval_loss", "eval_accuracy", "eval_f1"]
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=1e-5)
    assert got["eval_accuracy"] == pytest.approx(want["eval_accuracy"], abs=1e-12)
    assert got["eval_f1"] == pytest.approx(want["eval_f1"], abs=1e-12)


# -- datasets ---------------------------------------------------------------------

def _vocab():
    question = {"which", "person", "place", "company", "mentioned", "here"}
    words = sorted(set(t_src._NOISE_WORDS) | question
                   | {w for ws in t_src._ENTITY_WORDS.values() for w in ws[:4]})
    chars = sorted({c for w in words for c in w} | set("?"))
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words + chars + \
        ["##" + c for c in chars]
    return {t: i for i, t in enumerate(toks)}


@pytest.mark.parametrize("tokenizer", ["word_hash", "wordpiece"])
@pytest.mark.parametrize("max_len,doc_stride", [(24, 0), (24, 8), (64, 16)])
def test_task_datasets_equal_jax(tokenizer, max_len, doc_stride):
    """``from_token_classification`` (first subword labelled, -100
    elsewhere) and ``from_qa`` (windows labelled with their answer or
    with CLS) give the JAX package's columns exactly; the WordPiece vocab
    leaves two entity words per class to split into characters."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import pipeline as j_pipe
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import sources as j_src
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.tokenization import (
        WordHashTokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.data.wordpiece import (
        WordPieceTokenizer,
    )

    if tokenizer == "word_hash":
        ours, theirs = t_tok.WordHashTokenizer(VOCAB), WordHashTokenizer(VOCAB)
    else:
        ours, theirs = t_wp.WordPieceTokenizer(_vocab()), WordPieceTokenizer(_vocab())
    sents, tags = j_src.synthetic_token_classification(20, seed=9)
    got = t_pipe.ArrayDataset.from_token_classification(ours, sents, tags, max_len)
    want = j_pipe.ArrayDataset.from_token_classification(theirs, sents, tags, max_len)
    assert list(got.columns) == list(want.columns) == ["input_ids", "attention_mask", "labels"]
    for key in want.columns:
        np.testing.assert_array_equal(got.columns[key], np.asarray(want.columns[key]), key)
    labels = got.columns["labels"]
    assert (labels[got.columns["attention_mask"] == 0] == -100).all()
    assert (labels[:, 0] == -100).all() and (labels >= 0).sum() > 0

    q, c, s, a = j_src.synthetic_qa(12, seed=9)
    got = t_pipe.ArrayDataset.from_qa(ours, q, c, s, a, max_len, doc_stride=doc_stride)
    want = j_pipe.ArrayDataset.from_qa(theirs, q, c, s, a, max_len, doc_stride=doc_stride)
    assert list(got.columns) == list(want.columns)
    assert "example_ids" not in got.columns
    for key in want.columns:
        np.testing.assert_array_equal(got.columns[key], np.asarray(want.columns[key]), key)
    if doc_stride and max_len < 64:
        assert len(got) > 12 and (got.columns["start_positions"] == 0).any()


def test_sources_equal_jax(tmp_path):
    """The synthetic NER and QA generators draw the JAX package's data;
    the jsonl branches read the same records; unknown names raise."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.data import sources as j_src

    for split in ("train", "test"):
        assert t_src.load_token_classification("synthetic", split, max_samples=30, seed=4) == \
            j_src.load_token_classification("synthetic", split, max_samples=30, seed=4)
        assert t_src.load_qa("synthetic", split, max_samples=30, seed=4) == \
            j_src.load_qa("synthetic", split, max_samples=30, seed=4)
    assert t_src.synthetic_token_classification(50, seed=1) == \
        j_src.synthetic_token_classification(50, seed=1)
    assert t_src.synthetic_qa(50, seed=1) == j_src.synthetic_qa(50, seed=1)
    sents, tags = t_src.synthetic_token_classification(5, seed=2)
    q, c, s, a = t_src.synthetic_qa(5, seed=2)
    (tmp_path / "ner").mkdir()
    (tmp_path / "qa").mkdir()
    with open(tmp_path / "ner" / "train.jsonl", "w") as f:
        for w, t in zip(sents, tags):
            f.write(json.dumps({"tokens": w, "tags": t}) + "\n")
    with open(tmp_path / "qa" / "train.jsonl", "w") as f:
        for row in zip(q, c, s, a):
            f.write(json.dumps(dict(zip(("question", "context", "answer_start", "answer"),
                                        row))) + "\n")
    for mod in (t_src, j_src):
        assert mod.load_token_classification("local", "train", str(tmp_path / "ner"),
                                             max_samples=4) == (sents[:4], tags[:4])
        assert mod.load_qa("local", "train", str(tmp_path / "qa"), max_samples=4) == \
            (q[:4], c[:4], s[:4], a[:4])
    with pytest.raises(ValueError, match="unknown token-cls"):
        t_src.load_token_classification("nope", "train")
    with pytest.raises(ValueError, match="unknown qa"):
        t_src.load_qa("nope", "train")


# -- the CLI ---------------------------------------------------------------------

def _cli_args(model_dir, task, extra=()):
    return ["--model_name_or_path", model_dir, "--from_scratch", "true", "--task", task,
            "--dataset", "synthetic", "--max_train_samples", "24", "--max_eval_samples", "8",
            "--epochs", "1", "--train_batch_size", "4", "--eval_batch_size", "4",
            "--dtype", "float32", "--log_every_steps", "0", "--max_seq_length", str(SEQ),
            *extra]


@pytest.mark.parametrize("family,task,extra", [
    ("roberta", "token-cls", ["--num_labels", "9", "--bucket_multiple", "8"]),
    ("bert", "qa", ["--qa_doc_stride", "8", "--eval_qa_samples", "6"])],
    ids=["roberta-token-cls", "bert-qa"])
def test_cli_on_cpu_writes_the_jax_cli_files(tmp_path, family, task, extra):
    """The port's CLI and the JAX CLI on the same argv write results
    files with the same keys (token-cls adds ``eval_f1``, QA
    ``eval_exact_match`` and ``eval_f1``) and the same export files."""
    from scripts.train import main as jax_main

    model_dir = _model_dir(tmp_path / "cfg", family)
    outs = {}
    for name, run in (("port", lambda a: cli.main(a + ["--device", "cpu"])),
                      ("jax", jax_main)):
        out, mdir = tmp_path / name / "out", tmp_path / name / "model"
        res = run(_cli_args(model_dir, task, extra)
                  + ["--output_data_dir", str(out), "--model_dir", str(mdir)])
        outs[name] = (out, mdir, res)
    for fname in ("train_results.txt", "eval_results.txt"):
        got = read_results_file(str(outs["port"][0] / fname))
        want = read_results_file(str(outs["jax"][0] / fname))
        assert list(got) == list(want), fname
    assert sorted(p.name for p in outs["port"][1].iterdir()) == \
        sorted(p.name for p in outs["jax"][1].iterdir())
    ev = outs["port"][2]["eval"]
    assert "eval_f1" in ev and all(math.isfinite(v) for v in ev.values())
    reloaded, fam, _ = t_auto.from_pretrained(str(outs["port"][1]), task=task,
                                              num_labels=9, device="cpu")
    assert fam == family


def test_cli_checks_num_labels(tmp_path):
    """Token-cls tags past ``--num_labels`` fail at data-build time, as in
    the JAX CLI."""
    model_dir = _model_dir(tmp_path / "cfg", "bert")
    with pytest.raises(ValueError, match="--num_labels 4"):
        cli.main(_cli_args(model_dir, "token-cls", ["--num_labels", "3"])
                 + ["--device", "cpu", "--output_data_dir", str(tmp_path / "o"),
                    "--model_dir", str(tmp_path / "m")])


@pytest.mark.parametrize("family,doc_stride", [("bert", 8), ("albert", 0)])
def test_qa_answer_metrics_match_jax(tmp_path, family, doc_stride):
    """The CLI's QA eval (``qa_answer_metrics``: windows through the
    model, spans decoded from offsets, the best window per example,
    SQuAD EM/F1) gives the JAX CLI's numbers on the same weights."""
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.data.tokenization import (
        WordHashTokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu.utils.metrics import (
        best_windowed_answers,
        extract_answer_spans,
        squad_em_f1,
    )

    jmodel, params, model = _pair(tmp_path, family, "qa", seed=5)
    cfg = t_config.TrainConfig(task="qa", dataset="synthetic", eval_qa_samples=10,
                               qa_doc_stride=doc_stride, seed=3)
    got = cli.qa_answer_metrics(cfg, model, t_tok.WordHashTokenizer(VOCAB), SEQ, 4,
                                torch.device("cpu"))
    q, c, s, a = t_src.load_qa("synthetic", "test", max_samples=10, seed=3)
    enc = WordHashTokenizer(VOCAB).encode_qa(q, c, s, a, max_length=SEQ, return_offsets=True,
                                             doc_stride=doc_stride)
    s_log, e_log = jmodel.apply({"params": params}, jnp.asarray(enc["input_ids"]),
                                jnp.asarray(enc["attention_mask"]),
                                token_type_ids=jnp.asarray(enc["token_type_ids"]))
    ctx = np.asarray(c)[enc["example_ids"]]
    ts = extract_answer_spans(s_log, e_log, enc["offset_starts"], enc["offset_ends"], ctx,
                              with_scores=True)
    preds = best_windowed_answers([t for t, _ in ts], [x for _, x in ts],
                                  enc["example_ids"], len(q))
    want = squad_em_f1(preds, a)
    assert got["eval_qa_windows"] == len(enc["input_ids"])
    assert (got["eval_exact_match"], got["eval_f1"]) == (want["exact_match"], want["f1"])
