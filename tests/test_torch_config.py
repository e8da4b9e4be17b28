"""PyTorch port: ``config.py`` against the JAX package's: the same argv
gives the same ``TrainConfig.to_dict()``, the same fields and defaults
and the same validation errors, while what the port does not run yet
raises ``NotImplementedError`` naming its ROADMAP queue 1 item (every flag still
in ``_check_ported``, and not the four lifecycle flags or the two data
flags the port runs: ``--streaming`` and ``--bucket_multiple`` parse as
the JAX package's do and reach the CLI's batcher)."""

import dataclasses

import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import config as t_config


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


# -- config ------------------------------------------------------------------

ARGVS = [
    [],
    ["--learning_rate", "3e-5", "--epochs", "2", "--do_eval", "false",
     "--max_train_samples", "100", "--dataset", "vendored_reviews", "--unknown", "x"],
    ["--warmup_ratio", "0.1", "--lr_schedule", "cosine", "--weight_decay", "0.01",
     "--max_grad_norm", "1.0", "--gradient_accumulation_steps", "2"],
    ["--attention_impl", "flash", "--dtype", "float32", "--eval_each_epoch", "true",
     "--rng_impl", "threefry", "--steps_per_epoch", "7", "--optimizer", "adam"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_parse_args_matches_jax(argv):
    from huggingface_sagemaker_tensorflow_distributed_tpu.config import parse_args

    assert t_config.parse_args(argv).to_dict() == parse_args(argv).to_dict()


def test_config_fields_and_defaults_match_jax():
    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig

    want = {f.name: f.type for f in dataclasses.fields(TrainConfig)}
    assert {f.name: f.type for f in dataclasses.fields(t_config.TrainConfig)} == want
    assert t_config.TrainConfig().to_dict() == TrainConfig().to_dict()


UNPORTED = [["--lora_rank", "4"], ["--num_experts", "4"],
            ["--tp", "2"], ["--pp", "2"], ["--fsdp", "2"], ["--sp", "2"],
            ["--dcn_dp", "2"],
            ["--optimizer", "lamb"], ["--optimizer_state_dtype", "bfloat16"],
            ["--remat", "true", "--remat_policy", "dots"],
            ["--attention_impl", "ring"],
            ["--packed_sequences", "true", "--task", "causal-lm"],
            ["--segment_packing", "true", "--task", "causal-lm"],
            ["--ep", "2", "--num_experts", "4"]]

# seq2seq, ported: these parse as the JAX package's do
SEQ2SEQ = [["--task", "seq2seq"], ["--fused_vocab_ce", "true", "--task", "seq2seq"],
           ["--optimizer", "adafactor"],
           ["--task", "seq2seq", "--label_smoothing", "0.1", "--eval_rouge_samples", "8"],
           ["--task", "seq2seq", "--span_corruption", "true", "--max_target_length", "114"]]

# the trainer's lifecycle, ported: these parse as the JAX package's do
LIFECYCLE = [["--checkpoint_dir", "/nonexistent/ckpt"], ["--keep_best", "true"],
             ["--early_stopping_patience", "2"], ["--profile", "true"]]


# ROADMAP items 6 (LoRA and packing), 9 (MoE) and 4 (LAMB, bf16 moments,
# the remat policies), now ported: these entries of UNPORTED now parse as
# the JAX package's do
ITEM6 = ("--lora_rank", "--packed_sequences", "--segment_packing", "--num_experts",
         "--optimizer", "--optimizer_state_dtype", "--remat",
         # item 11's first part: training over a dp x fsdp x tp mesh; its
         # step 1: the seq axis and ring attention
         "--tp", "--fsdp", "--sp", "--attention_impl")


@pytest.mark.parametrize("argv", UNPORTED, ids=lambda a: a[1] if a[0] == "--optimizer" else a[0])
def test_unported_flags_raise(argv):
    if argv[0] in ITEM6:
        from huggingface_sagemaker_tensorflow_distributed_tpu.config import parse_args

        assert t_config.parse_args(argv).to_dict() == parse_args(argv).to_dict()
        return
    with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1, item \d+ \("):
        t_config.parse_args(argv)


@pytest.mark.parametrize("argv", SEQ2SEQ, ids=["task", "fused", "adafactor", "smoothing",
                                                 "span_corruption"])
def test_seq2seq_flags_are_ported(argv):
    from huggingface_sagemaker_tensorflow_distributed_tpu.config import parse_args

    assert t_config.parse_args(argv).to_dict() == parse_args(argv).to_dict()


@pytest.mark.parametrize("argv", LIFECYCLE, ids=lambda a: a[0])
def test_lifecycle_flags_are_ported(argv):
    from huggingface_sagemaker_tensorflow_distributed_tpu.config import parse_args

    assert t_config.parse_args(argv).to_dict() == parse_args(argv).to_dict()


DATA_FLAGS = [["--streaming", "true"], ["--bucket_multiple", "128"]]


@pytest.mark.parametrize("argv", DATA_FLAGS, ids=lambda a: a[0])
def test_data_flags_are_ported_and_reach_the_batcher(argv, tmp_path, monkeypatch):
    """The flags parse as the JAX package's do, ``bucket_sizes`` is the
    JAX schedule, and a CPU run of the CLI hands its train batcher a
    streaming dataset, or the bucket widths."""
    import json

    from huggingface_sagemaker_tensorflow_distributed_tpu.config import parse_args

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.sources import (
        VENDORED_REVIEWS,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.streaming import (
        StreamingTextDataset,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli

    cfg = t_config.parse_args(argv)
    assert cfg.to_dict() == parse_args(argv).to_dict()
    for max_len in (64, 256, 512):
        assert cfg.bucket_sizes(max_len) == parse_args(argv).bucket_sizes(max_len)
    made = []

    class Recorded(cli.ShardedBatcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(cli, "ShardedBatcher", Recorded)
    (tmp_path / "cfg").mkdir()
    (tmp_path / "cfg" / "config.json").write_text(json.dumps({
        "model_type": "bert", "vocab_size": 512, "hidden_size": 32,
        "num_hidden_layers": 1, "num_attention_heads": 2, "intermediate_size": 64,
        "max_position_embeddings": 256}))
    cli.run(argv + ["--model_name_or_path", str(tmp_path / "cfg"), "--from_scratch", "true",
                    "--dataset", "vendored_reviews", "--dataset_path", str(VENDORED_REVIEWS),
                    "--max_train_samples", "16", "--max_eval_samples", "4", "--epochs", "1",
                    "--steps_per_epoch", "2", "--dtype", "float32", "--max_seq_length", "256",
                    "--output_data_dir", str(tmp_path / "out"),
                    "--model_dir", str(tmp_path / "model"), "--device", "cpu"])
    train, evaluation = made
    if argv[0] == "--streaming":
        assert isinstance(train.dataset, StreamingTextDataset) and train.bucket_sizes is None
        assert not isinstance(evaluation.dataset, StreamingTextDataset)
    else:
        assert train.bucket_sizes == evaluation.bucket_sizes == [128, 256]
        assert not isinstance(train.dataset, StreamingTextDataset)


@pytest.mark.parametrize("argv", [["--task", "bogus"], ["--learning_rate", "-1"],
                                  ["--lr_schedule", "cosine"], ["--optimizer", "adam",
                                                                "--weight_decay", "0.1"]])
def test_validation_errors_match_jax(argv):
    from huggingface_sagemaker_tensorflow_distributed_tpu.config import parse_args

    with pytest.raises(ValueError):
        parse_args(argv)
    with pytest.raises(ValueError):
        t_config.parse_args(argv)


def test_resolve_attention_impl():
    cfg = t_config.TrainConfig()
    assert cfg.resolve_attention_impl("cuda") == "flash"
    assert cfg.resolve_attention_impl("cpu") == "xla"
    assert t_config.TrainConfig(attention_impl="xla").resolve_attention_impl("cuda") == "xla"
