"""Typed configuration: hyperparameters, environment contract, CLI
(counterpart of the JAX package's ``config.py``).

``TrainConfig`` has the JAX package's fields, defaults and validation,
and :func:`parse_args` gives the same ``to_dict()`` for the same argv
(``--key value`` strings with typed coercion; unknown arguments are
ignored). The output directories default from the same environment
variables (``TPU_OUTPUT_DATA_DIR``/``SM_OUTPUT_DATA_DIR``,
``TPU_MODEL_DIR``/``SM_MODEL_DIR``).

What the port does not run yet raises ``NotImplementedError`` naming the
ROADMAP queue 1 item that ports it, instead of being ignored. Two fields name
JAX machinery and select nothing in the port: ``rng_impl`` (dropout uses
PyTorch's generator) and ``compilation_cache_dir`` (there is no XLA
compile to cache); they are validated and kept for argv parity.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field, fields
from typing import Optional

LORA_HEAD_REGEX_DEFAULT = r"(classifier|qa_outputs|pooler)"


def _parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("true", "1", "yes", "y"):
        return True
    if s in ("false", "0", "no", "n", ""):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def _env(*names: str, default: Optional[str] = None) -> Optional[str]:
    for name in names:
        if name in os.environ:
            return os.environ[name]
    return default


@dataclass
class TrainConfig:
    """All knobs for a fine-tuning job (the JAX package's fields)."""

    # --- model / task ---
    model_name_or_path: str = "bert-base-uncased"
    task: str = "seq-cls"
    num_labels: int = 2
    max_seq_length: int = 512
    max_target_length: int = 64
    span_corruption: bool = False
    eval_rouge_samples: int = 0
    eval_qa_samples: int = 0
    fused_mlm_mask_cap: float = 0.25
    mlm_static_masking: bool = False
    packed_sequences: bool = False
    segment_packing: bool = False
    from_scratch: bool = False

    # --- data ---
    dataset: str = "imdb"
    dataset_path: Optional[str] = None
    streaming: bool = False
    max_train_samples: Optional[int] = None
    max_eval_samples: Optional[int] = None

    # --- optimization ---
    epochs: int = 3
    train_batch_size: int = 8          # per worker
    eval_batch_size: int = 4
    learning_rate: float = 5e-5
    scale_lr_by_world_size: bool = True
    optimizer: str = "adamw"           # adamw | adam | adafactor | lamb
    optimizer_state_dtype: str = "float32"
    lr_schedule: str = "linear"        # linear | cosine (with warmup_ratio > 0)
    warmup_ratio: float = 0.0
    weight_decay: float = 0.0
    max_grad_norm: float = 0.0         # 0 disables clipping
    label_smoothing: float = 0.0
    gradient_accumulation_steps: int = 1
    steps_per_epoch: Optional[int] = None
    seed: int = 42
    rng_impl: str = "rbg"

    # --- precision ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # --- parallelism ---
    dp: int = -1
    fsdp: int = 1
    ep: int = 1
    pp: int = 1
    tp: int = 1
    sp: int = 1
    dcn_dp: int = 1
    pipeline_microbatches: int = 0

    # --- Mixture-of-Experts ---
    num_experts: int = 0
    expert_top_k: int = 2
    moe_every: int = 2

    # --- kernels / memory ---
    attention_impl: str = "auto"       # auto | xla | flash | ring
    remat: bool = False
    remat_policy: str = "full"         # full | dots | dots_no_batch
    fused_vocab_ce: bool = False

    qa_doc_stride: int = 0

    # --- LoRA ---
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: str = "attention"
    lora_train_heads: str = LORA_HEAD_REGEX_DEFAULT

    bucket_multiple: int = 0

    # --- control flags ---
    do_train: bool = True
    do_eval: bool = True
    eval_each_epoch: bool = False
    keep_best: bool = False
    best_metric: str = "eval_loss"     # eval_loss | eval_accuracy
    early_stopping_patience: int = 0

    # --- checkpoint / resume ---
    checkpoint_dir: Optional[str] = None
    checkpoint_every_steps: int = 0
    resume: bool = True
    keep_checkpoints: int = 3
    async_checkpointing: bool = True

    check_divergence: bool = True
    divergence_tol: float = 1e-6

    # --- output contract ---
    num_chips: Optional[int] = field(
        default_factory=lambda: (
            int(v) if (v := _env("TPU_NUM_CHIPS", "SM_NUM_GPUS",
                                 default="")).isdigit() else None)
    )
    output_data_dir: str = field(
        default_factory=lambda: _env("TPU_OUTPUT_DATA_DIR", "SM_OUTPUT_DATA_DIR",
                                     default="/tmp/output"))
    model_dir: str = field(
        default_factory=lambda: _env("TPU_MODEL_DIR", "SM_MODEL_DIR", default="/tmp/model"))

    compilation_cache_dir: str = field(
        default_factory=lambda: _env(
            "HSTD_COMPILE_CACHE_DIR", "TPU_COMPILATION_CACHE_DIR",
            default=os.path.join(os.path.expanduser("~"), ".cache", "hstd-xla")))

    # --- observability ---
    log_every_steps: int = 10
    profile: bool = False
    profile_dir: str = "/tmp/profile"
    log_all_hosts: bool = False

    def __post_init__(self):
        self._validate()
        self._check_ported()

    def _validate(self):
        """The JAX package's validation, check for check."""
        if self.task not in ("seq-cls", "token-cls", "qa", "seq2seq",
                             "causal-lm", "mlm", "rtd"):
            raise ValueError(f"unknown task {self.task!r}")
        if self.dtype not in ("bfloat16", "float32", "float16"):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if self.rng_impl == "threefry":
            self.rng_impl = "threefry2x32"
        if self.rng_impl not in ("rbg", "threefry2x32"):
            raise ValueError(f"unknown rng_impl {self.rng_impl!r}")
        if self.epochs < 0 or self.train_batch_size <= 0 or self.eval_batch_size <= 0:
            raise ValueError("epochs must be >= 0 and batch sizes positive")
        if self.gradient_accumulation_steps < 1:
            raise ValueError("gradient_accumulation_steps must be >= 1")
        if self.learning_rate <= 0:
            raise ValueError("learning_rate must be positive")
        if self.optimizer not in ("adamw", "adam", "adafactor", "lamb"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.optimizer_state_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unknown optimizer_state_dtype {self.optimizer_state_dtype!r}")
        if (self.optimizer_state_dtype == "bfloat16"
                and self.optimizer not in ("adam", "adamw")):
            raise ValueError(
                "optimizer_state_dtype='bfloat16' supports adam/adamw only "
                "(adafactor is already sublinear-memory; lamb's trust "
                "ratio is untested with quantized moments)")
        if self.packed_sequences and self.task != "causal-lm":
            raise ValueError(
                "packed_sequences is a causal-lm pretraining layout "
                "(EOS-joined documents chunked into full rows); other "
                "tasks need per-example boundaries")
        if self.packed_sequences and self.streaming:
            raise ValueError(
                "packed_sequences does not combine with --streaming "
                "(the streaming tier tokenizes rows independently; "
                "packing needs the whole token stream) — pick one")
        if self.segment_packing and self.task not in ("causal-lm", "mlm"):
            raise ValueError(
                "segment_packing packs token-level examples behind "
                "segment ids (causal-lm / mlm); per-example-label tasks "
                f"cannot pack (got task={self.task!r})")
        if self.segment_packing and self.packed_sequences:
            raise ValueError(
                "segment_packing and packed_sequences are alternative "
                "packing layouts (per-example boundaries vs EOS-joined "
                "stream) — pick one")
        if self.segment_packing and self.streaming:
            raise ValueError(
                "segment_packing does not combine with --streaming "
                "(packing re-groups rows at build time; the streaming "
                "tier tokenizes per batch) — pick one")
        if self.segment_packing and self.bucket_multiple:
            raise ValueError(
                "segment_packing already eliminates pad waste; "
                "bucket_multiple would re-fragment packed rows — pick one")
        if self.streaming and self.span_corruption:
            raise ValueError("--streaming does not implement span corruption")
        if self.optimizer == "adafactor" and self.weight_decay > 0:
            raise ValueError("weight_decay with adafactor is not supported; "
                             "use adamw or lamb")
        if self.optimizer == "adam" and self.weight_decay > 0:
            raise ValueError("optimizer='adam' is plain coupled Adam and "
                             "ignores weight_decay; use adamw")
        if self.lr_schedule not in ("linear", "cosine"):
            raise ValueError(f"unknown lr_schedule {self.lr_schedule!r}")
        if self.lr_schedule == "cosine" and self.warmup_ratio <= 0:
            raise ValueError("lr_schedule='cosine' needs warmup_ratio > 0")
        for ax in ("fsdp", "ep", "pp", "tp", "sp", "dcn_dp"):
            if getattr(self, ax) <= 0:
                raise ValueError(f"mesh axis {ax} must be positive")
        if self.pipeline_microbatches < 0:
            raise ValueError("pipeline_microbatches must be >= 0")
        if self.pp > 1 and self.num_experts:
            raise ValueError("pp > 1 cannot combine with num_experts (MoE)")
        if self.num_experts < 0 or self.expert_top_k < 1 or self.moe_every < 1:
            raise ValueError("num_experts >= 0, expert_top_k >= 1, moe_every >= 1")
        if self.ep > 1 and self.num_experts == 0:
            raise ValueError("ep > 1 requires num_experts > 0 (MoE model)")
        if not 0.0 <= self.label_smoothing < 1.0:
            raise ValueError("label_smoothing must be in [0, 1)")
        if self.label_smoothing > 0 and self.task != "seq2seq":
            raise ValueError("label_smoothing is implemented for task='seq2seq'")
        if self.best_metric not in ("eval_loss", "eval_accuracy"):
            raise ValueError(f"unknown best_metric {self.best_metric!r}")
        if self.early_stopping_patience < 0:
            raise ValueError("early_stopping_patience must be >= 0")
        if self.early_stopping_patience > 0:
            self.eval_each_epoch = True
        if self.keep_best and not self.do_eval:
            raise ValueError("keep_best needs do_eval=true")
        if self.early_stopping_patience > 0 and not self.do_eval:
            raise ValueError("early_stopping_patience needs do_eval=true")
        if self.keep_best:
            self.eval_each_epoch = True
        if self.remat_policy not in ("full", "dots", "dots_no_batch"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")
        if self.qa_doc_stride < 0:
            raise ValueError("qa_doc_stride must be >= 0 (0 disables)")
        if 0 < self.max_seq_length - 3 <= self.qa_doc_stride:
            raise ValueError(f"qa_doc_stride={self.qa_doc_stride} >= "
                             f"max_seq_length-3={self.max_seq_length - 3}")
        if self.lora_rank < 0:
            raise ValueError("lora_rank must be >= 0 (0 disables LoRA)")
        if self.lora_rank > 0 and self.lora_alpha <= 0:
            raise ValueError("lora_alpha must be positive")
        if self.num_experts and self.num_experts % self.ep:
            raise ValueError(
                f"num_experts={self.num_experts} must divide over ep={self.ep}")
        if self.num_experts and self.expert_top_k > self.num_experts:
            raise ValueError("expert_top_k cannot exceed num_experts")
        if self.bucket_multiple < 0:
            raise ValueError("bucket_multiple must be >= 0")
        if self.bucket_multiple and self.sp > 1 and self.bucket_multiple % self.sp:
            raise ValueError("bucket_multiple must divide evenly over sp shards")
        if self.attention_impl not in ("auto", "xla", "flash", "ring"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        if self.attention_impl == "flash" and self.sp > 1:
            raise ValueError(
                "attention_impl='flash' cannot run over a sequence-sharded "
                "axis (sp>1); use 'ring' or 'auto'")

    def _check_ported(self):
        """Raise for what the port does not run yet (never ignore it)."""
        # fsdp, sp and tp train over the mesh (parallel/sharding.py,
        # parallel/ring_attention.py)
        for ax in ("pp", "ep", "dcn_dp"):
            if getattr(self, ax) > 1:
                raise NotImplementedError(
                    f"{ax}>1 is not ported to the PyTorch package yet: "
                    "ROADMAP queue 1, item 11 (parallelism beyond DP)")

    def resolve_attention_impl(self, device_type: str) -> str:
        """A ``seq`` mesh axis (``sp > 1``) forces ring attention, ``auto``
        included (the plain and flash paths would attend within a shard
        only); otherwise ``auto`` picks the flash kernels on ``cuda`` and
        the plain (``xla``) path elsewhere, and an explicit choice
        stands."""
        if self.sp > 1:
            return "ring"
        if self.attention_impl != "auto":
            return self.attention_impl
        return "flash" if device_type == "cuda" else "xla"

    def bucket_sizes(self, max_len: int) -> Optional[list[int]]:
        """The length-bucket widths ``bucket_multiple`` implies: its
        multiples up to ``max_len``; None when bucketing is off."""
        if not self.bucket_multiple:
            return None
        return list(range(self.bucket_multiple, max_len + 1, self.bucket_multiple))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def _add_field_arg(parser: argparse.ArgumentParser, f: dataclasses.Field) -> None:
    name = "--" + f.name
    if f.type in ("bool", bool):
        parser.add_argument(name, type=_parse_bool, default=None)
    elif f.type in ("int", int, "Optional[int]"):
        parser.add_argument(name, type=int, default=None)
    elif f.type in ("float", float):
        parser.add_argument(name, type=float, default=None)
    else:
        parser.add_argument(name, type=str, default=None)


def parse_args(argv: Optional[list[str]] = None) -> TrainConfig:
    """Build a TrainConfig from ``--key value`` arguments layered over the
    environment and the defaults; every value is coerced to its field's
    type, unknown arguments are ignored."""
    parser = argparse.ArgumentParser(allow_abbrev=False)
    for f in fields(TrainConfig):
        _add_field_arg(parser, f)
    ns, _unknown = parser.parse_known_args(argv)
    overrides = {k: v for k, v in vars(ns).items() if v is not None}
    merged = {**TrainConfig().to_dict(), **overrides}
    return TrainConfig.from_dict(merged)
