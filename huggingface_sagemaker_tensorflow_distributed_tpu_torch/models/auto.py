"""Model construction and HF-layout export (counterpart of the JAX
package's ``models/auto.py``: ``load_hf_config``, ``detect_family``,
``from_pretrained`` and ``save_pretrained``).

``from_pretrained(path, task=...)`` reads ``config.json`` from a local
directory, builds the model with fresh seeded weights, and overlays
``model.safetensors`` unless ``from_scratch`` (task heads absent from the
checkpoint keep their fresh weights; a missing backbone weight raises).
``save_pretrained`` writes ``model.safetensors`` (metadata
``{"format": "pt"}``) and ``config.json`` in HF layout, from rank 0 only,
readable by the JAX package's ``from_pretrained`` and the reverse. Ported
so far: the encoder families ``bert``, ``roberta``, ``distilbert``,
``electra``, ``albert`` and ``deberta-v2`` (DeBERTa-v2/v3, its legacy MLM
head only) with tasks ``seq-cls``, ``token-cls``, ``qa`` and ``mlm``, ELECTRA with ``rtd``, the encoder-decoder families ``t5``,
``bart`` and ``mbart`` with task ``seq2seq`` (``MODEL_REGISTRY``), and
``gpt2`` with task ``causal-lm``. The exported ``config.json`` names the
family's seq-cls architecture whatever the task, as the JAX package's
does (the encoder-decoders name their conditional-generation one).
"""

from __future__ import annotations

import functools
import json
import os

import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import (
    albert,
    bart,
    bert,
    deberta,
    distilbert,
    electra,
    roberta,
    t5,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
    encoder_from_hf,
    encoder_to_hf,
    gpt2_from_hf,
    gpt2_to_hf,
    init_encoder,
    init_gpt2,
    init_seq2seq,
    seq2seq_from_hf,
    seq2seq_to_hf,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.gpt2 import (
    gpt2_config_from_hf,
    gpt2_config_to_hf,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.safetensors_io import (
    load_file,
    save_file,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.logging import get_logger
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.results import (
    process_index,
)

logger = get_logger(__name__)

# (family, task) -> encoder model class: the JAX package's registry, for
# the tasks the port runs (GPT-2 causal-LM is built by ``init_gpt2``)
MODEL_REGISTRY = {
    ("bert", "seq-cls"): bert.BertForSequenceClassification,
    ("bert", "token-cls"): bert.BertForTokenClassification,
    ("bert", "qa"): bert.BertForQuestionAnswering,
    ("roberta", "seq-cls"): roberta.RobertaForSequenceClassification,
    ("roberta", "token-cls"): roberta.RobertaForTokenClassification,
    ("roberta", "qa"): roberta.RobertaForQuestionAnswering,
    ("distilbert", "seq-cls"): distilbert.DistilBertForSequenceClassification,
    ("distilbert", "token-cls"): distilbert.DistilBertForTokenClassification,
    ("distilbert", "qa"): distilbert.DistilBertForQuestionAnswering,
    ("electra", "seq-cls"): electra.ElectraForSequenceClassification,
    ("electra", "token-cls"): electra.ElectraForTokenClassification,
    ("electra", "qa"): electra.ElectraForQuestionAnswering,
    ("albert", "seq-cls"): albert.AlbertForSequenceClassification,
    ("albert", "token-cls"): albert.AlbertForTokenClassification,
    ("albert", "qa"): albert.AlbertForQuestionAnswering,
    ("bert", "mlm"): bert.BertForMaskedLM,
    ("roberta", "mlm"): roberta.RobertaForMaskedLM,
    ("distilbert", "mlm"): distilbert.DistilBertForMaskedLM,
    ("albert", "mlm"): albert.AlbertForMaskedLM,
    ("electra", "rtd"): electra.ElectraForPreTraining,
    ("electra", "mlm"): electra.ElectraForMaskedLM,
    ("deberta-v2", "seq-cls"): deberta.DebertaV2ForSequenceClassification,
    ("deberta-v2", "token-cls"): deberta.DebertaV2ForTokenClassification,
    ("deberta-v2", "qa"): deberta.DebertaV2ForQuestionAnswering,
    ("deberta-v2", "mlm"): deberta.DebertaV2ForMaskedLM,
    ("t5", "seq2seq"): t5.T5ForConditionalGeneration,
    ("bart", "seq2seq"): bart.BartForConditionalGeneration,
    ("mbart", "seq2seq"): bart.BartForConditionalGeneration,
}
SEQ2SEQ_FAMILIES = ("t5", "bart", "mbart")

CONFIG_BUILDERS = {
    "bert": bert.bert_config_from_hf,
    "roberta": roberta.roberta_config_from_hf,
    "distilbert": distilbert.distilbert_config_from_hf,
    "electra": electra.electra_config_from_hf,
    "albert": albert.albert_config_from_hf,
    "deberta-v2": deberta.deberta_config_from_hf,
    "gpt2": gpt2_config_from_hf,
    "t5": t5.t5_config_from_hf,
    "bart": bart.bart_config_from_hf,
    "mbart": bart.mbart_config_from_hf,
}

# the port's config -> the HF config.json the JAX package exports
HF_CONFIG_EXPORTERS = {
    "bert": bert.bert_config_to_hf,
    "roberta": roberta.roberta_config_to_hf,
    "distilbert": distilbert.distilbert_config_to_hf,
    "electra": electra.electra_config_to_hf,
    "albert": albert.albert_config_to_hf,
    "deberta-v2": deberta.deberta_config_to_hf,
    "gpt2": gpt2_config_to_hf,
    "t5": t5.t5_config_to_hf,
    "bart": bart.bart_config_to_hf,
    "mbart": lambda c: bart.bart_config_to_hf(c, "mbart"),
}

# the JAX package's families the port has no model for yet, by the
# ROADMAP queue 1 item that ports them
_UNPORTED_FAMILIES = {"llama": "item 9"}
_FAMILY_ALIASES = {"xlm-roberta": "roberta", "camembert": "roberta",
                   "mistral": "llama", "qwen2": "llama", "gemma": "llama",
                   "mixtral": "llama"}
_GENERATION_KEYS = ("forced_bos_token_id", "forced_eos_token_id",
                    "decoder_start_token_id", "bos_token_id",
                    "eos_token_id", "pad_token_id")


def load_hf_config(model_dir: str) -> dict:
    """config.json, with generation fields backfilled from
    generation_config.json."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    gen_path = os.path.join(model_dir, "generation_config.json")
    if os.path.exists(gen_path):
        with open(gen_path) as f:
            gen = json.load(f)
        for key in _GENERATION_KEYS:
            if cfg.get(key) is None and gen.get(key) is not None:
                cfg[key] = gen[key]
    return cfg


def detect_family(hf_config: dict) -> str:
    """The architecture family of an HF config (aliases such as
    ``xlm-roberta`` map to theirs); a family the port has no model for
    raises ``NotImplementedError`` naming its ROADMAP item."""
    mt = hf_config.get("model_type", "")
    mt = _FAMILY_ALIASES.get(mt, mt)
    if mt in CONFIG_BUILDERS:
        return mt
    if mt in _UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {mt!r} is not ported to the PyTorch package yet: "
            f"ROADMAP queue 1, {_UNPORTED_FAMILIES[mt]}")
    raise ValueError(f"unsupported model_type {mt!r} (supported: "
                     f"{sorted(CONFIG_BUILDERS) + sorted(_FAMILY_ALIASES)})")


def build_model(family: str, task: str, config, num_labels: int = 2):
    """The registry's model for ``(family, task)`` (the JAX package's
    ``build_model``): QA, MLM, RTD and seq2seq take no ``num_labels``."""
    cls = MODEL_REGISTRY.get((family, task))
    if cls is None:
        raise ValueError(f"no model for family={family!r} task={task!r}")
    if task in ("qa", "mlm", "rtd", "seq2seq"):
        return cls(config)
    return cls(config, num_labels=num_labels)


def from_pretrained(model_name_or_path: str, task: str = "seq-cls",
                    num_labels: int = 2, dtype=torch.float32,
                    param_dtype=torch.float32, seed: int = 0,
                    from_scratch: bool = False, device=None, **config_overrides):
    """Load (or freshly init) a model on ``device`` (CUDA unless named).
    Returns ``(model, family, config)``; the model is in eval mode."""
    if not os.path.isdir(model_name_or_path):
        raise FileNotFoundError(
            f"{model_name_or_path!r} is not a local directory. Pass a local "
            "checkpoint directory containing config.json (+ model.safetensors), "
            "e.g. produced by `save_pretrained`.")
    hf_config = load_hf_config(model_name_or_path)
    family = detect_family(hf_config)
    if family == "gpt2" and task != "causal-lm":
        raise ValueError(
            f"{model_name_or_path!r} is a gpt2 (decoder-only) checkpoint; it "
            f"only supports task='causal-lm', got task={task!r}")
    if family in SEQ2SEQ_FAMILIES and task != "seq2seq":
        raise ValueError(
            f"{model_name_or_path!r} is a {family} (encoder-decoder) checkpoint; it "
            f"only supports task='seq2seq', got task={task!r}")
    if (family == "deberta-v2" and task == "mlm"
            and hf_config.get("legacy") is False):
        raise ValueError(
            f"{model_name_or_path!r} uses the non-legacy DeBERTa MLM head "
            "(lm_predictions.lm_head); only the legacy cls.predictions "
            "layout is supported — silently loading would leave a random "
            "head (HF's own non-legacy forward is broken in transformers "
            "4.57: tie_weights clobbers lm_head.dense)")
    if family in ("bert", "albert") and task != "seq-cls":
        # HF builds the Bert/Albert QA and token-cls models with
        # add_pooling_layer=False; only the seq-cls head uses the pooler
        config_overrides.setdefault("use_pooler", False)
    config = CONFIG_BUILDERS[family](hf_config, dtype=dtype, param_dtype=param_dtype,
                                     **config_overrides)
    if family == "gpt2":
        model = init_gpt2(config, seed=seed, device=device, trainable=True)
        from_hf = gpt2_from_hf
    elif family in SEQ2SEQ_FAMILIES:
        model = init_seq2seq(build_model(family, task, config), seed=seed, device=device)
        from_hf = functools.partial(seq2seq_from_hf, family=family)
    else:
        model = init_encoder(build_model(family, task, config, num_labels), seed=seed,
                             device=device)
        from_hf = functools.partial(encoder_from_hf, family=family)
    weights = os.path.join(model_name_or_path, "model.safetensors")
    if from_scratch or not os.path.exists(weights):
        logger.info("initialized %s (%s) from scratch", model_name_or_path, family)
        return model, family, config
    loaded = from_hf(load_file(weights))
    own = model.state_dict()
    missing = sorted(set(own) - set(loaded))
    backbone_missing = [m for m in missing
                        if m.startswith(("backbone.", "encoder.", "decoder.", "shared."))
                        and ".pooler." not in m]
    if backbone_missing:
        raise ValueError(f"backbone params missing from checkpoint: {backbone_missing[:8]}")
    for key, value in loaded.items():
        if key in own and tuple(value.shape) != tuple(own[key].shape):
            raise ValueError(f"shape mismatch at {key}: checkpoint "
                             f"{tuple(value.shape)} vs model {tuple(own[key].shape)}")
    model.load_state_dict({k: v for k, v in loaded.items() if k in own}, strict=False)
    if missing:
        logger.info("freshly initialized head params: %s", missing)
    logger.info("loaded %s (%s)", model_name_or_path, family)
    return model, family, config


def save_pretrained(output_dir: str, model, family: str, config,
                    host0_only: bool = True, state: dict | None = None) -> None:
    """Export ``model`` in HF layout (``model.safetensors`` +
    ``config.json``), from rank 0 only unless ``host0_only`` is False;
    ``state`` (a ``state_dict``, e.g. a LoRA run's merged weights) replaces
    the model's own weights."""
    if family not in HF_CONFIG_EXPORTERS:
        raise NotImplementedError(f"export of family {family!r} is not ported to the "
                                  "PyTorch package yet: ROADMAP queue 1, "
                                  f"{_UNPORTED_FAMILIES.get(family, 'item 9')}")
    if host0_only and process_index() != 0:
        return
    os.makedirs(output_dir, exist_ok=True)
    state = {k: v.detach() for k, v in (model.state_dict() if state is None
                                         else state).items()}
    if family == "gpt2":
        state = gpt2_to_hf(state)
    elif family in SEQ2SEQ_FAMILIES:
        state = seq2seq_to_hf(state, family)
    else:
        state = encoder_to_hf(state, family)
    save_file(state, os.path.join(output_dir, "model.safetensors"),
              metadata={"format": "pt"})
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(HF_CONFIG_EXPORTERS[family](config), f, indent=2)
    logger.info("exported HF-layout checkpoint to %s", output_dir)
