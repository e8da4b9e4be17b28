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
``gpt2`` and ``llama`` (with its aliases ``mistral``, ``qwen2``, ``gemma``
and ``mixtral``) with task ``causal-lm``. The exported ``config.json``
names the family's seq-cls architecture whatever the task, as the JAX
package's does (the encoder-decoders name their conditional-generation
one, the Llama family its ``model_type``'s causal-LM class).

MoE (``num_experts``) runs on the families of ``_MOE_FAMILIES``: a
Mixtral's expert banks travel in ``model.safetensors`` in HF's layout;
the other families' have no HF layout and travel in a
``moe.safetensors`` sidecar under their JAX parameter paths (with the MoE
fields in ``config.json``), which both packages read and write.
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
    build_empty,
    encoder_from_hf,
    encoder_to_hf,
    gpt2_from_hf,
    gpt2_to_hf,
    init_encoder,
    init_gpt2,
    init_llama,
    init_seq2seq,
    llama_from_hf,
    llama_to_hf,
    params_from_jax,
    seq2seq_from_hf,
    seq2seq_to_hf,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.gpt2 import (
    gpt2_config_from_hf,
    gpt2_config_to_hf,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.llama import (
    llama_config_from_hf,
    llama_config_to_hf,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.lora import (
    jax_param_paths,
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
# the tasks the port runs (the causal LMs are built by ``init_gpt2`` and
# ``init_llama``: ``CAUSAL_LM_FAMILIES``)
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
CAUSAL_LM_FAMILIES = ("gpt2", "llama")

CONFIG_BUILDERS = {
    "bert": bert.bert_config_from_hf,
    "roberta": roberta.roberta_config_from_hf,
    "distilbert": distilbert.distilbert_config_from_hf,
    "electra": electra.electra_config_from_hf,
    "albert": albert.albert_config_from_hf,
    "deberta-v2": deberta.deberta_config_from_hf,
    "gpt2": gpt2_config_from_hf,
    "llama": llama_config_from_hf,
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
    "llama": llama_config_to_hf,
    "t5": t5.t5_config_to_hf,
    "bart": bart.bart_config_to_hf,
    "mbart": lambda c: bart.bart_config_to_hf(c, "mbart"),
}

# families whose stacks host per-layer expert banks (T5 has its own
# blocks, ALBERT shares one layer across the stack)
_MOE_FAMILIES = ("bert", "roberta", "distilbert", "electra", "gpt2", "llama")
_MOE_CONFIG_KEYS = ("num_experts", "expert_top_k", "moe_every",
                    "expert_capacity_factor", "router_aux_coef")
MOE_SIDECAR = "moe.safetensors"
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
    ``xlm-roberta`` and ``mistral`` map to theirs)."""
    mt = hf_config.get("model_type", "")
    mt = _FAMILY_ALIASES.get(mt, mt)
    if mt in CONFIG_BUILDERS:
        return mt
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
    wants_moe = (config_overrides.get("num_experts", 0)
                 or hf_config.get("num_experts", 0))
    if wants_moe and family not in _MOE_FAMILIES:
        raise ValueError(
            f"MoE (num_experts={wants_moe}) is not supported for "
            f"family {family!r}; supported: {sorted(_MOE_FAMILIES)}")
    wants_kv = config_overrides.get("kv_cache_dtype", "fp")
    if wants_kv != "fp" and family not in CAUSAL_LM_FAMILIES:
        raise ValueError(
            f"kv_cache_dtype={wants_kv!r} is only supported for the "
            f"decoder-only families (llama, gpt2), not {family!r}")
    if family in CAUSAL_LM_FAMILIES and task != "causal-lm":
        raise ValueError(
            f"{model_name_or_path!r} is a {family} (decoder-only) checkpoint; it "
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
    if family in _MOE_FAMILIES:
        # an exported MoE model's config.json carries the MoE fields
        for key in _MOE_CONFIG_KEYS:
            if key in hf_config:
                config_overrides.setdefault(key, hf_config[key])
    config = CONFIG_BUILDERS[family](hf_config, dtype=dtype, param_dtype=param_dtype,
                                     **config_overrides)
    if family == "gpt2":
        model = init_gpt2(config, seed=seed, device=device, trainable=True)
        from_hf = gpt2_from_hf
    elif family == "llama":
        model = init_llama(config, seed=seed, device=device, trainable=True)
        from_hf = llama_from_hf
    elif family in SEQ2SEQ_FAMILIES:
        model = init_seq2seq(build_empty(build_model, family, task, config), seed=seed,
                             device=device)
        from_hf = functools.partial(seq2seq_from_hf, family=family)
    else:
        model = init_encoder(build_empty(build_model, family, task, config, num_labels),
                             seed=seed, device=device)
        from_hf = functools.partial(encoder_from_hf, family=family)
    weights = os.path.join(model_name_or_path, "model.safetensors")
    if from_scratch or not os.path.exists(weights):
        logger.info("initialized %s (%s) from scratch", model_name_or_path, family)
        return model, family, config
    loaded = from_hf(load_file(weights))
    own = model.state_dict()
    missing = sorted(set(own) - set(loaded))
    # expert banks are fresh when a dense checkpoint is upcycled (the
    # sidecar below overlays an MoE export's)
    backbone_missing = [m for m in missing
                        if m.startswith(("backbone.", "encoder.", "decoder.", "shared."))
                        and ".pooler." not in m and ".moe." not in m]
    if backbone_missing:
        raise ValueError(f"backbone params missing from checkpoint: {backbone_missing[:8]}")
    for key, value in loaded.items():
        if key in own and tuple(value.shape) != tuple(own[key].shape):
            raise ValueError(f"shape mismatch at {key}: checkpoint "
                             f"{tuple(value.shape)} vs model {tuple(own[key].shape)}")
    model.load_state_dict({k: v for k, v in loaded.items() if k in own}, strict=False)
    if missing:
        logger.info("freshly initialized head params: %s", missing)
    sidecar = os.path.join(model_name_or_path, MOE_SIDECAR)
    if os.path.exists(sidecar):
        _load_moe_sidecar(model, sidecar)
    logger.info("loaded %s (%s)", model_name_or_path, family)
    return model, family, config


def _load_moe_sidecar(model, path: str) -> None:
    """Overlay a ``moe.safetensors`` sidecar (JAX parameter paths) onto
    ``model``'s expert banks; refuses one that does not cover exactly the
    model's banks (a ``moe_every``/``num_experts`` override moved them)."""
    own = model.state_dict()
    raw = {k: v.float() if v.dtype == torch.bfloat16 else v
           for k, v in load_file(path).items()}
    loaded = {k: v for k, v in params_from_jax(raw).items() if k in own}
    model_moe = {k for k in own if ".moe." in k}
    if set(loaded) != model_moe:
        to_jax = jax_param_paths(model)
        raise ValueError(
            f"MoE sidecar {path} does not line up with the model's expert "
            f"layout (sidecar-only: {sorted(set(loaded) - model_moe)[:4]}, "
            f"model-only: {sorted(to_jax.get(k, k) for k in model_moe - set(loaded))[:4]}); "
            "load with the checkpoint's own num_experts/moe_every settings")
    for key, value in loaded.items():
        if tuple(value.shape) != tuple(own[key].shape):
            raise ValueError(f"shape mismatch at {key}: sidecar {tuple(value.shape)} "
                             f"vs model {tuple(own[key].shape)}")
    model.load_state_dict(loaded, strict=False)
    logger.info("loaded %d MoE expert weights from %s", len(loaded), path)


def save_pretrained(output_dir: str, model, family: str, config,
                    host0_only: bool = True, state: dict | None = None) -> None:
    """Export ``model`` in HF layout (``model.safetensors`` +
    ``config.json``), from rank 0 only unless ``host0_only`` is False;
    ``state`` (a ``state_dict``, e.g. a LoRA run's merged weights) replaces
    the model's own weights."""
    if host0_only and process_index() != 0:
        return
    os.makedirs(output_dir, exist_ok=True)
    state = {k: v.detach() for k, v in (model.state_dict() if state is None
                                         else state).items()}
    cfg_dict = HF_CONFIG_EXPORTERS[family](config)
    if getattr(config, "num_experts", 0) and family != "llama":
        # expert banks have no HF layout outside Mixtral: a sidecar under
        # the JAX parameter paths, and the MoE shape in config.json
        to_jax = jax_param_paths(model)
        save_file({to_jax[k]: v.contiguous() for k, v in state.items() if ".moe." in k},
                  os.path.join(output_dir, MOE_SIDECAR))
        for key in _MOE_CONFIG_KEYS:
            cfg_dict[key] = getattr(config, key)
    if family == "gpt2":
        state = gpt2_to_hf(state)
    elif family == "llama":
        state = llama_to_hf(state)
    elif family in SEQ2SEQ_FAMILIES:
        state = seq2seq_to_hf(state, family)
    else:
        state = encoder_to_hf(state, family)
    save_file(state, os.path.join(output_dir, "model.safetensors"),
              metadata={"format": "pt"})
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(cfg_dict, f, indent=2)
    logger.info("exported HF-layout checkpoint to %s", output_dir)
