"""Model construction and HF-layout export (counterpart of the JAX
package's ``models/auto.py``: ``load_hf_config``, ``detect_family``,
``from_pretrained`` and ``save_pretrained``).

``from_pretrained(path, task=...)`` reads ``config.json`` from a local
directory, builds the model with fresh seeded weights, and overlays
``model.safetensors`` unless ``from_scratch`` (task heads absent from the
checkpoint keep their fresh weights; a missing backbone weight raises).
``save_pretrained`` writes ``model.safetensors`` (metadata
``{"format": "pt"}``) and ``config.json`` in HF layout, from rank 0 only,
readable by the JAX package's ``from_pretrained`` and the reverse. The
``bert`` family with task ``seq-cls`` and the ``gpt2`` family with task
``causal-lm`` are ported so far.
"""

from __future__ import annotations

import json
import os

import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.bert import (
    bert_config_from_hf,
    bert_config_to_hf,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
    bert_from_hf,
    bert_to_hf,
    gpt2_from_hf,
    gpt2_to_hf,
    init_bert,
    init_gpt2,
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

# the JAX package's families; only those with a model here load
_KNOWN_FAMILIES = ("bert", "roberta", "distilbert", "electra", "albert", "t5",
                   "gpt2", "llama", "deberta-v2", "bart", "mbart")
_FAMILY_ALIASES = {"xlm-roberta": "roberta", "camembert": "roberta",
                   "mistral": "llama", "qwen2": "llama", "gemma": "llama",
                   "mixtral": "llama"}
_PORTED = ("bert", "gpt2")
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
    """The architecture family of an HF config; ``bert`` and ``gpt2`` are
    ported."""
    mt = hf_config.get("model_type", "")
    mt = _FAMILY_ALIASES.get(mt, mt)
    if mt not in _KNOWN_FAMILIES:
        raise ValueError(f"unsupported model_type {mt!r} (supported: "
                         f"{sorted(_KNOWN_FAMILIES) + sorted(_FAMILY_ALIASES)})")
    if mt not in _PORTED:
        raise NotImplementedError(
            f"model family {mt!r} is not ported to the PyTorch package yet: "
            "ROADMAP slices B/C")
    return mt


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
    if family == "gpt2":
        if task != "causal-lm":
            raise ValueError(
                f"{model_name_or_path!r} is a gpt2 (decoder-only) checkpoint; it "
                f"only supports task='causal-lm', got task={task!r}")
        config = gpt2_config_from_hf(hf_config, dtype=dtype, param_dtype=param_dtype,
                                     **config_overrides)
        model = init_gpt2(config, seed=seed, device=device, trainable=True)
        from_hf = gpt2_from_hf
    else:
        if task != "seq-cls":
            raise NotImplementedError(f"task {task!r} is not ported to the PyTorch "
                                      "package yet: ROADMAP slices B/C")
        config = bert_config_from_hf(hf_config, dtype=dtype, param_dtype=param_dtype,
                                     **config_overrides)
        model = init_bert(config, seed=seed, device=device, num_labels=num_labels)
        from_hf = bert_from_hf
    weights = os.path.join(model_name_or_path, "model.safetensors")
    if from_scratch or not os.path.exists(weights):
        logger.info("initialized %s (%s) from scratch", model_name_or_path, family)
        return model, family, config
    loaded = from_hf(load_file(weights))
    own = model.state_dict()
    missing = sorted(set(own) - set(loaded))
    backbone_missing = [m for m in missing
                        if m.startswith("backbone.") and ".pooler." not in m]
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
                    host0_only: bool = True) -> None:
    """Export ``model`` in HF layout (``model.safetensors`` +
    ``config.json``), from rank 0 only unless ``host0_only`` is False."""
    if family not in _PORTED:
        raise NotImplementedError(f"export of family {family!r} is not ported yet")
    if host0_only and process_index() != 0:
        return
    os.makedirs(output_dir, exist_ok=True)
    to_hf, config_to_hf = ((gpt2_to_hf, gpt2_config_to_hf) if family == "gpt2"
                           else (bert_to_hf, bert_config_to_hf))
    state = to_hf({k: v.detach() for k, v in model.state_dict().items()})
    save_file(state, os.path.join(output_dir, "model.safetensors"),
              metadata={"format": "pt"})
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(config_to_hf(config), f, indent=2)
    logger.info("exported HF-layout checkpoint to %s", output_dir)
