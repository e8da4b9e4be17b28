"""Weights for the port's models: carried over from a JAX parameter tree,
made at random from a seed, or mapped to and from the HF key layout.

- :func:`params_from_jax` maps the JAX package's flattened params
  (``flax.traverse_util.flatten_dict(params, sep="/")``) onto the port's
  ``state_dict``: a flax ``Dense`` ``kernel [in, out]`` becomes
  ``Linear.weight [out, in]``, a LayerNorm ``scale`` becomes ``weight``,
  an ``Embed.embedding`` the embedding weight, and ``h_<i>``/``layer_<i>``/
  ``layers_<i>`` the module list entry ``h.<i>``/``layer.<i>``/``layers.<i>``;
  the MoE banks (``router``, ``wi``/``wo``, ``w1``/``w2``/``w3``) keep their
  names and layouts; an int8 kernel's
  ``kernel_q [in, out]`` and ``kernel_scale [out]`` (``models/quant.py``)
  become ``Int8Linear.weight_q [out, in]`` and ``weight_scale``; a conv kernel
  ``[K, in / groups, out]`` (DeBERTa's) reverses to ``Conv1d``'s ``[out,
  in / groups, K]``. Both packages then compute the same function.
  :func:`lora_from_jax` carries a JAX adapter tree across the same way.
- :func:`init_gpt2` and :func:`init_encoder` (any encoder family and head;
  :func:`init_bert` for BERT seq-cls) are the counterparts of the JAX
  package's ``models/auto.py::init_params``: normal(initializer_range)
  embeddings and dense kernels (GPT-2's residual projections at
  ``initializer_range / sqrt(2 * layers)``), zero biases, unit LayerNorm
  scales. The numbers come from a ``torch.Generator``, so they are not
  JAX's numbers for the same seed.
- :func:`encoder_to_hf` / :func:`encoder_from_hf` (families ``bert``,
  ``roberta``, ``distilbert``, ``electra``, ``albert``, ``deberta-v2``;
  ``bert_*`` are BERT's) and :func:`gpt2_to_hf` / :func:`gpt2_from_hf` map a
  ``state_dict`` to the HF layout and back, with the JAX package's
  ``params_to_hf`` / ``hf_to_params`` names. HF's GPT-2 ``Conv1D`` stores ``[in, out]``, so the
  port's ``Linear.weight [out, in]`` is transposed on the way (the JAX
  package's ``[in, out]`` kernels are not); ``lm_head`` is tied to ``wte``
  and is not written.
- :func:`init_llama` seeds a Llama-family model in place on its device
  (built on the meta device), and :func:`llama_to_hf` /
  :func:`llama_from_hf` map it with the JAX ``_LLAMA_RULES`` and
  ``_LLAMA_REVERSE``, Mixtral's banks unstacked into HF's per-expert
  Linears and back (``_mixtral_moe_to_hf`` / ``_fold_mixtral_moe``).
- :func:`init_seq2seq` seeds a T5 or BART (the JAX package's inits: T5's
  ``initializer_factor`` scales, BART's ``init_std``), and
  :func:`seq2seq_to_hf` / :func:`seq2seq_from_hf` map families ``t5``,
  ``bart`` and ``mbart`` (the JAX ``_T5_RULES``, ``_BART_RULES``,
  ``_MBART_RULES`` and their reverses): T5's ``relative_attention_bias``
  lives on block 0 of each stack only; a tied ``lm_head`` and BART's
  ``final_logits_bias`` are skipped on load and not written, and an
  ``embed_tokens`` table stands in for a missing ``shared``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import resolve_device
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.bert import (
    BertForSequenceClassification,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.gpt2 import (
    Gpt2Config,
    Gpt2LMHeadModel,
)

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "bias": "bias", "kernel_q": "weight_q", "kernel_scale": "weight_scale",
         # the MoE banks keep the JAX names and layouts
         "router": "router", "wi": "wi", "wo": "wo", "w1": "w1", "w2": "w2", "w3": "w3"}
_RESIDUAL_OUT = ("attn_out", "fc_out")


def params_from_jax(flat: dict) -> dict:
    """``{"backbone/h_0/attention/qkv/kernel": array, ...}`` (an optional
    leading ``params/`` is dropped) -> a ``state_dict`` of tensors."""
    out = {}
    for key, value in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        leaf = parts[-1]
        if leaf not in _LEAF:
            raise ValueError(f"unsupported JAX parameter {key!r}")
        arr = np.asarray(value)
        if leaf in ("kernel", "kernel_q"):
            arr = arr.T
        path = [re.sub(r"^(h|layer|layers|block)_(\d+)$", r"\1.\2", p) for p in parts[:-1]]
        out[".".join(path + [_LEAF[leaf]])] = torch.from_numpy(np.array(arr))
    return out


def lora_from_jax(tree) -> dict:
    """The JAX package's LoRA adapters (``init_lora_params``'s tree, nested
    or flattened with ``sep="/"``; numpy or jax arrays) -> the port's
    ``{kernel path: {"a": A, "b": B}}`` (``models/lora.py``). The paths and
    the ``[in, r]``/``[r, out]`` layouts are the same in both packages."""
    if any(isinstance(v, dict) for v in tree.values()):
        flat = {}

        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, prefix + (str(k),))
                else:
                    flat["/".join(prefix + (str(k),))] = v
        walk(tree, ())
        tree = flat
    out: dict = {}
    for key, value in tree.items():
        kernel, part = key.rsplit("/", 1)
        if part not in ("a", "b"):
            raise ValueError(f"not a LoRA factor: {key!r}")
        out.setdefault(kernel, {})[part] = torch.from_numpy(np.array(np.asarray(value)))
    return out


def build_empty(factory, *args, **kwargs):
    """``factory(*args, **kwargs)`` built on the meta device, then given
    uninitialized CPU storage: for a model :func:`_init_normal` initializes
    next, which draws, zeroes or fills every parameter (the models register
    no buffers), so the constructors' own default inits, drawn on the host
    and then overwritten, are skipped: the same weights, built sooner."""
    with torch.device("meta"):
        model = factory(*args, **kwargs)
    return model.to_empty(device="cpu")


def _init_normal(model, std_of, seed: int):
    """Zero biases, unit layer-norm scales, everything else normal with
    ``std_of(name)``, drawn on the CPU in ``named_parameters`` order."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight_scale"):
                p.fill_(1.0)             # an int8 dense's placeholders
            elif not p.is_floating_point() or name.endswith("bias"):
                p.zero_()
            elif re.search(r"(^|\.)(ln|ln_\w*|\w*_ln)\.weight$", name):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * std_of(name))
    return model


def init_gpt2(cfg: Gpt2Config, seed: int = 0, device=None,
              trainable: bool = False) -> Gpt2LMHeadModel:
    """A GPT-2 with random weights from ``seed``, in eval mode on
    ``device`` (CUDA unless the caller names another; raises without
    it). Weights are drawn on the CPU, so a seed gives the same model on
    every device. Its parameters take no gradient unless ``trainable``
    (serving keeps them frozen)."""
    dev = resolve_device(device)
    std = cfg.initializer_range
    resid_std = std / (2 * cfg.num_layers) ** 0.5
    model = build_empty(Gpt2LMHeadModel, cfg)

    def std_of(name):
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        if name.endswith(".wo") and getattr(owner, "out_init_std", None) is not None:
            return owner.out_init_std            # an expert bank's output
        return resid_std if any(f".{r}." in name for r in _RESIDUAL_OUT) else std

    model = _init_normal(model, std_of, seed)
    return model.to(dev).eval().requires_grad_(trainable)


def init_encoder(model, seed: int = 0, device=None):
    """An encoder-family model (any family, any head) with random weights
    from ``seed``: normal(initializer_range) dense kernels and embeddings,
    zero biases, unit LayerNorm scales; in eval mode on ``device`` (CUDA
    unless the caller names another; raises without it). Weights are
    drawn on the CPU, so a seed gives the same model on every device."""
    dev = resolve_device(device)
    std = model.config.initializer_range
    return _init_normal(model, lambda name: std, seed).to(dev).eval()


def init_bert(cfg, seed: int = 0, device=None, num_labels: int = 2):
    """:func:`init_encoder` of a ``BertForSequenceClassification``."""
    return init_encoder(build_empty(BertForSequenceClassification, cfg, num_labels=num_labels),
                        seed=seed, device=device)


# (port module path, HF module path) per family, the JAX package's
# ``_<FAMILY>_RULES`` and ``_<FAMILY>_REVERSE`` in one table; ``{}`` is a
# layer index. Head entries (``classifier``, ``qa_outputs``, the CLS
# heads' ``classifier.dense``/``classifier.out_proj``) carry no prefix.
_ENCODER_LAYER = [
    ("attention.query", "attention.self.query"),
    ("attention.key", "attention.self.key"),
    ("attention.value", "attention.self.value"),
    ("attention.attention_out", "attention.output.dense"),
    ("attention_ln", "attention.output.LayerNorm"),
    ("ffn.intermediate", "intermediate.dense"),
    ("ffn.ffn_out", "output.dense"),
    ("ffn_ln", "output.LayerNorm"),
]


def _encoder_names(prefix: str) -> list:
    embeddings = ("word_embeddings", "position_embeddings", "token_type_embeddings")
    return ([(f"backbone.embeddings.{e}", f"{prefix}.embeddings.{e}") for e in embeddings]
            + [("backbone.embeddings.embeddings_ln", f"{prefix}.embeddings.LayerNorm")]
            + [(f"backbone.encoder.layer.{{}}.{ours}", f"{prefix}.encoder.layer.{{}}.{hf}")
               for ours, hf in _ENCODER_LAYER])


_CLS_HEAD = [("head.head_dense", "classifier.dense"), ("head.classifier", "classifier.out_proj")]
_TASK_HEADS = [("qa_outputs", "qa_outputs"), ("classifier", "classifier")]


def _mlm_head(transform: str, ln: str, bias: str) -> list:
    """The masked-LM head's HF names; its decoder weight is the tied word
    embedding, read from and written to the embedding's key only (an HF
    ``decoder.weight`` is skipped on load, as the JAX package skips it)."""
    return [("mlm_head.transform", transform), ("mlm_head.ln", ln), ("mlm_head", bias)]
_ALBERT_LAYER = "albert.encoder.albert_layer_groups.0.albert_layers.0"

ENCODER_NAMES = {
    "bert": _encoder_names("bert") + [("backbone.pooler.pooler", "bert.pooler.dense")]
    + _TASK_HEADS
    + _mlm_head("cls.predictions.transform.dense", "cls.predictions.transform.LayerNorm",
                "cls.predictions"),
    "roberta": _encoder_names("roberta") + _CLS_HEAD + _TASK_HEADS
    + _mlm_head("lm_head.dense", "lm_head.layer_norm", "lm_head"),
    "distilbert": [
        ("backbone.embeddings.word_embeddings", "distilbert.embeddings.word_embeddings"),
        ("backbone.embeddings.position_embeddings",
         "distilbert.embeddings.position_embeddings"),
        ("backbone.embeddings.embeddings_ln", "distilbert.embeddings.LayerNorm")]
    + [(f"backbone.encoder.layer.{{}}.{ours}", f"distilbert.transformer.layer.{{}}.{hf}")
       for ours, hf in [("attention.query", "attention.q_lin"),
                        ("attention.key", "attention.k_lin"),
                        ("attention.value", "attention.v_lin"),
                        ("attention.attention_out", "attention.out_lin"),
                        ("attention_ln", "sa_layer_norm"),
                        ("ffn.intermediate", "ffn.lin1"), ("ffn.ffn_out", "ffn.lin2"),
                        ("ffn_ln", "output_layer_norm")]]
    + [("pre_classifier", "pre_classifier")] + _TASK_HEADS
    + _mlm_head("vocab_transform", "vocab_layer_norm", "vocab_projector"),
    "electra": _encoder_names("electra")
    + [("backbone.embeddings_project", "electra.embeddings_project")]
    + _CLS_HEAD + _TASK_HEADS
    + [("disc_dense", "discriminator_predictions.dense"),
       ("disc_prediction", "discriminator_predictions.dense_prediction")]
    + _mlm_head("generator_predictions.dense", "generator_predictions.LayerNorm",
                "generator_lm_head"),
    "albert": [(f"backbone.embeddings.{e}", f"albert.embeddings.{e}")
               for e in ("word_embeddings", "position_embeddings", "token_type_embeddings")]
    + [("backbone.embeddings.embeddings_ln", "albert.embeddings.LayerNorm"),
       ("backbone.embedding_hidden_mapping_in", "albert.encoder.embedding_hidden_mapping_in")]
    + [(f"backbone.shared_layer.{ours}", f"{_ALBERT_LAYER}.{hf}")
       for ours, hf in [("attention.query", "attention.query"),
                        ("attention.key", "attention.key"),
                        ("attention.value", "attention.value"),
                        ("attention.attention_out", "attention.dense"),
                        ("attention_ln", "attention.LayerNorm"),
                        ("ffn.intermediate", "ffn"), ("ffn.ffn_out", "ffn_output"),
                        ("ffn_ln", "full_layer_layer_norm")]]
    + [("backbone.pooler.pooler", "albert.pooler")] + _TASK_HEADS
    + _mlm_head("predictions.dense", "predictions.LayerNorm", "predictions"),
}


def _rules(names, src: int, prefix: str):
    """Key-translation rules from ``names[i][src]`` to ``names[i][1 - src]``;
    HF keys read with or without their ``prefix`` (``bert``,
    ``transformer``)."""
    rules = []
    for pair in names:
        pattern = re.escape(pair[src]).replace(r"\{\}", r"(\d+)")
        if src == 1 and prefix and pattern.startswith(prefix):
            pattern = rf"(?:{prefix}\.)?" + pattern[len(prefix) + 2:]
        rules.append((re.compile(f"^{pattern}\\.(weight|bias)$"), pair[1 - src]))
    return rules


# DeBERTa-v2/v3 (the JAX _DEBERTA_V2_RULES and _DEBERTA_V2_REVERSE): the
# legacy cls.predictions MLM head; the conv kernel is Conv1d's layout on
# both sides
ENCODER_NAMES["deberta-v2"] = (
    [(f"backbone.{e}", f"deberta.embeddings.{e}")
     for e in ("word_embeddings", "position_embeddings", "token_type_embeddings",
               "embed_proj")]
    + [("backbone.embeddings_ln", "deberta.embeddings.LayerNorm"),
       ("backbone.rel_embeddings", "deberta.encoder.rel_embeddings"),
       ("backbone.rel_ln", "deberta.encoder.LayerNorm"),
       ("backbone.conv.conv", "deberta.encoder.conv.conv"),
       ("backbone.conv.conv_ln", "deberta.encoder.conv.LayerNorm")]
    + [(f"backbone.layer.{{}}.{ours}", f"deberta.encoder.layer.{{}}.{hf}")
       for ours, hf in [("attention.query", "attention.self.query_proj"),
                        ("attention.key", "attention.self.key_proj"),
                        ("attention.value", "attention.self.value_proj"),
                        ("attention.pos_key", "attention.self.pos_key_proj"),
                        ("attention.pos_query", "attention.self.pos_query_proj"),
                        ("attention_out", "attention.output.dense"),
                        ("attention_ln", "attention.output.LayerNorm"),
                        ("intermediate", "intermediate.dense"),
                        ("ffn_out", "output.dense"), ("ffn_ln", "output.LayerNorm")]]
    + [("pooler", "pooler.dense")] + _TASK_HEADS
    + _mlm_head("cls.predictions.transform.dense", "cls.predictions.transform.LayerNorm",
                "cls.predictions"))
_HF_PREFIX = {"deberta-v2": "deberta"}
_ENCODER_TO_HF = {f: _rules(names, 0, _HF_PREFIX.get(f, f))
                  for f, names in ENCODER_NAMES.items()}
_ENCODER_FROM_HF = {f: _rules(names, 1, _HF_PREFIX.get(f, f))
                    for f, names in ENCODER_NAMES.items()}


def _translate(key: str, rules) -> str | None:
    for pattern, template in rules:
        m = pattern.match(key)
        if m:
            *layer, leaf = m.groups()
            return template.format(*layer) + "." + leaf
    return None


def encoder_to_hf(state_dict: dict, family: str) -> dict:
    """Port ``state_dict`` of an encoder family -> HF keys (with the
    family's prefix: ``bert.``, ``roberta.``, ...; ``nn.Linear`` weights
    are ``[out, in]`` on both sides). Unmapped keys are dropped."""
    out = {}
    for key, value in state_dict.items():
        hf = _translate(key, _ENCODER_TO_HF[family])
        if hf is not None:
            out[hf] = value
    return out


def encoder_from_hf(hf_state: dict, family: str) -> dict:
    """HF keys of an encoder family (with or without the family's prefix)
    -> port ``state_dict`` keys; keys no rule of the family names (another
    family's heads) are dropped, as the JAX package's ``hf_to_params``
    skips them, and so is the MLM decoder's weight, the tied word
    embedding (DistilBERT's ``vocab_projector.weight``, ELECTRA's
    ``generator_lm_head.weight``)."""
    out = {}
    for key, value in hf_state.items():
        port = _translate(key, _ENCODER_FROM_HF[family])
        if port is not None and port != "mlm_head.weight":
            out[port] = value
    return out


def bert_to_hf(state_dict: dict) -> dict:
    return encoder_to_hf(state_dict, "bert")


def bert_from_hf(hf_state: dict) -> dict:
    return encoder_from_hf(hf_state, "bert")


_GPT2_NAMES = [
    ("backbone.wte", "transformer.wte"),
    ("backbone.wpe", "transformer.wpe"),
    ("backbone.h.{}.ln_1", "transformer.h.{}.ln_1"),
    ("backbone.h.{}.attention.qkv", "transformer.h.{}.attn.c_attn"),
    ("backbone.h.{}.attention.attn_out", "transformer.h.{}.attn.c_proj"),
    ("backbone.h.{}.ln_2", "transformer.h.{}.ln_2"),
    ("backbone.h.{}.mlp.fc_in", "transformer.h.{}.mlp.c_fc"),
    ("backbone.h.{}.mlp.fc_out", "transformer.h.{}.mlp.c_proj"),
    ("backbone.ln_f", "transformer.ln_f"),
]
_GPT2_TO_HF = _rules(_GPT2_NAMES, 0, "transformer")
_GPT2_FROM_HF = _rules(_GPT2_NAMES, 1, "transformer")
# the port's Linear layers: [out, in] here, Conv1D [in, out] in HF
_GPT2_LINEAR = re.compile(r"\.(qkv|attn_out|fc_in|fc_out)\.weight$")


def gpt2_to_hf(state_dict: dict) -> dict:
    """Port GPT-2 ``state_dict`` -> HF keys (``transformer.`` prefix,
    Conv1D weights ``[in, out]``); ``lm_head`` is tied and not written."""
    out = {}
    for key, value in state_dict.items():
        hf = _translate(key, _GPT2_TO_HF)
        if hf is not None:
            out[hf] = value.t().contiguous() if _GPT2_LINEAR.search(key) else value
    return out


def gpt2_from_hf(hf_state: dict) -> dict:
    """HF GPT-2 keys (with or without ``transformer.``) -> port keys; a
    saved ``lm_head.weight`` stands in for a missing ``wte`` (they are
    tied), and other keys (the attention's causal-mask buffers) are
    dropped, as the JAX package's ``hf_to_params`` skips them."""
    out = {}
    for key, value in hf_state.items():
        port = _translate(key, _GPT2_FROM_HF)
        if port is not None:
            out[port] = value.t().contiguous() if _GPT2_LINEAR.search(port) else value
    if "backbone.wte.weight" not in out and "lm_head.weight" in hf_state:
        out["backbone.wte.weight"] = hf_state["lm_head.weight"]
    return out


def init_seq2seq(model, seed: int = 0, device=None):
    """A T5 or BART with random weights from ``seed`` (the JAX package's
    init): T5's embedding and untied head normal(``initializer_factor``),
    its attention and input projections normal(factor · d_model^-0.5), its
    FFN output normal(factor · d_ff^-0.5); BART's every dense kernel and
    embedding normal(``init_std``); zero biases, unit norm scales. In eval
    mode on ``device`` (CUDA unless the caller names another)."""
    cfg = model.config
    if hasattr(cfg, "initializer_factor"):
        f = cfg.initializer_factor

        def std_of(name):
            if name.startswith(("shared.", "lm_head.")):
                return f
            return f * (cfg.d_ff if ".wo." in name else cfg.d_model) ** -0.5
    else:
        def std_of(name):
            return cfg.init_std
    return _init_normal(model, std_of, seed).to(resolve_device(device)).eval()


def _t5_names() -> list:
    names = [("shared", "shared"), ("lm_head", "lm_head")]
    for stack in ("encoder", "decoder"):
        blk = f"{stack}.block.{{}}"
        ffn = 2 if stack == "decoder" else 1
        names += [(f"{blk}.attn_ln", f"{blk}.layer.0.layer_norm"),
                  (f"{blk}.self_attn.rel_bias",
                   f"{blk}.layer.0.SelfAttention.relative_attention_bias"),
                  (f"{blk}.ffn_ln", f"{blk}.layer.{ffn}.layer_norm"),
                  (f"{stack}.final_ln", f"{stack}.final_layer_norm")]
        names += [(f"{blk}.self_attn.{ours}", f"{blk}.layer.0.SelfAttention.{hf}")
                  for ours, hf in (("query", "q"), ("key", "k"), ("value", "v"),
                                   ("attention_out", "o"))]
        names += [(f"{blk}.ffn.{w}", f"{blk}.layer.{ffn}.DenseReluDense.{w}")
                  for w in ("wi", "wi_0", "wi_1", "wo")]
        if stack == "decoder":
            names += [(f"{blk}.cross_ln", f"{blk}.layer.1.layer_norm")]
            names += [(f"{blk}.cross_attn.{ours}", f"{blk}.layer.1.EncDecAttention.{hf}")
                      for ours, hf in (("query", "q"), ("key", "k"), ("value", "v"),
                                       ("attention_out", "o"))]
    return names


def _bart_names(mbart: bool) -> list:
    names = [("shared", "model.shared")]
    for stack in ("encoder", "decoder"):
        lay, hf_lay = f"{stack}.layer.{{}}", f"model.{stack}.layers.{{}}"
        names += [(f"{stack}.embed_positions", f"model.{stack}.embed_positions"),
                  (f"{stack}.embed_ln", f"model.{stack}.layernorm_embedding"),
                  (f"{lay}.self_attn_ln", f"{hf_lay}.self_attn_layer_norm"),
                  (f"{lay}.fc1", f"{hf_lay}.fc1"), (f"{lay}.fc2", f"{hf_lay}.fc2"),
                  (f"{lay}.ffn_ln", f"{hf_lay}.final_layer_norm")]
        attns = [("self_attn", "self_attn")]
        if stack == "decoder":
            attns.append(("cross_attn", "encoder_attn"))
            names.append((f"{lay}.cross_ln", f"{hf_lay}.encoder_attn_layer_norm"))
        names += [(f"{lay}.{ours}.{p}", f"{hf_lay}.{hf}.{q}_proj")
                  for ours, hf in attns
                  for p, q in (("query", "q"), ("key", "k"), ("value", "v"),
                               ("attention_out", "out"))]
        if mbart:
            names.append((f"{stack}.final_ln", f"model.{stack}.layer_norm"))
    return names


SEQ2SEQ_NAMES = {"t5": _t5_names(), "bart": _bart_names(False), "mbart": _bart_names(True)}
_SEQ2SEQ_PREFIX = {"t5": "", "bart": "model", "mbart": "model"}
_SEQ2SEQ_TO_HF = {f: _rules(n, 0, _SEQ2SEQ_PREFIX[f]) for f, n in SEQ2SEQ_NAMES.items()}
_SEQ2SEQ_FROM_HF = {f: _rules(n, 1, _SEQ2SEQ_PREFIX[f]) for f, n in SEQ2SEQ_NAMES.items()}
# HF's per-stack copies of the shared table
_EMBED_TOKENS = re.compile(r"^(?:model\.)?(?:encoder|decoder)\.embed_tokens\.weight$")


def seq2seq_to_hf(state_dict: dict, family: str) -> dict:
    """Port ``state_dict`` of a T5, BART or mBART -> HF keys (BART's with
    the ``model.`` prefix). ``nn.Linear`` weights are ``[out, in]`` on
    both sides."""
    out = {}
    for key, value in state_dict.items():
        hf = _translate(key, _SEQ2SEQ_TO_HF[family])
        if hf is not None:
            out[hf] = value
    return out


def seq2seq_from_hf(hf_state: dict, family: str) -> dict:
    """HF keys of a T5, BART or mBART -> port keys; BART's tied
    ``lm_head.weight`` and ``final_logits_bias`` (and any other key no
    rule names) are dropped, and a stack's ``embed_tokens`` stands in for
    a missing ``shared``."""
    out = {}
    for key, value in hf_state.items():
        port = _translate(key, _SEQ2SEQ_FROM_HF[family])
        if port is not None:
            out[port] = value
    if "shared.weight" not in out:
        alias = next((k for k in hf_state if _EMBED_TOKENS.match(k)), None)
        if alias is not None:
            out["shared.weight"] = hf_state[alias]
    return out


def init_llama(cfg, seed: int = 0, device=None, trainable: bool = False):
    """A Llama-family model with random weights from ``seed`` (the JAX
    package's init: normal(``initializer_range``) for every dense kernel,
    embedding, router and expert bank, zero biases, unit RMS scales or
    Gemma's zero offsets), in eval mode on ``device`` (CUDA unless the
    caller names another). The model is built on the meta device and its
    weights drawn in place on ``device`` from a generator there (an 8B
    model in bf16 is never materialized on the host), so a seed gives the
    same weights on one kind of device. Its parameters take no gradient
    unless ``trainable``."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.llama import (
        LlamaForCausalLM,
    )

    dev = resolve_device(device)
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    model.to_empty(device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight_scale"):
                p.fill_(1.0)
            elif not p.is_floating_point() or name.endswith(".bias"):
                p.zero_()
            elif name.endswith("_ln.weight"):
                p.fill_(0.0 if cfg.rms_unit_offset else 1.0)
            else:
                p.normal_(0.0, cfg.initializer_range, generator=gen)
    return model.eval().requires_grad_(trainable)


# the JAX _LLAMA_RULES and _LLAMA_REVERSE; Mixtral's expert banks fold
# separately (_MIXTRAL_*)
_LLAMA_NAMES = (
    [("backbone.embed_tokens", "model.embed_tokens"), ("backbone.final_ln", "model.norm"),
     ("lm_head", "lm_head"),
     ("backbone.layers.{}.input_ln", "model.layers.{}.input_layernorm"),
     ("backbone.layers.{}.post_attn_ln", "model.layers.{}.post_attention_layernorm")]
    + [(f"backbone.layers.{{}}.self_attn.{p}_proj", f"model.layers.{{}}.self_attn.{p}_proj")
       for p in "qkvo"]
    + [(f"backbone.layers.{{}}.mlp.{p}_proj", f"model.layers.{{}}.mlp.{p}_proj")
       for p in ("gate", "up", "down")])
_LLAMA_TO_HF = _rules(_LLAMA_NAMES, 0, "")
_LLAMA_FROM_HF = _rules(_LLAMA_NAMES, 1, "")
_MIXTRAL_GATE = re.compile(r"^model\.layers\.(\d+)\.block_sparse_moe\.gate\.weight$")
_MIXTRAL_EXPERT = re.compile(
    r"^model\.layers\.(\d+)\.block_sparse_moe\.experts\.(\d+)\.w([123])\.weight$")
_MIXTRAL_BANK = re.compile(r"^backbone\.layers\.(\d+)\.moe\.(router|w[123])$")


def llama_to_hf(state_dict: dict) -> dict:
    """Port Llama-family ``state_dict`` -> HF keys (``model.`` prefix;
    ``nn.Linear`` weights are ``[out, in]`` on both sides). Mixtral's
    banks unstack into HF's per-expert Linears: ``w{1,2,3}[j].T`` as
    ``experts.<j>.w{1,2,3}.weight`` and the router ``[H, E]`` transposed
    to ``gate.weight`` (the JAX ``_mixtral_moe_to_hf``)."""
    out = {}
    for key, value in state_dict.items():
        m = _MIXTRAL_BANK.match(key)
        if m:
            prefix = f"model.layers.{m.group(1)}.block_sparse_moe"
            if m.group(2) == "router":
                out[f"{prefix}.gate.weight"] = value.t().contiguous()
            else:
                for j in range(value.shape[0]):
                    out[f"{prefix}.experts.{j}.{m.group(2)}.weight"] = \
                        value[j].t().contiguous()
            continue
        hf = _translate(key, _LLAMA_TO_HF)
        if hf is not None:
            out[hf] = value
    return out


def llama_from_hf(hf_state: dict) -> dict:
    """HF Llama-family keys -> port keys; Mixtral's per-expert Linears
    stack into the ``[E, in, out]`` banks and ``gate.weight`` transposes
    to the router (the JAX ``_fold_mixtral_moe``); rotary ``inv_freq``
    buffers and other unmapped keys are dropped."""
    out, experts = {}, {}
    for key, value in hf_state.items():
        m = _MIXTRAL_GATE.match(key)
        if m:
            out[f"backbone.layers.{m.group(1)}.moe.router"] = value.t().contiguous()
            continue
        m = _MIXTRAL_EXPERT.match(key)
        if m:
            experts.setdefault((m.group(1), m.group(3)), {})[int(m.group(2))] = value
            continue
        port = _translate(key, _LLAMA_FROM_HF)
        if port is not None:
            out[port] = value
    for (layer, w), by_j in experts.items():
        out[f"backbone.layers.{layer}.moe.w{w}"] = torch.stack(
            [by_j[j].t() for j in range(len(by_j))]).contiguous()
    return out
