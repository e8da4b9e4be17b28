"""ELECTRA and its task heads (counterpart of the JAX package's
``models/electra.py``: seq-cls, token-cls, QA, replaced-token detection
and the generator's masked LM). The trunk is BERT's with factorized
embeddings (``embedding_size`` below ``hidden_size``, projected up by the
backbone's ``embeddings_project``) and no pooler; the seq-cls head is
dense -> exact GeLU -> out_proj on the CLS token (HF
``ElectraClassificationHead``); ``ElectraForPreTraining`` is the
discriminator (one logit a token), ``ElectraForMaskedLM`` the generator
(its head always exact GeLU)."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.bert import (
    BertForMaskedLM,
    BertForQuestionAnswering,
    BertForTokenClassification,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.layers import (
    ACT2FN,
    Dense,
    EncoderBackbone,
    EncoderConfig,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.roberta import (
    RobertaForSequenceClassification,
)


def electra_config_from_hf(hf_config: dict, **overrides) -> EncoderConfig:
    kw = dict(
        vocab_size=hf_config["vocab_size"],
        hidden_size=hf_config["hidden_size"],
        embedding_size=hf_config.get("embedding_size", hf_config["hidden_size"]),
        num_layers=hf_config["num_hidden_layers"],
        num_heads=hf_config["num_attention_heads"],
        intermediate_size=hf_config["intermediate_size"],
        max_position_embeddings=hf_config["max_position_embeddings"],
        type_vocab_size=hf_config.get("type_vocab_size", 2),
        hidden_act=hf_config.get("hidden_act", "gelu"),
        layer_norm_eps=hf_config.get("layer_norm_eps", 1e-12),
        hidden_dropout=hf_config.get("hidden_dropout_prob", 0.1),
        attention_dropout=hf_config.get("attention_probs_dropout_prob", 0.1),
        pad_token_id=hf_config.get("pad_token_id", 0),
        initializer_range=hf_config.get("initializer_range", 0.02),
        use_pooler=False,
    )
    kw.update(overrides)
    return EncoderConfig(**kw)


def electra_config_to_hf(c: EncoderConfig) -> dict:
    """The ``config.json`` the JAX package exports for an ELECTRA."""
    return {
        "model_type": "electra", "architectures": ["ElectraForSequenceClassification"],
        "vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
        "embedding_size": c.embedding_size or c.hidden_size,
        "num_hidden_layers": c.num_layers, "num_attention_heads": c.num_heads,
        "intermediate_size": c.intermediate_size,
        "max_position_embeddings": c.max_position_embeddings,
        "type_vocab_size": c.type_vocab_size, "hidden_act": c.hidden_act,
        "layer_norm_eps": c.layer_norm_eps,
        "hidden_dropout_prob": c.hidden_dropout,
        "attention_probs_dropout_prob": c.attention_dropout,
        "pad_token_id": c.pad_token_id, "initializer_range": c.initializer_range,
    }


def _gelu(x):
    return F.gelu(x, approximate="none")


class ElectraForSequenceClassification(RobertaForSequenceClassification):
    """RoBERTa's CLS head with exact GeLU in place of tanh."""

    head_act = staticmethod(_gelu)


ElectraForTokenClassification = BertForTokenClassification
ElectraForQuestionAnswering = BertForQuestionAnswering


class ElectraForPreTraining(nn.Module):
    """The replaced-token-detection discriminator (HF
    ``ElectraForPreTraining``): ``disc_dense`` -> the config's activation ->
    ``disc_prediction``, one fp32 logit a token ``[B, S]`` that says whether
    the token was replaced."""

    def __init__(self, config: EncoderConfig):
        super().__init__()
        self.config = config
        self.backbone = EncoderBackbone(config)
        self.disc_dense = Dense(config, config.hidden_size, config.hidden_size)
        self.act = ACT2FN[config.hidden_act]
        self.disc_prediction = Dense(config, config.hidden_size, 1)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        seq, _ = self.backbone(input_ids, attention_mask, token_type_ids)
        return self.disc_prediction(self.act(self.disc_dense(seq)))[..., 0].float()


class ElectraForMaskedLM(BertForMaskedLM):
    """The generator (HF ``ElectraForMaskedLM``): HF's
    ``ElectraGeneratorPredictions`` is exact GeLU whatever the config's
    activation."""

    head_act = "gelu"
