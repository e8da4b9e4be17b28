"""DistilBERT and its task heads (counterpart of the JAX package's
``models/distilbert.py``): BERT layers without token-type embeddings or
pooler. The seq-cls head is pre_classifier -> ReLU -> dropout ->
classifier on the CLS token (HF ``DistilBertForSequenceClassification``);
token-cls, QA and masked-LM (HF ``vocab_transform``/``vocab_projector``)
are BERT's heads (the trunk has no token types, so ``token_type_ids`` are
ignored)."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.bert import (
    BertForMaskedLM,
    BertForQuestionAnswering,
    BertForTokenClassification,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.layers import (
    Dense,
    EncoderBackbone,
    EncoderConfig,
)


def distilbert_config_from_hf(hf_config: dict, **overrides) -> EncoderConfig:
    kw = dict(
        vocab_size=hf_config["vocab_size"],
        hidden_size=hf_config["dim"],
        num_layers=hf_config["n_layers"],
        num_heads=hf_config["n_heads"],
        intermediate_size=hf_config["hidden_dim"],
        max_position_embeddings=hf_config["max_position_embeddings"],
        hidden_act=hf_config.get("activation", "gelu"),
        layer_norm_eps=1e-12,
        hidden_dropout=hf_config.get("dropout", 0.1),
        attention_dropout=hf_config.get("attention_dropout", 0.1),
        pad_token_id=hf_config.get("pad_token_id", 0),
        initializer_range=hf_config.get("initializer_range", 0.02),
        use_token_type=False,
        use_pooler=False,
    )
    kw.update(overrides)
    return EncoderConfig(**kw)


def distilbert_config_to_hf(c: EncoderConfig) -> dict:
    """The ``config.json`` the JAX package exports for a DistilBERT."""
    return {
        "model_type": "distilbert", "architectures": ["DistilBertForSequenceClassification"],
        "vocab_size": c.vocab_size, "dim": c.hidden_size,
        "n_layers": c.num_layers, "n_heads": c.num_heads,
        "hidden_dim": c.intermediate_size,
        "max_position_embeddings": c.max_position_embeddings,
        "activation": c.hidden_act, "dropout": c.hidden_dropout,
        "attention_dropout": c.attention_dropout,
        "pad_token_id": c.pad_token_id, "initializer_range": c.initializer_range,
    }


class DistilBertForSequenceClassification(nn.Module):
    """CLS -> pre_classifier -> ReLU -> dropout -> classifier."""

    def __init__(self, config: EncoderConfig, num_labels: int = 2):
        super().__init__()
        self.config = config
        self.num_labels = num_labels
        self.backbone = EncoderBackbone(config)
        self.pre_classifier = Dense(config, config.hidden_size, config.hidden_size)
        self.dropout = nn.Dropout(config.hidden_dropout)
        self.classifier = Dense(config, config.hidden_size, num_labels)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        seq, _ = self.backbone(input_ids, attention_mask)
        x = F.relu(self.pre_classifier(seq[:, 0]))
        return self.classifier(self.dropout(x))


DistilBertForTokenClassification = BertForTokenClassification
DistilBertForQuestionAnswering = BertForQuestionAnswering
DistilBertForMaskedLM = BertForMaskedLM
