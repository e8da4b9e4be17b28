"""RoBERTa and its task heads (counterpart of the JAX package's
``models/roberta.py``). The trunk is BERT's with three differences:
position ids count the attention mask from ``pad_token_id + 1``
(``position_offset``), one token type, LN eps 1e-5 and no pooler. The
seq-cls head is dense -> tanh -> out_proj on the CLS token (HF
``RobertaClassificationHead``); token-cls and QA are BERT's heads."""

from __future__ import annotations

import torch
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


def roberta_config_from_hf(hf_config: dict, **overrides) -> EncoderConfig:
    kw = dict(
        vocab_size=hf_config["vocab_size"],
        hidden_size=hf_config["hidden_size"],
        num_layers=hf_config["num_hidden_layers"],
        num_heads=hf_config["num_attention_heads"],
        intermediate_size=hf_config["intermediate_size"],
        max_position_embeddings=hf_config["max_position_embeddings"],
        type_vocab_size=hf_config.get("type_vocab_size", 1),
        hidden_act=hf_config.get("hidden_act", "gelu"),
        layer_norm_eps=hf_config.get("layer_norm_eps", 1e-5),
        hidden_dropout=hf_config.get("hidden_dropout_prob", 0.1),
        attention_dropout=hf_config.get("attention_probs_dropout_prob", 0.1),
        pad_token_id=hf_config.get("pad_token_id", 1),
        position_offset=hf_config.get("pad_token_id", 1) + 1,
        use_pooler=False,
    )
    kw.update(overrides)
    return EncoderConfig(**kw)


def roberta_config_to_hf(c: EncoderConfig) -> dict:
    """The ``config.json`` the JAX package exports for a RoBERTa."""
    return {
        "model_type": "roberta", "architectures": ["RobertaForSequenceClassification"],
        "vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
        "num_hidden_layers": c.num_layers, "num_attention_heads": c.num_heads,
        "intermediate_size": c.intermediate_size,
        "max_position_embeddings": c.max_position_embeddings,
        "type_vocab_size": c.type_vocab_size, "hidden_act": c.hidden_act,
        "layer_norm_eps": c.layer_norm_eps,
        "hidden_dropout_prob": c.hidden_dropout,
        "attention_probs_dropout_prob": c.attention_dropout,
        "pad_token_id": c.pad_token_id, "initializer_range": c.initializer_range,
    }


class ClassificationHead(nn.Module):
    """dropout -> dense -> ``act`` -> dropout -> classifier on the CLS
    token (HF ``RobertaClassificationHead`` with tanh,
    ``ElectraClassificationHead`` with exact GeLU)."""

    def __init__(self, config: EncoderConfig, num_labels: int, act=torch.tanh):
        super().__init__()
        self.dropout = nn.Dropout(config.hidden_dropout)
        self.head_dense = Dense(config, config.hidden_size, config.hidden_size)
        self.act = act
        self.classifier = Dense(config, config.hidden_size, num_labels)

    def forward(self, seq):
        x = self.act(self.head_dense(self.dropout(seq[:, 0])))
        return self.classifier(self.dropout(x))


class RobertaForSequenceClassification(nn.Module):
    head_act = staticmethod(torch.tanh)

    def __init__(self, config: EncoderConfig, num_labels: int = 2):
        super().__init__()
        self.config = config
        self.num_labels = num_labels
        self.backbone = EncoderBackbone(config)
        self.head = ClassificationHead(config, num_labels, act=self.head_act)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        seq, _ = self.backbone(input_ids, attention_mask, token_type_ids)
        return self.head(seq)


RobertaForTokenClassification = BertForTokenClassification
RobertaForQuestionAnswering = BertForQuestionAnswering
RobertaForMaskedLM = BertForMaskedLM
