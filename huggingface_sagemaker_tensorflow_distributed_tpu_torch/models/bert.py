"""BERT and its task heads (counterpart of the JAX package's
``models/bert.py``: ``bert_config_from_hf``,
``BertForSequenceClassification``, ``BertForTokenClassification``,
``BertForQuestionAnswering`` and ``BertForMaskedLM``). The token-cls, QA
and masked-LM heads are the same modules for every encoder family; a
family with its own trunk (ALBERT) subclasses them with another
``backbone_cls``. The token-cls and masked-LM heads take a packed batch's
``position_ids`` and ``segment_ids`` (``data.pipeline.pack_examples``)
and hand them to the backbone, as in the JAX package."""

from __future__ import annotations

from torch import nn

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.layers import (
    Dense,
    EncoderBackbone,
    EncoderConfig,
    MlmHead,
)


def bert_config_from_hf(hf_config: dict, **overrides) -> EncoderConfig:
    """Map an HF BertConfig dict (config.json) to an EncoderConfig."""
    kw = dict(
        vocab_size=hf_config["vocab_size"],
        hidden_size=hf_config["hidden_size"],
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
    )
    kw.update(overrides)
    return EncoderConfig(**kw)


def bert_config_to_hf(c: EncoderConfig) -> dict:
    """The ``config.json`` the JAX package exports for a BERT."""
    return {
        "model_type": "bert", "architectures": ["BertForSequenceClassification"],
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


def packed_kwargs(position_ids=None, segment_ids=None) -> dict:
    """The token-packing columns a backbone takes, only those given (a
    family whose backbone has no such arguments never receives them)."""
    kw = {}
    if position_ids is not None:
        kw["position_ids"] = position_ids
    if segment_ids is not None:
        kw["segment_ids"] = segment_ids
    return kw


def _head_dropout(config: EncoderConfig) -> float:
    return config.hidden_dropout


class BertForSequenceClassification(nn.Module):
    """Backbone -> pooler -> dropout -> linear classifier (HF head
    structure). Logits come out in the config's compute dtype."""

    backbone_cls = EncoderBackbone
    head_dropout = staticmethod(_head_dropout)

    def __init__(self, config: EncoderConfig, num_labels: int = 2):
        super().__init__()
        self.config = config
        self.num_labels = num_labels
        self.backbone = self.backbone_cls(config)
        self.dropout = nn.Dropout(self.head_dropout(config))
        self.classifier = Dense(config, config.hidden_size, num_labels)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        _, pooled = self.backbone(input_ids, attention_mask, token_type_ids)
        return self.classifier(self.dropout(pooled))


class BertForTokenClassification(nn.Module):
    """Backbone -> dropout -> linear classifier on every token:
    ``[B, S, num_labels]`` logits (CoNLL NER's 9 tags by default)."""

    backbone_cls = EncoderBackbone
    head_dropout = staticmethod(_head_dropout)

    def __init__(self, config: EncoderConfig, num_labels: int = 9):
        super().__init__()
        self.config = config
        self.num_labels = num_labels
        self.backbone = self.backbone_cls(config)
        self.dropout = nn.Dropout(self.head_dropout(config))
        self.classifier = Dense(config, config.hidden_size, num_labels)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, segment_ids=None):
        seq, _ = self.backbone(input_ids, attention_mask, token_type_ids,
                               **packed_kwargs(position_ids, segment_ids))
        return self.classifier(self.dropout(seq))


class BertForQuestionAnswering(nn.Module):
    """Start and end span logits (SQuAD; HF ``qa_outputs``): a
    ``(start [B, S], end [B, S])`` pair."""

    backbone_cls = EncoderBackbone

    def __init__(self, config: EncoderConfig):
        super().__init__()
        self.config = config
        self.backbone = self.backbone_cls(config)
        self.qa_outputs = Dense(config, config.hidden_size, 2)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        seq, _ = self.backbone(input_ids, attention_mask, token_type_ids)
        logits = self.qa_outputs(seq)
        return logits[..., 0], logits[..., 1]


class BertForMaskedLM(nn.Module):
    """Backbone -> :class:`MlmHead` tied to the word embeddings (HF
    ``BertForMaskedLM``): ``[B, S, V]`` fp32 logits; the pretraining recipe
    of the reference's default checkpoint,
    ``bert-large-uncased-whole-word-masking``. ``return_fused_inputs``
    gives ``(x [B, S, E], table [V, E], bias [V])`` for the fused loss
    instead."""

    backbone_cls = EncoderBackbone
    head_act = None

    def __init__(self, config: EncoderConfig):
        super().__init__()
        self.config = config
        self.backbone = self.backbone_cls(config)
        self.mlm_head = MlmHead(config, act=self.head_act)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                return_fused_inputs: bool = False, position_ids=None, segment_ids=None):
        seq, _ = self.backbone(input_ids, attention_mask, token_type_ids,
                               **packed_kwargs(position_ids, segment_ids))
        table = self.backbone.embeddings.word_embeddings.weight
        if return_fused_inputs:
            x, bias = self.mlm_head(seq, table, return_transform=True)
            return x, table, bias
        return self.mlm_head(seq, table)
