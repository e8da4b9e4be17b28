"""ALBERT and its task heads (counterpart of the JAX package's
``models/albert.py``). A BERT-shaped post-LN encoder with two twists:

- factorized embeddings at ``embedding_size``, projected to
  ``hidden_size`` by ``embedding_hidden_mapping_in`` inside the trunk
  (ELECTRA projects in its backbone instead);
- cross-layer sharing: ONE ``EncoderLayer`` instance (``shared_layer``)
  applied ``num_layers`` times, so its parameters exist once and their
  gradient is the sum over the applications.

Only ``num_hidden_groups = inner_group_num = 1`` is supported (every
public ALBERT v1/v2 checkpoint); other values raise. The heads are
BERT's on this trunk, their dropout ``classifier_dropout_prob``; the
masked-LM head (HF ``AlbertMLMHead``) transforms to ``embedding_size``, the
tied table's width."""

from __future__ import annotations

import torch
from torch import nn

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.bert import (
    BertForMaskedLM,
    BertForQuestionAnswering,
    BertForSequenceClassification,
    BertForTokenClassification,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.layers import (
    Dense,
    Embeddings,
    EncoderConfig,
    EncoderLayer,
    Pooler,
    head_dropout_rate,
    make_attention_mask,
)
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.parallel.ring_attention import (
    model_seq_shard,
)


def albert_config_from_hf(hf_config: dict, **overrides) -> EncoderConfig:
    if hf_config.get("num_hidden_groups", 1) != 1 or hf_config.get("inner_group_num", 1) != 1:
        raise ValueError("ALBERT with num_hidden_groups/inner_group_num != 1 is not "
                         "supported (no public checkpoint uses it)")
    kw = dict(
        vocab_size=hf_config["vocab_size"],
        hidden_size=hf_config["hidden_size"],
        embedding_size=hf_config.get("embedding_size", 128),
        num_layers=hf_config["num_hidden_layers"],
        num_heads=hf_config["num_attention_heads"],
        intermediate_size=hf_config["intermediate_size"],
        max_position_embeddings=hf_config["max_position_embeddings"],
        type_vocab_size=hf_config.get("type_vocab_size", 2),
        hidden_act=hf_config.get("hidden_act", "gelu_new"),
        layer_norm_eps=hf_config.get("layer_norm_eps", 1e-12),
        hidden_dropout=hf_config.get("hidden_dropout_prob", 0.0),
        classifier_dropout=hf_config.get("classifier_dropout_prob", 0.1),
        attention_dropout=hf_config.get("attention_probs_dropout_prob", 0.0),
        pad_token_id=hf_config.get("pad_token_id", 0),
        initializer_range=hf_config.get("initializer_range", 0.02),
    )
    kw.update(overrides)
    return EncoderConfig(**kw)


def albert_config_to_hf(c: EncoderConfig) -> dict:
    """The ``config.json`` the JAX package exports for an ALBERT."""
    return {
        "model_type": "albert", "architectures": ["AlbertForSequenceClassification"],
        "vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
        "embedding_size": c.embedding_size or c.hidden_size,
        "num_hidden_layers": c.num_layers, "num_attention_heads": c.num_heads,
        "num_hidden_groups": 1, "inner_group_num": 1,
        "classifier_dropout_prob": head_dropout_rate(c),
        "intermediate_size": c.intermediate_size,
        "max_position_embeddings": c.max_position_embeddings,
        "type_vocab_size": c.type_vocab_size, "hidden_act": c.hidden_act,
        "layer_norm_eps": c.layer_norm_eps,
        "hidden_dropout_prob": c.hidden_dropout,
        "attention_probs_dropout_prob": c.attention_dropout,
        "pad_token_id": c.pad_token_id, "initializer_range": c.initializer_range,
    }


class AlbertBackbone(nn.Module):
    """Embeddings -> hidden projection -> one shared layer x num_layers
    (+ pooler). Returns ``(sequence_output, pooled or None)``."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.embedding_hidden_mapping_in = Dense(cfg, cfg.embedding_size or cfg.hidden_size,
                                                 cfg.hidden_size)
        self.shared_layer = EncoderLayer(cfg)
        if cfg.use_pooler:
            self.pooler = Pooler(cfg)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, position_ids=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        additive_mask = make_attention_mask(attention_mask)
        x = self.embeddings(input_ids, token_type_ids, position_ids, attention_mask)
        x = self.embedding_hidden_mapping_in(x)
        # under an active seq axis the shared layer runs on this rank's
        # tokens (models/layers.py:EncoderBackbone)
        seq = model_seq_shard(self.cfg.attention_impl)
        if seq is not None:
            x, additive_mask = seq.local(x), seq.local_mask(additive_mask)
        for _ in range(self.cfg.num_layers):
            x = self.shared_layer(x, additive_mask)
        if seq is not None:
            x = seq.gather(x)
        pooled = self.pooler(x) if self.cfg.use_pooler else None
        return x, pooled


class AlbertForSequenceClassification(BertForSequenceClassification):
    """pooled -> dropout (``classifier_dropout``) -> classifier."""

    backbone_cls = AlbertBackbone
    head_dropout = staticmethod(head_dropout_rate)


class AlbertForTokenClassification(BertForTokenClassification):
    backbone_cls = AlbertBackbone
    head_dropout = staticmethod(head_dropout_rate)


class AlbertForQuestionAnswering(BertForQuestionAnswering):
    backbone_cls = AlbertBackbone


class AlbertForMaskedLM(BertForMaskedLM):
    backbone_cls = AlbertBackbone
