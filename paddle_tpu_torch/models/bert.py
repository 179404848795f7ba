"""BERT: BERT-base pretraining (MLM + NSP) over the fused encoder layers.

Counterpart of ``paddle_tpu/models/bert.py``: ``BertConfig``,
``bert_base_config``, ``bert_tiny_config``, ``BertEmbeddings``,
``BertModel``, ``BertForPretraining``, ``BertForSequenceClassification``
and ``BertPretrainingCriterion``, with the JAX model's parameter names, so
``models.convert`` loads its ``raw_state()`` by name. The encoder blocks
are ``incubate.nn.FusedTransformerEncoderLayer`` in post-LN mode, whose
attention takes the flash kernels when no attention mask and no
attention dropout is given. A (B, S) 1/0 ``attention_mask`` becomes an
additive (B, 1, 1, S) mask of -1e9 at the zeros and takes the plain
composition, as in JAX. Weights: embeddings N(0, initializer_range),
projections XavierNormal, biases 0, norms 1 and 0.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..core.place import placed
from ..incubate.nn.fused_transformer import FusedTransformerEncoderLayer
from ..nn.layers import Dropout, Embedding, LayerNorm, Linear
from ..ops.nn_kernels import gelu, softmax_with_cross_entropy

__all__ = ["BertConfig", "BertModel", "BertForPretraining",
           "BertForSequenceClassification", "BertPretrainingCriterion",
           "bert_base_config", "bert_tiny_config"]


@dataclasses.dataclass
class BertConfig:
    """Architecture hyperparameters, with the JAX config's field names and
    defaults (BERT-base)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


def bert_base_config(**overrides):
    return BertConfig(**overrides)


def bert_tiny_config(**overrides):
    base = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128,
                max_position_embeddings=64, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
    base.update(overrides)
    return BertConfig(**base)


class BertEmbeddings(nn.Module):
    """Word + position (+ token type) embeddings, LayerNorm, dropout. The
    token-type table is read only when ``token_type_ids`` is given."""

    def __init__(self, config: BertConfig, *, generator, device, dtype):
        super().__init__()
        init = dict(std=config.initializer_range, generator=generator,
                    device=device, dtype=dtype)
        self.word_embeddings = Embedding(config.vocab_size,
                                         config.hidden_size, **init)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             config.hidden_size, **init)
        self.token_type_embeddings = Embedding(config.type_vocab_size,
                                               config.hidden_size, **init)
        self.layer_norm = LayerNorm(config.hidden_size, config.layer_norm_eps,
                                    device=device, dtype=dtype)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=generator)

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(x))


class BertModel(nn.Module):
    """Embeddings, the post-LN encoder stack and the tanh pooler over the
    first token; returns (sequence output, pooled output)."""

    def __init__(self, config: BertConfig, *, generator, device, dtype):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config, generator=generator,
                                         device=device, dtype=dtype)
        self.encoder = nn.ModuleList([
            FusedTransformerEncoderLayer(
                config.hidden_size, config.num_attention_heads,
                config.intermediate_size,
                dropout_rate=config.hidden_dropout_prob,
                activation=config.hidden_act,
                attn_dropout_rate=config.attention_probs_dropout_prob,
                normalize_before=False, device=device, dtype=dtype,
                generator=generator)
            for _ in range(config.num_hidden_layers)])
        self.pooler = Linear(config.hidden_size, config.hidden_size,
                             bias=True, generator=generator, device=device,
                             dtype=dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        mask = None
        if attention_mask is not None:
            m = attention_mask.to(torch.float32)
            mask = (1.0 - m)[:, None, None, :] * -1e9
        x = self.embeddings(input_ids, token_type_ids)
        for layer in self.encoder:
            x = layer(x, src_mask=mask)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForPretraining(nn.Module):
    """MLM and NSP heads over :class:`BertModel`: the MLM logits are
    ``gelu(transform(seq))`` normalised, times the word-embedding table
    transposed (tied, no bias); the NSP logits a linear head on the pooled
    output. ``device=None`` means the GPU; ``generator`` draws the weights
    and then the dropout masks, defaulting to ``seed(0)`` on ``device``."""

    def __init__(self, config: BertConfig, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        device, generator = placed(device, generator)
        init = dict(generator=generator, device=device, dtype=dtype)
        self.config = config
        self.bert = BertModel(config, **init)
        self.mlm_transform = Linear(config.hidden_size, config.hidden_size,
                                    bias=True, **init)
        self.mlm_norm = LayerNorm(config.hidden_size, config.layer_norm_eps,
                                  device=device, dtype=dtype)
        self.nsp_head = Linear(config.hidden_size, 2, bias=True, **init)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.mlm_norm(gelu(self.mlm_transform(seq)))
        mlm_logits = h @ self.bert.embeddings.word_embeddings.weight.t()
        return mlm_logits, self.nsp_head(pooled)


class BertForSequenceClassification(nn.Module):
    """A linear classifier on the dropped-out pooled output."""

    def __init__(self, config: BertConfig, num_classes=2, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        device, generator = placed(device, generator)
        init = dict(generator=generator, device=device, dtype=dtype)
        self.bert = BertModel(config, **init)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=generator)
        self.classifier = Linear(config.hidden_size, num_classes, bias=True,
                                 **init)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))


class BertPretrainingCriterion(nn.Module):
    """Mean MLM cross-entropy over every position (labels of -100 count as
    0) plus mean NSP cross-entropy; NSP labels may be (B,) or (B, 1)."""

    def forward(self, mlm_logits, nsp_logits, mlm_labels, nsp_labels,
                masked_positions=None):
        mlm_loss = softmax_with_cross_entropy(mlm_logits, mlm_labels,
                                              ignore_index=-100).mean()
        nsp_loss = softmax_with_cross_entropy(nsp_logits, nsp_labels).mean()
        return mlm_loss + nsp_loss
