"""BERT-base language tower (torch counterpart of ``avdn_tpu/models/bert.py``).

The reference wraps HuggingFace ``bert-base-uncased`` with a small
768→64→49 ReLU head on the pooler output (``CustomBERTModel``,
src/models/vln_model.py:128-159). The encoder is written out here with the
HF/reference parameter names (``bert.embeddings.*``,
``bert.encoder.layer.{i}.*``, ``bert.pooler.dense``, ``linears.{0,3}``), so
``compat/from_jax.py:bert_state_dict`` loads strictly.

Returns the reference's triple: token features (B, L, 768), the 49-d head
output (queries the visual spatial attention), and the pooler vector, in the
compute ``dtype`` (flax's rules, ``models/layers.py``). In train mode
dropout runs at the JAX module's sites (embeddings, attention probabilities,
both residual branches, the head), its masks drawn from the ``generator``
passed to ``forward``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from avdn_tpu_torch.models.layers import (
    Dense,
    Dropout,
    Embedding,
    LayerNorm,
    MLPHead,
    gelu,
    inv_sqrt,
)
from avdn_tpu_torch.utils.logging import span


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    head_dims: tuple = (64, 49)  # the CustomBERTModel extra head
    head_dropout: float = 0.2

    @staticmethod
    def tiny():
        """Small config for tests: same topology, 2 layers, 128 wide."""
        return BertConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                          num_heads=4, intermediate_size=256, max_position=128)


class _Embeddings(nn.Module):
    def __init__(self, c: BertConfig, dtype):
        super().__init__()
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size, dtype)
        self.position_embeddings = Embedding(c.max_position, c.hidden_size, dtype)
        self.token_type_embeddings = Embedding(c.type_vocab_size, c.hidden_size, dtype)
        self.LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)
        self.dropout = Dropout(c.hidden_dropout)

    def forward(self, input_ids, generator=None):
        L = input_ids.shape[1]
        pos = torch.arange(L, device=input_ids.device)[None, :]
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        # the last sum enters the LayerNorm unrounded (models/layers.py)
        return self.dropout(self.LayerNorm(
            x.float() + self.token_type_embeddings(torch.zeros_like(input_ids)).float()),
            generator)


class _SelfAttention(nn.Module):
    def __init__(self, c: BertConfig, dtype):
        super().__init__()
        self.num_heads = c.num_heads
        self.query = Dense(c.hidden_size, c.hidden_size, dtype=dtype)
        self.key = Dense(c.hidden_size, c.hidden_size, dtype=dtype)
        self.value = Dense(c.hidden_size, c.hidden_size, dtype=dtype)
        self.dropout = Dropout(c.attention_dropout)

    def forward(self, x, bias, generator=None):
        B, S, D = x.shape
        H = self.num_heads
        hd = D // H

        def heads(t):
            return t.reshape(B, S, H, hd).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        # float32 from the product on (JAX divides by a float32 scalar)
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * inv_sqrt(hd)
        if bias is not None:
            logits = logits + bias
        probs = self.dropout(torch.softmax(logits, dim=-1), generator)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
        return out.transpose(1, 2).reshape(B, S, D)


class _DenseNorm(nn.Module):
    """Dense → dropout → residual → LayerNorm (HF ``BertSelfOutput`` /
    ``BertOutput``)."""

    def __init__(self, d_in: int, c: BertConfig, dtype):
        super().__init__()
        self.dense = Dense(d_in, c.hidden_size, dtype=dtype)
        self.LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)
        self.dropout = Dropout(c.hidden_dropout)

    def forward(self, h, residual, generator=None):
        return self.LayerNorm(residual.float()
                              + self.dropout(self.dense(h), generator).float())


class _Attention(nn.Module):
    def __init__(self, c: BertConfig, dtype):
        super().__init__()
        self.self = _SelfAttention(c, dtype)
        self.output = _DenseNorm(c.hidden_size, c, dtype)

    def forward(self, x, bias, generator=None):
        return self.output(self.self(x, bias, generator), x, generator)


class _Intermediate(nn.Module):
    def __init__(self, c: BertConfig, dtype):
        super().__init__()
        self.dense = Dense(c.hidden_size, c.intermediate_size, dtype=dtype)

    def forward(self, x):
        return gelu(self.dense(x))  # exact erf GELU


class _Layer(nn.Module):
    def __init__(self, c: BertConfig, dtype):
        super().__init__()
        self.attention = _Attention(c, dtype)
        self.intermediate = _Intermediate(c, dtype)
        self.output = _DenseNorm(c.intermediate_size, c, dtype)

    def forward(self, x, bias, generator=None):
        x = self.attention(x, bias, generator)
        return self.output(self.intermediate(x), x, generator)


class _Encoder(nn.Module):
    def __init__(self, c: BertConfig, dtype):
        super().__init__()
        self.layer = nn.ModuleList([_Layer(c, dtype) for _ in range(c.num_layers)])


class _Pooler(nn.Module):
    def __init__(self, c: BertConfig, dtype):
        super().__init__()
        self.dense = Dense(c.hidden_size, c.hidden_size, dtype=dtype)

    def forward(self, x):
        return torch.tanh(self.dense(x[:, 0]))


class _BertModel(nn.Module):
    def __init__(self, c: BertConfig, dtype):
        super().__init__()
        self.embeddings = _Embeddings(c, dtype)
        self.encoder = _Encoder(c, dtype)
        self.pooler = _Pooler(c, dtype)


class BertLanguageEncoder(nn.Module):
    """BERT encoder + pooler + the reference's 49-d head.

    ``forward(input_ids (B, L), attention_mask (B, L))`` →
    ``(sequence (B, L, D), head49 (B, 49), pooled (B, D))`` — the triple of
    ``CustomBERTModel.forward`` (src/models/vln_model.py:148-159); computed
    in ``dtype`` (float32 parameters).
    """

    def __init__(self, cfg: BertConfig = BertConfig(), dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.bert = _BertModel(cfg, dtype)
        self.linears = MLPHead(cfg.hidden_size, cfg.head_dims, relu_last=True,
                               dtype=dtype, dropout=cfg.head_dropout)

    def forward(self, input_ids, attention_mask=None, generator=None):
        with span("models.bert"):
            x = self.bert.embeddings(input_ids, generator)
            bias = None
            if attention_mask is not None:
                # HF convention: additive bias on padded keys (float32, as the
                # logits it is added to)
                bias = torch.where(attention_mask.bool(), 0.0, -1e9)[:, None, None, :]
            for layer in self.bert.encoder.layer:
                x = layer(x, bias, generator)
            pooled = self.bert.pooler(x)
            return x, self.linears(pooled, generator), pooled
