"""Shared model layers for the HAA model family (torch counterpart of
``avdn_tpu/models/layers.py``).

SoftDotAttention (src/models/vln_model.py:12-47), the sinusoidal positional
encoding (src/models/encodings.py:7-49), the structural attention mask
(src/models/model_util.py:204-241), the ReLU/Dropout MLP heads and the
post-LN transformer encoder layer. Parameter names follow the reference
state-dict layout (``linear_in``, ``self_attn.in_proj_weight``, Sequential
indices), so ``compat/from_jax.py`` state dicts load strictly. Attention is
written out as matmul + masked softmax, the JAX formulation. The port runs
inference only, so dropout exists only where it fixes a Sequential index.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class SoftDotAttention(nn.Module):
    """Luong-style soft dot attention: ``h`` (B, dim) attends over
    ``context`` (B, L, dim); returns ``tanh(W_out [attn·context ; h])`` and
    the attention weights. Both projections are bias-free."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear_in = nn.Linear(dim, dim, bias=False)
        self.linear_out = nn.Linear(2 * dim, dim, bias=False)

    def forward(self, h, context, mask=None):
        target = self.linear_in(h)
        attn = torch.einsum("bld,bd->bl", context, target)
        if mask is not None:
            attn = attn.masked_fill(mask, float("-inf"))
        attn = torch.softmax(attn, dim=-1)
        weighted = torch.einsum("bl,bld->bd", attn, context)
        out = self.linear_out(torch.cat([weighted, h], dim=-1))
        return torch.tanh(out), attn


class MLPHead(nn.Sequential):
    """Linear/ReLU/Dropout stack, e.g. the action decoder 768→256→32→4
    (src/models/ET_haa.py:98-108, Linear indices 0, 3, 6) or the BERT
    768→64→49 head (src/models/vln_model.py:140-146, indices 0, 3, with a
    final ReLU: ``relu_last``). The Dropouts (identity in eval) keep the
    reference's Sequential indices."""

    def __init__(self, in_features: int, features: Sequence[int],
                 relu_last: bool = False):
        layers = []
        d = in_features
        for i, f in enumerate(features):
            layers.append(nn.Linear(d, f))
            if i < len(features) - 1:
                layers += [nn.ReLU(), nn.Dropout(0.2)]
            elif relu_last:
                layers.append(nn.ReLU())
            d = f
        super().__init__(*layers)


def sinusoidal_pos_encoding(max_len: int, d_model: int, device=None) -> torch.Tensor:
    """Standard transformer sinusoidal table (max_len, d_model)
    (src/models/encodings.py:12-20)."""
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d_model))
    ang = position * div
    pe = torch.zeros((max_len, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


def add_haa_pos_encoding(emb_lang, emb_frames, emb_directions, pe):
    """Add the (1/√d scaled) positional encoding with the reference's index
    scheme: language gets positions [0, L); frames AND directions share
    positions [L, L+T) (src/models/encodings.py:22-49)."""
    d = emb_lang.shape[-1]
    L = emb_lang.shape[1]
    T = emb_frames.shape[1]
    scale = 1.0 / math.sqrt(d)
    lang = emb_lang + pe[:L][None] * scale
    step_pe = pe[L: L + T][None] * scale
    return lang, emb_frames + step_pe, emb_directions + step_pe


def haa_attention_mask(len_lang: int, len_steps: int, device=None) -> torch.Tensor:
    """Structural attention mask (additive, -inf blocked) for the
    [lang | frames | directions] sequence (src/models/model_util.py:213-241):
    language attends only to language; frames/directions attend to ALL
    language plus causally (<= t) to both frames and directions.
    Shape: (L + 2T, L + 2T)."""
    L, T = len_lang, len_steps
    total = L + 2 * T
    i = torch.arange(total, device=device)[:, None]
    j = torch.arange(total, device=device)[None, :]
    is_lang_q = i < L
    is_lang_k = j < L
    # step index of a key/query position (frames and directions share clocks)
    q_step = torch.where(i < L + T, i - L, i - L - T)
    k_step = torch.where(j < L + T, j - L, j - L - T)
    ok = torch.where(is_lang_q, is_lang_k, is_lang_k | (k_step <= q_step))
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, float("-inf"))


def saliency_upsample(x8: torch.Tensor, out_hw: int = 224) -> torch.Tensor:
    """(B, 8, 8) → (B, out, out) bilinear upsample with half-pixel centers
    (``interpolate(..., align_corners=False)``, src/models/ET_haa.py:166-167)."""
    return F.interpolate(x8[:, None], size=(out_hw, out_hw), mode="bilinear",
                         align_corners=False)[:, 0]


class MultiheadSelfAttention(nn.Module):
    """Explicit MHA with ``torch.nn.MultiheadAttention``'s parameter layout
    (``in_proj_weight``/``in_proj_bias``/``out_proj``), so reference
    checkpoints load 1:1. ``bias`` is the additive (B or 1, 1, S, S) mask."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, bias):
        B, S, D = x.shape
        H = self.num_heads
        hd = D // H
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(B, S, H, hd).transpose(1, 2)
                   for t in qkv.split(D, dim=-1))
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd) + bias
        # guard fully-masked rows (all -inf) against NaN softmax
        probs = torch.nan_to_num(torch.softmax(logits, dim=-1), nan=0.0)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        return self.out_proj(out.transpose(1, 2).reshape(B, S, D))


class TransformerEncoderLayer(nn.Module):
    """Post-LN transformer encoder layer with torch
    ``nn.TransformerEncoderLayer`` semantics in eval mode (the reference
    trunk, src/models/enc_vl.py:16-22): MHA → add → LN, then FF(relu) →
    add → LN."""

    def __init__(self, d_model: int, num_heads: int, ff_dim: int):
        super().__init__()
        self.self_attn = MultiheadSelfAttention(d_model, num_heads)
        self.linear1 = nn.Linear(d_model, ff_dim)
        self.linear2 = nn.Linear(ff_dim, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, attn_mask=None, key_pad_mask=None):
        # attn_mask: (S, S) additive; key_pad_mask: (B, S) True = masked
        S = x.shape[1]
        bias = x.new_zeros((1, 1, S, S))
        if attn_mask is not None:
            bias = bias + attn_mask[None, None]
        if key_pad_mask is not None:
            pad = torch.zeros(key_pad_mask.shape, dtype=x.dtype, device=x.device)
            pad = pad.masked_fill(key_pad_mask, float("-inf"))
            bias = bias + pad[:, None, None, :]
        x = self.norm1(x + self.self_attn(x, bias))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))
