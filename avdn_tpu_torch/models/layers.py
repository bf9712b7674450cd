"""Shared model layers for the HAA model family (torch counterpart of
``avdn_tpu/models/layers.py``).

SoftDotAttention (src/models/vln_model.py:12-47), the sinusoidal positional
encoding (src/models/encodings.py:7-49), the structural attention mask
(src/models/model_util.py:204-241), the ReLU/Dropout MLP heads and the
post-LN transformer encoder layer. Parameter names follow the reference
state-dict layout (``linear_in``, ``self_attn.in_proj_weight``, Sequential
indices), so ``compat/from_jax.py`` state dicts load strictly. Attention is
written out as matmul + masked softmax, the JAX formulation. Dropout sits
where the flax modules have it (:class:`Dropout`, flax's semantics); its
masks come from the ``torch.Generator`` the caller passes to ``forward``.

Compute dtype. Every module takes a ``dtype`` (float32 or bfloat16) and
computes as the flax module with that ``dtype`` does, parameters staying
float32: ``Dense`` casts input, kernel and bias to it, ``LayerNorm``
normalises in float32 and returns it, ``Embedding`` returns it. Where the
JAX code divides attention logits by a strongly typed float32 scalar, the
bfloat16 logits promote to float32, so the softmax and the ``probs · v``
product run in float32 until the next ``Dense``.

In bfloat16 the roundings are those XLA computes for the flax modules: each
op's result is rounded to bfloat16 (a ``Dense`` rounds its product, then
its bias add), EXCEPT an op whose result is at once promoted to float32 —
XLA computes that op in float32 and never rounds it. So the residual sums
that enter a LayerNorm, the attention logits (``q·k``), and a ``Dense``
whose output is promoted (``keep_f32``) stay float32 here too; ``gelu`` and
``softmax`` below follow the same rule.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from avdn_tpu_torch.ops.saliency import saliency_upsample  # noqa: F401  (re-export)
from avdn_tpu_torch.parallel.batch import batch_rand


def dense(x, weight, bias, dtype, keep_f32: bool = False):
    """``x @ weight.T + bias`` as flax's ``nn.Dense(dtype=dtype)`` computes
    it: input, kernel and bias cast to ``dtype``. In float32 one fused call;
    in bfloat16 the product is rounded before the bias is added, and with
    ``keep_f32`` (the output is promoted to float32 at once) the last op —
    the bias add, or the product without a bias — is not rounded and the
    result is float32."""
    if dtype == torch.float32:
        return F.linear(x, weight, bias)
    w = weight.to(dtype).t()
    if bias is None:
        if keep_f32:
            return torch.matmul(x.to(dtype).float(), w.float())
        return torch.matmul(x.to(dtype), w)
    y = torch.matmul(x.to(dtype), w)
    if keep_f32:
        return y.float() + bias.to(dtype).float()
    return y + bias.to(dtype)


class Dense(nn.Linear):
    """``nn.Linear`` (float32 parameters, the reference's names) computing
    in ``dtype`` like flax's ``nn.Dense`` (:func:`dense`)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, keep_f32: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype
        self.keep_f32 = keep_f32

    def forward(self, x):
        return dense(x, self.weight, self.bias, self.dtype, self.keep_f32)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` normalising in float32 and returning ``dtype``, as
    flax's ``nn.LayerNorm(dtype=...)`` does."""

    def __init__(self, d: int, eps: float, dtype=torch.float32):
        super().__init__(d, eps=eps)
        self.dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


class Embedding(nn.Embedding):
    """``nn.Embedding`` returning ``dtype`` (flax ``nn.Embed(dtype=...)``)."""

    def __init__(self, num: int, dim: int, dtype=torch.float32):
        super().__init__(num, dim)
        self.dtype = dtype

    def forward(self, ids):
        return super().forward(ids).to(self.dtype)


def softmax(x, dim: int = -1):
    """``jax.nn.softmax``: ``exp(x − max) / Σ exp(x − max)``. In bfloat16 as
    XLA computes it: the exponentials rounded to bfloat16 for the numerator,
    summed unrounded in float32, the sum rounded."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=dim)
    d = x - x.max(dim=dim, keepdim=True).values
    s = torch.exp(d.float()).sum(dim=dim, keepdim=True).to(x.dtype)
    return torch.exp(d) / s


def gelu(x):
    """Exact (erf) GELU, ``0.5·x·erfc(−x/√2)``. In bfloat16 as XLA computes
    ``jax.nn.gelu(approximate=False)``: ``x·bf16(√½)`` unrounded into a
    float32 erfc, erfc and ``0.5·x`` rounded, their product rounded."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    sqrt_half = float(torch.tensor(math.sqrt(0.5), dtype=x.dtype))
    return (0.5 * x) * torch.erfc(-x.float() * sqrt_half).to(x.dtype)


def inv_sqrt(d: int) -> torch.Tensor:
    """``1/√d`` as XLA folds the JAX code's ``x / jnp.sqrt(float32(d))``:
    a float32 reciprocal constant that multiplies."""
    return 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))


def promote(*xs):
    """The tensors cast to their promoted dtype (jnp's binary promotion
    for float32/bfloat16 operands)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: in train mode each value is kept with
    probability ``1 − p`` and scaled by ``1/(1 − p)``
    (``where(mask, x / keep, 0)``), the mask drawn from the ``generator``
    the caller passes (required then: no global random state). The identity
    in eval mode or at ``p == 0``; parameter-free, so it never shifts a
    state-dict name. ``x``'s leading dimension is item-major: in a
    data-parallel step the mask is this rank's rows of the global batch's
    (``parallel.batch.batch_rand``)."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x, generator=None):
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in train mode draws its mask from the "
                             "caller's torch.Generator; none was given")
        keep = 1.0 - self.p
        if keep == 0.0:
            return torch.zeros_like(x)
        mask = batch_rand(x.shape, generator, x.device) < keep
        return torch.where(mask, x / keep, 0.0)


class SoftDotAttention(nn.Module):
    """Luong-style soft dot attention: ``h`` (B, query_dim) attends over
    ``context`` (B, L, dim); returns ``tanh(W_out [attn·context ; h])`` and
    the attention weights. Both projections are bias-free. ``query_dim``
    (default ``dim``) is the query's width, which flax's ``nn.Dense`` infers:
    the LSTM's language attention is queried by its 768-wide joint state
    whatever ``dim`` is."""

    def __init__(self, dim: int, dtype=torch.float32, query_dim: int = None):
        super().__init__()
        query_dim = dim if query_dim is None else query_dim
        self.linear_in = Dense(query_dim, dim, bias=False, dtype=dtype)
        self.linear_out = Dense(dim + query_dim, dim, bias=False, dtype=dtype)

    def forward(self, h, context, mask=None):
        # a float32 context promotes the target: its product stays float32
        lin = self.linear_in
        target = dense(h, lin.weight, None, lin.dtype,
                       keep_f32=context.dtype == torch.float32)
        attn = torch.einsum("bld,bd->bl", *promote(context, target))
        if mask is not None:
            attn = attn.masked_fill(mask, float("-inf"))
        attn = softmax(attn, dim=-1)
        weighted = torch.einsum("bl,bld->bd", *promote(attn, context))
        out = self.linear_out(torch.cat(promote(weighted, h), dim=-1))
        return torch.tanh(out), attn


class MLPHead(nn.Sequential):
    """Linear/ReLU/Dropout stack, e.g. the action decoder 768→256→32→4
    (src/models/ET_haa.py:98-108, Linear indices 0, 3, 6) or the BERT
    768→64→49 head (src/models/vln_model.py:140-146, indices 0, 3, with a
    final ReLU: ``relu_last``). The Dropouts keep the reference's
    Sequential indices."""

    def __init__(self, in_features: int, features: Sequence[int],
                 relu_last: bool = False, dtype=torch.float32,
                 keep_f32: bool = False, dropout: float = 0.2):
        layers = []
        d = in_features
        for i, f in enumerate(features):
            layers.append(Dense(d, f, dtype=dtype,
                                keep_f32=keep_f32 and i == len(features) - 1))
            if i < len(features) - 1:
                layers += [nn.ReLU(), Dropout(dropout)]
            elif relu_last:
                layers.append(nn.ReLU())
            d = f
        super().__init__(*layers)

    def forward(self, x, generator=None):
        for layer in self:
            x = layer(x, generator) if isinstance(layer, Dropout) else layer(x)
        return x


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
    positions [L, L+T) (src/models/encodings.py:22-49). The scale is a
    float32 scalar in the JAX code, so the sums are float32 whatever the
    dtype of the embeddings and of ``pe``."""
    d = emb_lang.shape[-1]
    L = emb_lang.shape[1]
    T = emb_frames.shape[1]
    scale = 1.0 / math.sqrt(d)
    lang = emb_lang.float() + pe[:L][None].float() * scale
    step_pe = pe[L: L + T][None].float() * scale
    return lang, emb_frames.float() + step_pe, emb_directions.float() + step_pe


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


class MultiheadSelfAttention(nn.Module):
    """Explicit MHA with ``torch.nn.MultiheadAttention``'s parameter layout
    (``in_proj_weight``/``in_proj_bias``/``out_proj``), so reference
    checkpoints load 1:1. ``bias`` is the additive (B or 1, 1, S, S) mask."""

    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Dense(d_model, d_model, dtype=dtype)
        self.dropout = Dropout(dropout)  # on the attention probabilities
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, bias, generator=None):
        B, S, D = x.shape
        H = self.num_heads
        hd = D // H
        qkv = dense(x, self.in_proj_weight, self.in_proj_bias, self.dtype)
        q, k, v = (t.reshape(B, S, H, hd).transpose(1, 2)
                   for t in qkv.split(D, dim=-1))
        # the logits promote to float32 at the division (JAX divides by a
        # float32 scalar): softmax and probs·v run in float32
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * inv_sqrt(hd) + bias
        # guard fully-masked rows (all -inf) against NaN softmax
        probs = torch.nan_to_num(torch.softmax(logits, dim=-1), nan=0.0)
        probs = self.dropout(probs, generator)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
        return self.out_proj(out.transpose(1, 2).reshape(B, S, D))


class TransformerEncoderLayer(nn.Module):
    """Post-LN transformer encoder layer with torch
    ``nn.TransformerEncoderLayer`` semantics (the reference trunk,
    src/models/enc_vl.py:16-22): MHA → dropout → add → LN, then FF(relu) →
    dropout → add → LN, with flax's dropout sites (the attention
    probabilities, the attention output, after the ReLU and the FF
    output)."""

    def __init__(self, d_model: int, num_heads: int, ff_dim: int,
                 dtype=torch.float32, dropout: float = 0.1):
        super().__init__()
        self.self_attn = MultiheadSelfAttention(d_model, num_heads, dtype, dropout)
        self.linear1 = Dense(d_model, ff_dim, dtype=dtype)
        self.linear2 = Dense(ff_dim, d_model, dtype=dtype)
        self.norm1 = LayerNorm(d_model, eps=1e-5, dtype=dtype)
        self.norm2 = LayerNorm(d_model, eps=1e-5, dtype=dtype)
        self.dropout1 = Dropout(dropout)
        self.dropout = Dropout(dropout)
        self.dropout2 = Dropout(dropout)

    def forward(self, x, attn_mask=None, key_pad_mask=None, generator=None):
        # attn_mask: (S, S) additive; key_pad_mask: (B, S) True = masked;
        # the bias holds only 0 and -inf, so its dtype does not matter
        S = x.shape[1]
        bias = torch.zeros((1, 1, S, S), device=x.device)
        if attn_mask is not None:
            bias = bias + attn_mask[None, None]
        if key_pad_mask is not None:
            pad = torch.zeros(key_pad_mask.shape, device=x.device)
            pad = pad.masked_fill(key_pad_mask, float("-inf"))
            bias = bias + pad[:, None, None, :]
        # the residual sums enter the LayerNorms unrounded (float32)
        attn = self.dropout1(self.self_attn(x, bias, generator), generator)
        x = self.norm1(x.float() + attn.float())
        ff = self.dropout(F.relu(self.linear1(x)), generator)
        ff = self.dropout2(self.linear2(ff), generator)
        return self.norm2(x.float() + ff.float())
