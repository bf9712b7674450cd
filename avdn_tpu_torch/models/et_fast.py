"""Eval-only fast formulations of the HAA-Transformer trunk (torch
counterpart of ``avdn_tpu/models/et_fast.py``).

The module (``models/et.py``) re-encodes the FULL padded history every step,
the reference's O(T²) semantics (src/xview_et/agent.py:605-630). In eval
mode the trunk's masks make most of that work redundant. The attention mask
is causal over the frame and direction blocks (src/models/model_util.py:
213-241): the token at step position j attends language plus steps ≤ j.
With the per-item key padding (``step >= lengths[b]`` masked,
src/models/enc_vl.py:49-55), the attention support of position j in a
full-history pass equals its support in the step-t call for every t ≥ j:

* item alive at step t (``lengths_t[b] = t+1``): causality already restricts
  keys to ``s ≤ j ≤ t < lengths``, so neither call's padding binds;
* item ended at step e < t (``lengths_t[b] = e+1`` frozen): both calls mask
  ``s ≥ e+1`` identically.

By induction over layers every token at position j is the same in all calls
with t ≥ j. Two exact reformulations follow:

1. **Single-pass teacher trunk** (``teacher_onepass``): ONE pass with the
   final lengths gives every step's readout token; the per-step outputs are
   gathers at the batch-max positions ``max_b lengths_t[b] − 1``
   (src/models/ET_haa.py:157-158). It runs the module's own ``encode`` and
   ``readout``.
2. **Incremental KV decode** (``make_lang_cache`` + ``decode_step``, opt-in
   ``--et_decode_trunk``): language positions attend language only, so
   their per-layer keys/values are episode constants computed once, and
   each step runs ONLY the two new tokens (frame t, direction t) against
   the cached keys/values (``_attend_two`` merges the language and step
   sources without concatenating them). Its primitives mirror the JAX
   package's pure functions, casts included, over the module's parameters;
   equal to the full re-encode up to float reassociation.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F

from avdn_tpu_torch.models.layers import dense, softmax
from avdn_tpu_torch.utils.logging import span


def teacher_onepass(model, lang, lang_cls, frames, dirs, lengths_steps):
    """All T per-step (action, saliency) outputs of ``model`` (an eval-mode
    ``HAATransformer``) from one trunk pass.

    ``frames`` (B, T, C, 49) and ``dirs`` (B, T, 2) are the full unmasked
    history; ``lengths_steps`` (T, B) the cumulative alive counts per step.
    Returns ``action (T, B, 4)`` and the saliency heads ``(T, B, 8, 8)``."""
    with span("models.trunk"):
        B, T = frames.shape[0], frames.shape[1]
        L = lang.shape[1]
        seq = model.encode(lang, lang_cls, frames, dirs, lengths_steps[-1])
        m = lengths_steps.max(dim=1).values - 1                  # (T,)
        vis_tok = seq.index_select(1, L + m)                      # (B, T, D)
        dir_tok = seq.index_select(1, L + T + m)
        # step-major, so the readout's rows are (t, b) in order
        action, saliency = model.readout(vis_tok.transpose(0, 1).reshape(T * B, -1),
                                         dir_tok.transpose(0, 1).reshape(T * B, -1))
        return action.reshape(T, B, -1), saliency.reshape(T, B, *saliency.shape[1:])


# --------------------------------------------------------------------------
# Primitives mirroring the JAX package's pure functions (eval mode)
# --------------------------------------------------------------------------


def _dense(lin, x, dtype):
    """:func:`models.layers.dense` of an ``nn.Linear`` (or the ``(weight,
    bias)`` of one)."""
    w, b = (lin.weight, lin.bias) if hasattr(lin, "weight") else lin
    return dense(x, w, b, dtype)


def _layernorm(ln, x, dtype, eps=1e-5):
    """flax LayerNorm semantics: fast variance, statistics in float32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    mul = torch.rsqrt(var + eps) * ln.weight.float()
    return ((xf - mean) * mul + ln.bias.float()).to(dtype)


def _softdot_pool(sda, h, context, dtype):
    """``SoftDotAttention``: h (B, d) over context (B, S, d); the pooled tanh
    output only."""
    context = context.to(dtype)
    target = _dense(sda.linear_in, h, dtype)
    attn = softmax(torch.einsum("bld,bd->bl", context, target))
    weighted = torch.einsum("bl,bld->bd", attn, context)
    return torch.tanh(_dense(sda.linear_out, torch.cat([weighted, h.to(dtype)], -1),
                             dtype))


def _split_heads(x, H):
    B, S, D = x.shape
    return x.reshape(B, S, H, D // H).transpose(1, 2)


def _merge_heads(x):
    B, H, S, hd = x.shape
    return x.transpose(1, 2).reshape(B, S, H * hd)


def _scale(hd: int, dtype):
    """``jnp.sqrt(jnp.float32(hd)).astype(dtype)`` as a tensor of ``dtype``."""
    return torch.sqrt(torch.tensor(float(hd), dtype=torch.float32)).to(dtype)


def _attend(q, k, v, bias):
    """Scaled dot-product attention with the module's NaN guard for
    fully-masked rows."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / _scale(q.shape[-1], q.dtype).to(q.device)
    probs = softmax(logits + bias)
    probs = torch.where(torch.isnan(probs), 0.0, probs).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _attend_two(q, k1, v1, bias1, k2, v2, bias2):
    """Softmax attention over TWO key/value sources without concatenating
    them: ``softmax([l1; l2])`` decomposes into per-source exponentials
    under a shared max shift, renormalised by the joint sum; equal to
    ``_attend`` over the concatenation up to float reassociation. A fully
    masked row, and a row whose unmasked logit overflowed to +inf, give 0
    (``_attend``'s NaN guard); a +inf logit on a masked position (possible
    in bf16) is zeroed before it can poison the sum."""
    scale = _scale(q.shape[-1], q.dtype).to(q.device)
    l1 = torch.einsum("bhqd,bhkd->bhqk", q, k1) / scale + bias1
    l2 = torch.einsum("bhqd,bhkd->bhqk", q, k2) / scale + bias2
    m = torch.maximum(l1.max(dim=-1, keepdim=True).values,
                      l2.max(dim=-1, keepdim=True).values)
    m = torch.where(torch.isfinite(m), m, 0.0).to(q.dtype)
    e1 = torch.exp(l1 - m)   # -inf bias entries exp to exactly 0
    e2 = torch.exp(l2 - m)
    e1 = torch.where(torch.isnan(e1), 0.0, e1)
    e2 = torch.where(torch.isnan(e2), 0.0, e2)
    s = e1.sum(dim=-1, keepdim=True) + e2.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", e1, v1) + torch.einsum("bhqk,bhkd->bhqd", e2, v2)
    return torch.where((s > 0) & torch.isfinite(s), o / s, 0.0).to(q.dtype)


def _ffn(layer, x, dtype):
    """The feed-forward half of the post-LN layer: FF(relu) → add →
    norm2."""
    ff = _dense(layer.linear2, F.relu(_dense(layer.linear1, x, dtype)), dtype)
    return _layernorm(layer.norm2, x + ff, dtype)


def _embed_scale(model, dtype):
    """The positional table and the 1/√demb scale, both in ``dtype``."""
    pe = model.pe.to(dtype)
    return pe, (1.0 / _scale(model.cfg.demb, torch.float32)).to(dtype).to(pe.device)


def _layers(model):
    return model.encoder_vl.enc_transformer.layers


# --------------------------------------------------------------------------
# Incremental KV decode for the student step loop
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ETFastCache:
    """Decode state carried from step to step (updated in place). The
    language K/V are not here: they are episode constants
    (``make_lang_cache``)."""

    step_k: torch.Tensor      # (layers, B, H, 2T, hd) keys of step tokens
    step_v: torch.Tensor      # (layers, B, H, 2T, hd)
    out_frames: torch.Tensor  # (B, T, D) last-layer frame tokens
    out_dirs: torch.Tensor    # (B, T, D) last-layer direction tokens


def init_cache(cfg, B: int, T: int, dtype=torch.float32, device=None) -> ETFastCache:
    H = cfg.encoder_heads
    hd = cfg.demb // H
    nl = cfg.encoder_layers

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ETFastCache(step_k=z(nl, B, H, 2 * T, hd), step_v=z(nl, B, H, 2 * T, hd),
                       out_frames=z(B, T, cfg.demb), out_dirs=z(B, T, cfg.demb))


def make_lang_cache(model, lang, dtype=torch.float32) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-layer language keys/values — episode constants. Language queries
    attend language only (the reference never masks language padding), so
    the language token stack is run once, caching each layer's K/V."""
    H = model.cfg.encoder_heads
    pe, scale = _embed_scale(model, dtype)
    x = lang.to(dtype) + pe[:lang.shape[1]][None] * scale
    x = _layernorm(model.encoder_vl.enc_layernorm, x, dtype)
    bias = torch.zeros((), dtype=dtype, device=x.device)
    caches = []
    for layer in _layers(model):
        attn_mod = layer.self_attn
        qkv = _dense((attn_mod.in_proj_weight, attn_mod.in_proj_bias), x, dtype)
        q, k, v = (_split_heads(t, H) for t in qkv.chunk(3, dim=-1))
        caches.append((k, v))
        attn = _dense(attn_mod.out_proj, _merge_heads(_attend(q, k, v, bias)), dtype)
        x = _ffn(layer, _layernorm(layer.norm1, x + attn, dtype), dtype)
    return caches


def decode_step(model, lang_kv, cache: ETFastCache, lang_cls, feats_t, dir_feat_t,
                t: int, lengths, dtype=torch.float32):
    """One incremental trunk step: embed and decode the two new tokens
    (frame t, direction t), writing their K/V and last-layer tokens into
    ``cache`` in place, then read out at the batch-max position. Equal to
    the module's full-history call at step t (eval mode).

    ``lengths`` (B,) are the cumulative alive counts after this step's
    update. For a query at position t the full call's causal mask (s ≤ t)
    plus its key padding (s < lengths[b]) collapse to ``s < lengths[b]``
    (lengths ≤ t+1), which also masks the cache slots not yet written.
    Returns ``(cache, action (B, 4), saliency head (B, 8, 8) float32)``."""
    cfg = model.cfg
    T = cache.out_frames.shape[1]
    L = lang_kv[0][0].shape[2]
    H = cfg.encoder_heads

    # ---- embed the two new tokens (models/et.py, one position) ----
    pooled = _softdot_pool(model.attention_layer_vision, lang_cls, feats_t, dtype)
    f_tok = _dense(model.fc2, pooled, dtype)
    d_tok = _dense(model.direction_embedding, dir_feat_t, dtype)
    pe, scale = _embed_scale(model, dtype)
    pos = pe[L + t] * scale
    x = torch.stack([f_tok + pos, d_tok + pos], dim=1)       # (B, 2, D)
    x = _layernorm(model.encoder_vl.enc_layernorm, x, dtype)

    # ---- key validity: written steps below each item's length ----
    step_valid = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
    lang_bias = torch.zeros((), dtype=dtype, device=x.device)
    step_bias = torch.where(torch.cat([step_valid, step_valid], dim=1), 0.0,
                            float("-inf"))[:, None, None, :].to(dtype)

    for i, layer in enumerate(_layers(model)):
        attn_mod = layer.self_attn
        qkv = _dense((attn_mod.in_proj_weight, attn_mod.in_proj_bias), x, dtype)
        qh, kh, vh = (_split_heads(u, H) for u in qkv.chunk(3, dim=-1))
        # the new frame/direction K/V go to sequence slots t and T + t
        cache.step_k[i, :, :, t] = kh[:, :, 0]
        cache.step_k[i, :, :, T + t] = kh[:, :, 1]
        cache.step_v[i, :, :, t] = vh[:, :, 0]
        cache.step_v[i, :, :, T + t] = vh[:, :, 1]
        attn = _attend_two(qh, lang_kv[i][0], lang_kv[i][1], lang_bias,
                           cache.step_k[i], cache.step_v[i], step_bias)
        attn = _dense(attn_mod.out_proj, _merge_heads(attn), dtype)
        x = _ffn(layer, _layernorm(layer.norm1, x + attn, dtype), dtype)

    cache.out_frames[:, t] = x[:, 0]
    cache.out_dirs[:, t] = x[:, 1]

    # ---- readout at the batch-max valid step (models/et.py forward) ----
    m = (lengths.max() - 1).reshape(1)
    vis_tok = cache.out_frames.index_select(1, m)[:, 0]
    dir_tok = cache.out_dirs.index_select(1, m)[:, 0]
    action = model.decoder_2_action_full(dir_tok)
    sal = model.fc(vis_tok)
    return cache, action, sal.reshape(-1, 8, 8).float()
