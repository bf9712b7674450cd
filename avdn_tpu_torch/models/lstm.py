"""HAA-LSTM model family — single-step recurrent cells (torch counterpart of
``avdn_tpu/models/lstm.py``).

``ViT_LSTM`` and its ablation variants (src/models/vln_model.py:163-413) with
the reference's parameter names (``compat/from_jax.py:lstm_state_dict``), so
released and exported checkpoints load strictly. As in the JAX package the
Darknet tower runs outside the cell (the rollout owns it); the cell reads the
(B, C, 49) feature map and the heading in radians (the JAX cells take
degrees and convert them; see :func:`heading_radians` for the rollouts'
angle). State: ``(h_dir, c_dir, h_vis, c_vis)`` of widths (192, 192, 576,
576), float32 from ``init_lstm_state``.

Compute dtype as in ``models/layers.py``: float32 parameters, each ``Dense``
computing in ``dtype``. In bfloat16 the gates, ``i``, ``g`` and their product
round as XLA computes flax's (the sigmoid as ``1 / (1 + exp(−x))`` with each
op rounded), while ``f·c`` and ``o·tanh(c)`` promote to float32 with the
float32 state (jnp's rule), so the carried state stays float32; ``f``, ``o``
and ``i·g`` are promoted at once, so their last op is not rounded.

The saliency output is the (B, 8, 8) head, before its upsample to (B, 224,
224) (``ops/saliency.py:saliency_head_reductions`` runs both in the
rollouts). Quirks kept from the reference: the vision dropout feeds the
vision LSTM only (the saliency head reads the undropped pooled map), the
language attention takes no token mask, and π is 3.14159.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from avdn_tpu_torch.models.layers import Dense, Dropout, MLPHead, SoftDotAttention, dense
from avdn_tpu_torch.utils.logging import span

_PI_REF = 3.14159  # reference constant (vln_model.py:229)


@dataclasses.dataclass(frozen=True)
class LSTMConfig:
    hidden_size: int = 768
    spatial_dim: int = 49
    dir_embed: int = 32
    dir_hidden: int = 192
    vis_hidden: int = 576


def init_lstm_state(batch: int, cfg: LSTMConfig = LSTMConfig(), device=None):
    """The zero state ``(h_dir, c_dir, h_vis, c_vis)``, float32."""
    return tuple(torch.zeros((batch, w), dtype=torch.float32, device=device)
                 for w in (cfg.dir_hidden, cfg.dir_hidden, cfg.vis_hidden, cfg.vis_hidden))


class TorchLSTMCell(nn.Module):
    """LSTM cell with ``torch.nn.LSTMCell``'s parameters (``weight_ih``,
    ``bias_ih``, ``weight_hh``, ``bias_hh``; gate order i, f, g, o), written
    as the JAX module computes it: ``dense(x, W_ih, b_ih) + dense(h, W_hh,
    b_hh)`` (ATen's fused cell sums the four terms in another order and has
    no bfloat16 rounding points)."""

    def __init__(self, input_size: int, hidden_size: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden_size, input_size))
        self.bias_ih = nn.Parameter(torch.zeros(4 * hidden_size))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden_size, hidden_size))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden_size))
        for w in (self.weight_ih, self.weight_hh):
            nn.init.normal_(w, std=1.0 / math.sqrt(w.shape[1]))

    def forward(self, x, state):
        h, c = state
        gates = (dense(x, self.weight_ih, self.bias_ih, self.dtype)
                 + dense(h, self.weight_hh, self.bias_hh, self.dtype))
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        if gates.dtype == c.dtype:
            i, f, g, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg), torch.sigmoid(go)
            new_c = f * c + i * g
        else:
            # f, o and i·g are promoted at once: their last op unrounded
            f, o = _sigmoid(gf, c.dtype), _sigmoid(go, c.dtype)
            new_c = f * c + _sigmoid(gi).to(c.dtype) * torch.tanh(gg).to(c.dtype)
        return o * torch.tanh(new_c), new_c


def _sigmoid(x, out_dtype=None):
    """``jax.nn.sigmoid`` of a bfloat16 ``x`` as XLA computes it:
    ``1 / (1 + exp(−x))`` with the exponential and the sum rounded to
    bfloat16, and the quotient too unless it is promoted to ``out_dtype`` at
    once."""
    d = 1.0 + torch.exp(-x)
    return 1.0 / (d if out_dtype is None else d.to(out_dtype))


#: degrees → radians as XLA folds the JAX cells' ``/ 180.0 * π``: one
#: float32 constant that multiplies
DEG_TO_RAD = float(torch.tensor(_PI_REF) / torch.tensor(180.0))


def heading_radians(dir_feat):
    """The heading the rollouts hand the cells, from the engine's (sin, cos)
    features (B, 2): ``atan2(sin, cos)`` (B, 1), so zeroed features
    (``--no_direction``) give 0 and the cell sees (sin, cos) = (0, 1). The
    JAX closures pass ``atan2(·)/π·180`` degrees and the JAX cells multiply
    by π/180; in one program XLA folds the two constants, whose float32
    product is 1, so the angle the cells see is ``atan2`` itself."""
    return torch.atan2(dir_feat[:, 0:1], dir_feat[:, 1:2])


def _direction_features(heading):
    """(sin, cos) (B, 2) of the heading (B, 1) in radians."""
    return torch.cat([torch.sin(heading), torch.cos(heading)], dim=-1)


class HAALSTM(nn.Module):
    """Full HAA-LSTM cell (vln_model.py:163-250).

    ``forward(heading (B, 1), im_feature (B, C, 49), lang_cls (B, 49),
    lang (B, L, hidden), state, generator)`` → ``(new_state, action (B, 4),
    saliency head (B, 8, 8))``. The heading is in radians (the JAX cell
    takes degrees: ``DEG_TO_RAD`` times them, or in the rollouts
    :func:`heading_radians`); dropout (train mode) draws from
    ``generator``."""

    def __init__(self, cfg: LSTMConfig = LSTMConfig(), dtype=torch.float32):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.dtype = dtype
        joint = c.dir_hidden + c.vis_hidden
        self.attention_layer_vision = SoftDotAttention(c.spatial_dim, dtype)
        self.vision_dropout = Dropout(0.2)
        self.vision_lstm = TorchLSTMCell(c.spatial_dim, c.vis_hidden, dtype)
        self.direction_embedding = Dense(2, c.dir_embed, dtype=dtype)
        self.direct_lstm = TorchLSTMCell(c.dir_embed, c.dir_hidden, dtype)
        self.attention_layer_lang = SoftDotAttention(c.hidden_size, dtype, query_dim=joint)
        # the rollout promotes the action at once: its last layer stays float32
        self.decoder_2_action_full = MLPHead(c.hidden_size, (256, 32, 4), dtype=dtype,
                                             keep_f32=True)
        self.fc = MLPHead(c.spatial_dim, (128, 64), relu_last=True, dtype=dtype)

    def forward(self, heading, im_feature, lang_cls, lang, state, generator=None):
        with span("models.trunk"):
            h_dir, c_dir, h_vis, c_vis = state
            pooled, _ = self.attention_layer_vision(lang_cls, im_feature)
            h_vis, c_vis = self.vision_lstm(self.vision_dropout(pooled, generator),
                                            (h_vis, c_vis))
            dir_emb = self.direction_embedding(_direction_features(heading))
            h_dir, c_dir = self.direct_lstm(dir_emb, (h_dir, c_dir))
            joint = torch.cat([h_dir, h_vis], dim=-1)
            attended, _ = self.attention_layer_lang(joint, lang)
            action = self.decoder_2_action_full(attended, generator)
            sal = self.fc(pooled, generator)
            return (h_dir, c_dir, h_vis, c_vis), action, sal.reshape(-1, 8, 8)


class HAALSTMVisionOnly(nn.Module):
    """Vision-only ablation (vln_model.py:255-343): the spatial-attention
    query comes from the hidden state (``state_query``, joint → 49, ReLU)
    instead of language, and the action reads the joint hidden state.
    ``forward(heading, im_feature, state, generator)``."""

    def __init__(self, cfg: LSTMConfig = LSTMConfig(), dtype=torch.float32):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.dtype = dtype
        joint = c.dir_hidden + c.vis_hidden
        self.state_query = Dense(joint, c.spatial_dim, dtype=dtype)
        self.attention_layer_vision = SoftDotAttention(c.spatial_dim, dtype)
        self.vision_dropout = Dropout(0.2)
        self.vision_lstm = TorchLSTMCell(c.spatial_dim, c.vis_hidden, dtype)
        self.direction_embedding = Dense(2, c.dir_embed, dtype=dtype)
        self.direct_lstm = TorchLSTMCell(c.dir_embed, c.dir_hidden, dtype)
        self.decoder_2_action_full = MLPHead(joint, (256, 32, 4), dtype=dtype,
                                             keep_f32=True)
        self.fc = MLPHead(c.spatial_dim, (128, 64), relu_last=True, dtype=dtype)

    def forward(self, heading, im_feature, state, generator=None):
        with span("models.trunk"):
            h_dir, c_dir, h_vis, c_vis = state
            query = torch.relu(self.state_query(torch.cat([h_dir, h_vis], dim=-1)))
            pooled, _ = self.attention_layer_vision(query, im_feature)
            h_vis, c_vis = self.vision_lstm(self.vision_dropout(pooled, generator),
                                            (h_vis, c_vis))
            dir_emb = self.direction_embedding(_direction_features(heading))
            h_dir, c_dir = self.direct_lstm(dir_emb, (h_dir, c_dir))
            action = self.decoder_2_action_full(torch.cat([h_dir, h_vis], dim=-1), generator)
            sal = self.fc(pooled, generator)
            return (h_dir, c_dir, h_vis, c_vis), action, sal.reshape(-1, 8, 8)


class HAALSTMLangOnly(nn.Module):
    """Language-only ablation (vln_model.py:349-412): one direction LSTM of
    width ``hidden_size`` whose hidden state attends over the language
    tokens. No saliency head. State ``(h, c)``; ``forward(heading, lang,
    state, generator)`` → ``(new_state, action)``."""

    def __init__(self, cfg: LSTMConfig = LSTMConfig(), dtype=torch.float32):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.dtype = dtype
        self.direction_embedding = Dense(2, c.dir_embed, dtype=dtype)
        self.direct_lstm = TorchLSTMCell(c.dir_embed, c.hidden_size, dtype)
        self.attention_layer_lang = SoftDotAttention(c.hidden_size, dtype)
        self.decoder_2_action_full = MLPHead(c.hidden_size, (256, 32, 4), dtype=dtype,
                                             keep_f32=True)

    def forward(self, heading, lang, state, generator=None):
        with span("models.trunk"):
            dir_emb = self.direction_embedding(_direction_features(heading))
            h, cc = self.direct_lstm(dir_emb, state)
            attended, _ = self.attention_layer_lang(h, lang)
            return (h, cc), self.decoder_2_action_full(attended, generator)
