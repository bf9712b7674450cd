"""HAA-Transformer ("ET") — the episodic-transformer model family (torch
counterpart of ``avdn_tpu/models/et.py``).

The reference ET (src/models/ET_haa.py:77-184) + EncoderVL trunk
(src/models/enc_vl.py:8-83) as one fixed-shape module with the reference's
parameter names:

* history is padded to a static ``T`` steps;
* the per-step language-conditioned spatial attention over Darknet features
  is batched over time (the reference loops in python,
  src/models/ET_haa.py:139-142);
* readout follows the reference: the *visual* token at the batch-max valid
  step feeds the saliency head and the *direction* token there feeds the
  action head (src/models/ET_haa.py:157-167).

Outputs: action (B, 4) = (Δx ratio, Δy ratio, altitude, progress) and
saliency (B, 224, 224), in the compute ``dtype`` (flax's rules,
``models/layers.py``). In train mode dropout runs at the JAX module's sites
(after the input LayerNorm, in every encoder layer, in the action head and
on the saliency projection), its masks drawn from the ``generator`` passed
to ``forward``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from avdn_tpu_torch.models.layers import (
    Dense,
    Dropout,
    LayerNorm,
    MLPHead,
    SoftDotAttention,
    TransformerEncoderLayer,
    add_haa_pos_encoding,
    haa_attention_mask,
    sinusoidal_pos_encoding,
)
from avdn_tpu_torch.parallel.batch import batch_max
from avdn_tpu_torch.utils.logging import span


@dataclasses.dataclass(frozen=True)
class ETConfig:
    demb: int = 768
    encoder_heads: int = 12
    encoder_layers: int = 2
    dropout_transformer: float = 0.1
    dropout_emb: float = 0.0
    spatial_dim: int = 49  # 7x7 darknet grid
    pos_max_len: int = 1250


class _EncoderVL(nn.Module):
    def __init__(self, c: ETConfig, dtype):
        super().__init__()
        self.enc_layernorm = LayerNorm(c.demb, eps=1e-5, dtype=dtype)
        self.enc_transformer = nn.Module()
        self.enc_transformer.layers = nn.ModuleList([
            TransformerEncoderLayer(c.demb, c.encoder_heads, c.demb, dtype,
                                    c.dropout_transformer)
            for _ in range(c.encoder_layers)
        ])


class HAATransformer(nn.Module):
    def __init__(self, cfg: ETConfig = ETConfig(), dtype=torch.float32):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.dtype = dtype
        self.attention_layer_vision = SoftDotAttention(c.spatial_dim, dtype)
        self.fc2 = Dense(c.spatial_dim, c.demb, dtype=dtype)  # frame projection
        # promoted at once by the positional encoding: kept float32
        self.direction_embedding = Dense(2, c.demb, dtype=dtype, keep_f32=True)
        self.encoder_vl = _EncoderVL(c, dtype)
        # the rollout promotes the action at once: its last layer stays float32
        self.decoder_2_action_full = MLPHead(c.demb, (256, 32, 4), dtype=dtype,
                                             keep_f32=True)
        self.fc = nn.Sequential(Dense(c.demb, 64, dtype=dtype), nn.ReLU())  # saliency
        self.emb_dropout = Dropout(c.dropout_emb)
        self.saliency_dropout = Dropout(0.2)
        self.register_buffer(
            "pe", sinusoidal_pos_encoding(c.pos_max_len, c.demb), persistent=False)

    def encode(
        self,
        lang,          # (B, L, demb) BERT token features
        lang_cls,      # (B, 49) BERT 49-d head (spatial attention query)
        frames,        # (B, T, C, 49) darknet features, channel-major
        directions,    # (B, T, 2) (sin, cos) headings
        lengths,       # (B,) valid history length per item (>= 1)
        generator=None,
    ):
        """The trunk: embeddings, positional encoding and the encoder layers
        over the ``[lang | frames | directions]`` sequence. Returns the last
        layer's tokens, (B, L + 2T, demb)."""
        c = self.cfg
        B, T = frames.shape[0], frames.shape[1]
        L = lang.shape[1]

        # ---- language-conditioned spatial pooling of each history frame ----
        flat_frames = frames.reshape(B * T, frames.shape[2], c.spatial_dim)
        flat_query = lang_cls.repeat_interleave(T, dim=0)
        pooled, _ = self.attention_layer_vision(flat_query, flat_frames)
        emb_frames = self.fc2(pooled).reshape(B, T, c.demb)
        emb_dirs = self.direction_embedding(directions)

        # ---- positional encoding + trunk input ----
        lang_pe, emb_frames, emb_dirs = add_haa_pos_encoding(
            lang, emb_frames, emb_dirs, self.pe.to(self.dtype))
        seq = torch.cat([lang_pe, emb_frames, emb_dirs], dim=1)
        seq = self.emb_dropout(self.encoder_vl.enc_layernorm(seq), generator)

        # ---- masks: the reference never masks language padding in the
        # trunk (src/models/enc_vl.py:49-55 masks only frames/directions) ----
        attn_mask = haa_attention_mask(L, T, device=seq.device)
        step_pad = torch.arange(T, device=seq.device)[None, :] >= lengths[:, None]
        lang_pad = torch.zeros((B, L), dtype=torch.bool, device=seq.device)
        key_pad = torch.cat([lang_pad, step_pad, step_pad], dim=1)
        for layer in self.encoder_vl.enc_transformer.layers:
            seq = layer(seq, attn_mask, key_pad, generator)
        return seq

    def readout(self, vis_tok, dir_tok, generator=None):
        """Visual token → the (N, 8, 8) saliency head, before its upsample to
        (N, 224, 224) (``ops.saliency.saliency_upsample``, which the rollouts
        run in ``saliency_head_reductions``); direction token → action
        (N, 4)."""
        action = self.decoder_2_action_full(dir_tok, generator)
        sal = self.fc[1](self.saliency_dropout(self.fc[0](vis_tok), generator))
        return action, sal.reshape(-1, 8, 8)

    def forward(self, lang, lang_cls, frames, directions, lengths, generator=None):
        """One step's outputs: the trunk over the padded history, read out at
        the batch-max valid step (ET_haa.py:157-158)."""
        with span("models.trunk"):
            L, T = lang.shape[1], frames.shape[1]
            seq = self.encode(lang, lang_cls, frames, directions, lengths, generator)
            max_len = batch_max(lengths.max())  # over the global batch in a DP step
            vis_tok = seq.index_select(1, (L + max_len - 1).reshape(1))[:, 0]
            dir_tok = seq.index_select(1, (L + T + max_len - 1).reshape(1))[:, 0]
            return self.readout(vis_tok, dir_tok, generator)
