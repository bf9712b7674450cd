# Frozen copy of avdn_tpu_torch/utils/flops.py at commit d6443de (the MFU
# numerator), its config classes taken from the benchmark's reference copy.
"""Analytic model-FLOP counts for the HAA pipelines: the port's copy of
``avdn_tpu/utils/flops.py`` over the port's configs, and the MFU numerator.

A profiler's count of a rollout depends on how the step loop is run; the
pipeline is closed-form — Darknet convs from the cfg walk, BERT-base per
(B, L), the ET trunk per (L, T) — so it is counted exactly, and the count
is the same for the step, fused and time-fused paths.

Convention (the standard MFU bookkeeping): one multiply-add = 2 FLOPs;
only contractions (conv / matmul / attention einsums) are counted —
elementwise ops, softmax, norms, and the renderer are excluded. Backward
pass = 2× forward (d/dinputs + d/dweights), so a train step counts 3× its
forward FLOPs.

Cross-checked against ``torch.utils.flop_counter.FlopCounterMode`` on
loop-free forwards in tests/test_torch_flops.py, and equal to the JAX
package's counts for the same configs.
"""

from __future__ import annotations

from typing import Optional

from reference.models.bert import BertConfig
from reference.models.darknet import DarknetConfig
from reference.models.et import ETConfig
from reference.models.lstm import LSTMConfig


def darknet_forward_flops(cfg: DarknetConfig, batch: int = 1) -> float:
    """One Darknet forward at ``cfg.img_size``: walk the cfg blocks exactly
    like the network constructor (models/darknet.py) tracking (H, W, C)."""
    blocks = cfg.block_dicts()
    assert blocks[0]["type"] == "net"
    H = W = cfg.img_size
    C = int(blocks[0].get("channels", "3"))
    flops = 0.0
    shapes = [(H, W, C)]  # index 0 = input, like the constructor's `outputs`
    for b in blocks[1:]:
        t = b["type"]
        if t == "convolutional":
            k = int(b["size"])
            s = int(b["stride"])
            p = (k - 1) // 2 if int(b["pad"]) else 0
            Ho = (H + 2 * p - k) // s + 1
            Wo = (W + 2 * p - k) // s + 1
            f = int(b["filters"])
            flops += 2.0 * k * k * C * f * Ho * Wo
            H, W, C = Ho, Wo, f
        elif t == "upsample":
            s = int(b["stride"])
            H, W = H * s, W * s
        elif t == "route":
            layers = [int(v) for v in b["layers"].split(",")]
            # the constructor indexes into per-layer outputs; replicate (negative
            # indices relative to the *layer* list, i.e. shapes[1:])
            layer_shapes = shapes[1:]
            refs = [layer_shapes[li] for li in layers]
            H, W = refs[0][0], refs[0][1]
            C = sum(r[2] for r in refs)
        elif t == "shortcut":
            pass  # elementwise add
        elif t == "maxpool":
            s = int(b["stride"])
            H, W = -(-H // s), -(-W // s)  # SAME padding
        elif t == "yolo":
            pass
        else:
            raise ValueError(f"unsupported block type: {t}")
        shapes.append((H, W, C))
    return batch * flops


def bert_forward_flops(cfg: BertConfig, batch: int, seq_len: int) -> float:
    """One ``BertLanguageEncoder`` forward on (batch, seq_len) tokens:
    per layer QKV/out projections + attention einsums + FFN, plus the
    pooler and the CustomBERTModel 768→64→49 head."""
    d, L, ff = cfg.hidden_size, seq_len, cfg.intermediate_size
    per_layer = (
        4 * 2 * L * d * d        # Q, K, V, out projections
        + 2 * 2 * L * L * d      # scores + attn·V
        + 2 * 2 * L * d * ff     # FFN in + out
    )
    pooler = 2 * d * d
    head = 2 * (d * cfg.head_dims[0]
                + cfg.head_dims[0] * cfg.head_dims[1])
    return batch * (cfg.num_layers * per_layer + pooler + head)


def et_trunk_flops(cfg: ETConfig, batch: int, lang_len: int, T: int,
                   feat_ch: int) -> float:
    """One ``HAATransformer`` forward: per-frame spatial attention +
    embeddings, then ``encoder_layers`` trunk layers over S = L + 2T tokens
    (ff_dim = demb, matching the reference's nn.TransformerEncoder)."""
    d, S, sp = cfg.demb, lang_len + 2 * T, cfg.spatial_dim
    # language-conditioned spatial attention over the (feat_ch, 49) frame
    vis_attn = 2 * sp * sp + 4 * feat_ch * sp + 2 * (2 * sp) * sp
    frame = vis_attn + 2 * sp * d          # + frame_proj
    dirs = 2 * 2 * d                       # direction embedding
    trunk_layer = 4 * 2 * S * d * d + 2 * 2 * S * S * d + 2 * 2 * S * d * d
    heads = 2 * (d * 256 + 256 * 32 + 32 * 4) + 2 * d * 64
    return batch * (T * (frame + dirs)
                    + cfg.encoder_layers * trunk_layer + heads)


def lstm_step_flops(cfg: LSTMConfig, batch: int, lang_len: int,
                    feat_ch: int) -> float:
    """One ``HAALSTM`` cell step: spatial attention, two LSTM cells,
    language attention over the token sequence, and the heads."""
    sp, d = cfg.spatial_dim, cfg.hidden_size
    vis_attn = 2 * sp * sp + 4 * feat_ch * sp + 2 * (2 * sp) * sp
    vis_lstm = 2 * 4 * (sp * cfg.vis_hidden
                        + cfg.vis_hidden * cfg.vis_hidden)
    dir_lstm = 2 * 4 * (cfg.dir_embed * cfg.dir_hidden
                        + cfg.dir_hidden * cfg.dir_hidden)
    lang_attn = 2 * d * d + 4 * lang_len * d + 2 * (2 * d) * d
    heads = 2 * (d * 256 + 256 * 32 + 32 * 4) \
        + 2 * (sp * 128 + 128 * 64)
    return batch * (vis_attn + vis_lstm + dir_lstm + lang_attn + heads
                    + 2 * 2 * cfg.dir_embed)


def eval_rollout_flops(
    bert_cfg: BertConfig,
    dk_cfg: DarknetConfig,
    vln_cfg,                     # ETConfig | LSTMConfig
    batch: int,
    T: int,
    instr_len: int,
    dialog_len: Optional[int] = None,
    feat_ch: int = 512,
    one_pass_trunk: bool = False,
    single_bert_pass: bool = False,
) -> float:
    """Model FLOPs of one eval rollout: the two BERT passes (instructions +
    dialog — agent.py:521-538), T Darknet forwards, and the VLN model.

    ET: the default student eval re-encodes the full padded history every
    step → T trunk passes; ``one_pass_trunk`` counts the exact causal
    reformulation (models/et_fast.py) used by the teacher-forced HA eval —
    ONE trunk pass. LSTM: T cell steps either way.
    """
    f = bert_forward_flops(bert_cfg, batch, instr_len)
    if not single_bert_pass:
        f += bert_forward_flops(bert_cfg, batch,
                                dialog_len if dialog_len else instr_len)
    f += T * darknet_forward_flops(dk_cfg, batch)
    if isinstance(vln_cfg, ETConfig):
        n_trunk = 1 if one_pass_trunk else T
        f += n_trunk * et_trunk_flops(vln_cfg, batch, instr_len, T, feat_ch)
    else:
        f += T * lstm_step_flops(vln_cfg, batch, instr_len, feat_ch)
    return f


def train_step_flops(
    bert_cfg: BertConfig,
    dk_cfg: DarknetConfig,
    vln_cfg,
    batch: int,
    T: int,
    instr_len: int,
    dialog_len: Optional[int] = None,
    feat_ch: int = 512,
    double_rollout: bool = True,
    single_bert_pass: bool = False,
) -> float:
    """Model FLOPs of one train step: BERT passes are shared by the teacher
    and student rollouts (train/step.py ``_encode_language`` runs once),
    each rollout runs T Darknet forwards and — training mode always uses the
    full re-encode (dropout) — T trunk passes; backward = 2x forward."""
    f = bert_forward_flops(bert_cfg, batch, instr_len)
    if not single_bert_pass:
        f += bert_forward_flops(bert_cfg, batch,
                                dialog_len if dialog_len else instr_len)
    n_roll = 2 if double_rollout else 1
    per_roll = T * darknet_forward_flops(dk_cfg, batch)
    if isinstance(vln_cfg, ETConfig):
        per_roll += T * et_trunk_flops(vln_cfg, batch, instr_len, T, feat_ch)
    else:
        per_roll += T * lstm_step_flops(vln_cfg, batch, instr_len, feat_ch)
    return 3.0 * (f + n_roll * per_roll)
