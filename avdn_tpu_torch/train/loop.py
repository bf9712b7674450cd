"""Model building and eval configuration helpers (torch counterpart of the
helpers in ``avdn_tpu/train/loop.py``; the train and validation drivers are
not ported yet, ROADMAP.md queue 1 items 8 and 10).

Numerics of this slice: the exact render in fp32. An unset ``--bf16`` or
``--render_twopass`` means bf16 towers and the two-pass render for
eval/serving on an accelerator, as in the JAX package; the port raises for
them instead of quietly running another mode.
"""

from __future__ import annotations

import math
import os

import torch
from torch import nn

from avdn_tpu_torch.config import Args
from avdn_tpu_torch.data.batcher import BatcherConfig
from avdn_tpu_torch.models.bert import BertConfig, BertLanguageEncoder
from avdn_tpu_torch.models.darknet import Darknet, DarknetConfig
from avdn_tpu_torch.models.et import ETConfig, HAATransformer
from avdn_tpu_torch.train.step import TrainConfig


def eval_bf16(args: Args, device: torch.device) -> bool:
    """bf16 towers for eval/serving? Unset means bf16 on the card and fp32
    on the CPU (the JAX package's rule, ``eval_bf16``). bf16 is ROADMAP.md
    queue 1 item 9, so it raises wherever it would be chosen."""
    flag = args.bf16
    if flag is None:
        flag = device.type != "cpu"
    if flag:
        raise NotImplementedError(
            "bf16 towers are ROADMAP.md queue 1 item 9; pass --bf16 False "
            "for fp32" + (" (unset --bf16 means bf16 on the card)"
                          if args.bf16 is None else ""))
    return False


def check_supported(args: Args, device: torch.device) -> None:
    """Raise ``NotImplementedError`` for every flag this slice cannot run,
    naming the ROADMAP.md item that brings it."""
    eval_bf16(args, device)
    if args.world_size > 1:
        raise NotImplementedError(
            "multi-process and data-parallel runs are ROADMAP.md queue 1 item 14")
    if args.family != "et":
        raise NotImplementedError(
            f"--family {args.family}: the LSTM family is ROADMAP.md queue 1 item 11")


def build_models(args: Args, device: torch.device):
    """BERT, Darknet and the ET trunk at the flag widths, fp32, on ``device``
    (in eval mode)."""
    if args.demb == 768 and args.bert_layers == 12:
        bert_cfg = BertConfig()
    else:
        bert_cfg = BertConfig(hidden_size=args.demb, num_layers=args.bert_layers,
                              num_heads=args.encoder_heads,
                              intermediate_size=args.demb * 2)
    if args.darknet_model_file and os.path.exists(args.darknet_model_file):
        with open(args.darknet_model_file) as f:
            dk_cfg = DarknetConfig.from_text(f.read(), img_size=224)
    else:
        dk_cfg = DarknetConfig.default(img_size=224)
    vln = HAATransformer(ETConfig(demb=args.demb, encoder_heads=args.encoder_heads,
                                  encoder_layers=args.encoder_layers))
    models = (BertLanguageEncoder(bert_cfg), Darknet(dk_cfg), vln)
    return tuple(m.to(device).eval() for m in models)


@torch.no_grad()
def init_state(models, generator: torch.Generator) -> None:
    """Random weights from ``generator`` (the JAX package's init scheme:
    LeCun-normal weights, zero biases, unit norms, embeddings of std
    1/√features; BatchNorm at identity statistics). Draws on the CPU so the
    same seed gives the same weights on every device."""
    for model in models:
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                fan_in = mod.weight[0].numel()
                w = torch.randn(mod.weight.shape, generator=generator)
                mod.weight.copy_(w / math.sqrt(fan_in))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                w = torch.randn(mod.weight.shape, generator=generator)
                mod.weight.copy_(w / math.sqrt(mod.weight.shape[1]))
            elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
                mod.reset_parameters()
                if isinstance(mod, nn.BatchNorm2d):
                    mod.reset_running_stats()
        for name, p in model.named_parameters():
            if name.endswith("in_proj_weight"):
                fan_in = p.shape[1]
                p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(fan_in))
            elif name.endswith("in_proj_bias"):
                p.zero_()


def eval_config_from_args(args: Args) -> TrainConfig:
    """The eval/serving config: the render mode is two-pass unless
    ``--render_twopass False``, as in the JAX package's eval default."""
    return TrainConfig(
        family=args.family,
        nss_r=args.nss_r,
        max_action_len=args.max_action_len,
        single_bert_pass=args.train_val_on_full,
        language_only=args.language_only,
        no_direction=args.no_direction,
        render_subsample=args.render_subsample,
        render_twopass=args.render_twopass is not False,
        fold_bn_eval=args.fold_bn_eval,
        fused_teacher=args.fused_teacher,
        et_decode_trunk=args.et_decode_trunk,
        quant=args.quant,
    )


def batcher_config(args: Args) -> BatcherConfig:
    return BatcherConfig(
        max_gt_len=args.max_gt_len,
        max_circles=args.max_circles,
        instr_pad=args.max_instr_len,
        dialog_pad=args.dialog_pad,
        lang_dim=args.demb,
        vision_only=args.vision_only,
        single_bert_pass=args.train_val_on_full,
    )
