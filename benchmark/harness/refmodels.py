"""The reference's side of a run: its models, configs, batches and map bank,
built from the run's flags and the benchmark's inputs alone (the
reference's own copies of the port's model classes, loader, tokenizer and
batcher; nothing the port made)."""

from __future__ import annotations

import torch

from harness.flops import eval_rollout_flops, train_step_flops
from reference.data.annotations import ANDHDataset
from reference.data.batcher import BatcherConfig, make_train_batch
from reference.data.tokenizer import WordPieceTokenizer
from reference.models.bert import BertConfig, BertLanguageEncoder
from reference.models.darknet import Darknet, DarknetConfig, output_channels
from reference.models.et import ETConfig, HAATransformer
from reference.models.lstm import HAALSTM, LSTMConfig
from reference.train.step import TrainConfig


def configs(flags: dict, family: str):
    """The towers' and the VLN model's configs at the flags' widths (the
    port's ``build_models`` rule; the Darknet from ``darknet_model_file``
    where the flags name one): ``(bert, darknet, vln)``."""
    demb, layers = flags["demb"], flags["bert_layers"]
    if demb == 768 and layers == 12:
        bert_cfg = BertConfig()
    else:
        bert_cfg = BertConfig(hidden_size=demb, num_layers=layers,
                              num_heads=flags["encoder_heads"], intermediate_size=demb * 2)
    darknet_cfg = flags.get("darknet_model_file")
    if darknet_cfg:
        with open(darknet_cfg) as f:
            dk_cfg = DarknetConfig.from_text(f.read(), img_size=224)
    else:
        dk_cfg = DarknetConfig.default(img_size=224)
    if family == "lstm":
        vln_cfg = LSTMConfig(hidden_size=demb)
    else:
        vln_cfg = ETConfig(demb=demb, encoder_heads=flags["encoder_heads"],
                           encoder_layers=flags["encoder_layers"],
                           dropout_transformer=flags["dropout_transformer_encoder"],
                           dropout_emb=flags["dropout_emb"])
    return bert_cfg, dk_cfg, vln_cfg


def step_flops(flags: dict, family: str, kind: str) -> float:
    """Model FLOPs of one train step (``kind`` "train") or of one nav plus
    one fused HA eval batch ("valid"), by the frozen counts."""
    bert_cfg, dk_cfg, vln_cfg = configs(flags, family)
    shape = (flags["batch_size"], flags["max_action_len"], flags["max_instr_len"])
    kw = dict(dialog_len=flags["dialog_pad"], feat_ch=output_channels(dk_cfg)[-1])
    if kind == "train":
        return train_step_flops(bert_cfg, dk_cfg, vln_cfg, *shape, **kw)
    return (eval_rollout_flops(bert_cfg, dk_cfg, vln_cfg, *shape, **kw)
            + eval_rollout_flops(bert_cfg, dk_cfg, vln_cfg, *shape, one_pass_trunk=True, **kw))


def build_models(flags: dict, family: str, device, bf16: bool):
    """BERT, Darknet and the VLN model at the flags' widths, float32
    parameters computing in bf16 with ``bf16``, in eval mode."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    bert_cfg, dk_cfg, vln_cfg = configs(flags, family)
    vln = (HAALSTM(vln_cfg, dtype=dtype) if family == "lstm"
           else HAATransformer(vln_cfg, dtype=dtype))
    models = (BertLanguageEncoder(bert_cfg, dtype), Darknet(dk_cfg, dtype=dtype), vln)
    return tuple(m.to(device).eval() for m in models)


def train_config(flags: dict, family: str, eval_mode: bool = False,
                 render_crop: int = 512) -> TrainConfig:
    """The port's train (or eval and serving) config of the flags: exact
    render in training, two-pass in eval unless ``render_twopass`` is
    False."""
    lstm = family == "lstm"
    twopass = flags.get("render_twopass")
    return TrainConfig(
        family=family, feedback=flags["feedback"], lr=flags["lr"], optim=flags["optim"],
        ml_weight=flags["ml_weight"], nss_w=flags["nss_w"], nss_r=flags["nss_r"],
        max_action_len=flags["max_action_len"], student_stop=0.25 if lstm else 0.5,
        darknet_in_vln=lstm,
        render_twopass=(twopass is not False) if eval_mode else twopass is True,
        render_crop=render_crop)


def batcher_config(flags: dict) -> BatcherConfig:
    return BatcherConfig(max_gt_len=flags["max_gt_len"], max_circles=flags["max_circles"],
                         instr_pad=flags["max_instr_len"], dialog_pad=flags["dialog_pad"],
                         lang_dim=flags["demb"])


class Bank:
    """All of a run's maps on the device, one slot each, in slots of the
    port's bank size (the two-pass crop window is clamped to the slot)."""

    def __init__(self, maps: dict, bank_px: int, device):
        self.slot_of = {name: i for i, name in enumerate(sorted(maps))}
        self.array = torch.zeros((len(maps), bank_px, bank_px, 3), dtype=torch.uint8,
                                 device=device)
        for name, img in maps.items():
            h, w = img.shape[:2]
            self.array[self.slot_of[name], :h, :w] = torch.from_numpy(img).to(device)


def batches(anno_dir: str, split: str, batch_size: int, seed: int, flags: dict,
            device, slot_of: dict):
    """The split's batches in the port's order (its loader's seeded
    shuffle), built by the reference's batcher: ``(items, batch, meta)``."""
    env = ANDHDataset(anno_dir, [split], batch_size, seed=seed)
    tok = WordPieceTokenizer.fallback()
    bcfg = batcher_config(flags)
    for items in env:
        batch, meta = make_train_batch(items, tok, slot_of, bcfg, device=device)
        yield items, batch, meta
