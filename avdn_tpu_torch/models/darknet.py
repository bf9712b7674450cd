"""Darknet/YOLOv3 vision tower — cfg-driven conv stack (torch counterpart of
``avdn_tpu/models/darknet.py``).

The reference parses a darknet ``.cfg`` at runtime into torch modules and
uses the network purely as a feature extractor: its forward returns the LAST
layer's activation, which for the released xView config at 224 input is a
(B, 512, 7, 7) conv feature map (src/models/dark_net.py:201-240; callers
flatten to (B, 512, 49), src/xview_et/agent.py:593-594).

This implementation parses the same cfg format, builds the modules with the
reference's names (``module_list.{i}.conv_{i}``,
``module_list.{i}.batch_norm_{i}``) and computes in NCHW inside. At the
module boundary it takes the NHWC views the rollout engine renders and
returns channel-major (B, C, H*W) features, like the JAX tower, in the
compute ``dtype``: as flax's ``nn.Conv(dtype=...)``, each conv casts input,
kernel and bias to it (float32 parameters).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from avdn_tpu_torch.parallel import batch


def parse_darknet_cfg(text: str) -> List[Dict[str, str]]:
    """Parse darknet cfg text into a list of block dicts (same grammar as the
    reference parser, src/models/dark_net.py:243-261)."""
    blocks: List[Dict[str, str]] = []
    for raw in text.split("\n"):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("["):
            blocks.append({"type": line[1:-1].strip()})
            if blocks[-1]["type"] == "convolutional":
                blocks[-1]["batch_normalize"] = "0"
        else:
            k, v = line.split("=", 1)
            blocks[-1][k.strip()] = v.strip()
    return blocks


def _res_block(ch: int) -> str:
    half = ch // 2
    return f"""
[convolutional]
batch_normalize=1
filters={half}
size=1
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters={ch}
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-3
activation=linear
"""


def default_xview_cfg() -> str:
    """Generated darknet-53 feature-extractor config: backbone to 1024@/32
    plus the YOLOv3 stride-32 conv head ending at 512 channels — i.e. a
    (B, 512, 7, 7) output at 224 input, matching the shape contract of the
    released xView config (SURVEY.md §2.1 #8)."""
    parts = [
        """
[net]
channels=3
height=224
width=224
""",
        """
[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky
""",
    ]
    stages = [(64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)]
    for ch, nres in stages:
        parts.append(
            f"""
[convolutional]
batch_normalize=1
filters={ch}
size=3
stride=2
pad=1
activation=leaky
"""
        )
        parts.extend(_res_block(ch) for _ in range(nres))
    # stride-32 YOLO head conv set, cut at the final 512 feature map
    for f, s in [(512, 1), (1024, 3), (512, 1), (1024, 3), (512, 1)]:
        parts.append(
            f"""
[convolutional]
batch_normalize=1
filters={f}
size={s}
stride=1
pad=1
activation=leaky
"""
        )
    return "".join(parts)


@dataclasses.dataclass(frozen=True)
class DarknetConfig:
    blocks: tuple  # tuple of frozen block dicts (hashable for flax)
    img_size: int = 224

    @staticmethod
    def from_text(text: str, img_size: int = 224) -> "DarknetConfig":
        blocks = parse_darknet_cfg(text)
        return DarknetConfig(
            blocks=tuple(tuple(sorted(b.items())) for b in blocks), img_size=img_size
        )

    @staticmethod
    def default(img_size: int = 224) -> "DarknetConfig":
        return DarknetConfig.from_text(default_xview_cfg(), img_size)

    @staticmethod
    def tiny(img_size: int = 224) -> "DarknetConfig":
        """Small tower for tests: 4 convs + shortcut + route → (B, 64, 7, 7)."""
        txt = """
[net]
channels=3
height=224
width=224

[convolutional]
batch_normalize=1
filters=16
size=3
stride=4
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=3
stride=4
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-3
activation=linear

[convolutional]
batch_normalize=1
filters=64
size=3
stride=2
pad=1
activation=leaky
"""
        return DarknetConfig.from_text(txt, img_size)

    def block_dicts(self) -> List[Dict[str, str]]:
        return [dict(b) for b in self.blocks]



class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` like flax's ``nn.Conv``: in a
    reduced type the convolution is rounded before the bias is added, as
    XLA does."""

    def __init__(self, *args, dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.dtype = dtype

    def forward(self, x):
        if self.dtype == torch.float32:
            return super().forward(x)
        y = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), None,
                     self.stride, self.padding)
        return y if self.bias is None else y + self.bias.to(self.dtype)[:, None, None]


#: flax's ``BatchNorm(momentum=...)`` of the JAX tower (``bn_momentum``):
#: the running statistics keep 0.9 of their value at each train-mode call
BN_MOMENTUM = 0.9

_frozen_stats = 0


@contextlib.contextmanager
def frozen_running_stats():
    """Inside, train-mode :class:`BatchNorm2d` still normalises with the
    batch's statistics but leaves the running ones as they are: a
    rematerialised step recomputes its tower in the backward pass, and its
    forward already updated them once (flax's functional state is updated
    once per call, whatever is recomputed)."""
    global _frozen_stats
    _frozen_stats += 1
    try:
        yield
    finally:
        _frozen_stats -= 1


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` normalising in float32 and returning ``dtype``
    (flax ``nn.BatchNorm(dtype=...)``). Eval mode normalises with the
    running statistics. Train mode is flax's ``use_running_average=False``:
    it normalises with the batch's mean and biased variance over (N, H, W)
    and then updates the running statistics as
    ``r ← μ·r + (1 − μ)·s`` with μ = :data:`BN_MOMENTUM` and the batch's
    biased variance computed as flax does, E[x²] − E[x]² clipped at 0.
    (``torch.nn.BatchNorm2d``'s own update would use the unbiased variance
    and weigh the new value by its ``momentum``.) The update is in place,
    outside autograd, so T calls in a row chain the statistics as T steps
    of a rollout do; inside :func:`frozen_running_stats` it is skipped.
    Inside ``parallel.batch.global_batch`` the statistics are those of the
    global batch of every rank (:meth:`_global_batch_forward`)."""

    def __init__(self, n: int, eps: float, dtype=torch.float32):
        super().__init__(n, eps=eps)
        self.dtype = dtype

    def forward(self, x):
        x = x.float()
        if not self.training:
            return super().forward(x).to(self.dtype)
        if batch.active():
            return self._global_batch_forward(x)
        if not _frozen_stats:
            with torch.no_grad():
                mean = x.mean(dim=(0, 2, 3))
                self._update_running_stats(
                    mean, torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0))
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return y.to(self.dtype)

    def _global_batch_forward(self, x):
        """Train mode over the global batch of a data-parallel step: Σx, Σx²
        and the count all-reduced across the ranks (differentiably), then
        flax's statistics, the mean and E[x²] − E[x]² clipped at 0."""
        C = x.shape[1]
        sums = torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)),
                          x.new_full((1,), x.numel() // C)])
        sums = batch.batch_sum(sums)
        mean = sums[:C] / sums[-1]
        var = torch.clamp(sums[C:2 * C] / sums[-1] - mean * mean, min=0.0)
        if not _frozen_stats:
            self._update_running_stats(mean.detach(), var.detach())
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)

    @torch.no_grad()
    def _update_running_stats(self, mean, var):
        mu = BN_MOMENTUM
        self.running_mean.copy_(mu * self.running_mean + (1.0 - mu) * mean)
        self.running_var.copy_(mu * self.running_var + (1.0 - mu) * var)


def leaky_slope(dtype) -> float:
    """flax's ``leaky_relu(x, 0.01)`` multiplies by 0.01 cast to the
    activation's dtype."""
    return float(torch.tensor(0.01, dtype=dtype))


def _conv_blocks(cfg: DarknetConfig):
    """(index, block) of every convolutional block after ``[net]``."""
    return [(i, b) for i, b in enumerate(cfg.block_dicts()[1:])
            if b["type"] == "convolutional"]


def output_channels(cfg: DarknetConfig) -> List[int]:
    """Channel count of every layer's output (the input's first)."""
    chans = [int(cfg.block_dicts()[0].get("channels", 3))]
    outs: List[int] = []
    for b in cfg.block_dicts()[1:]:
        t = b["type"]
        if t == "convolutional":
            ch = int(b["filters"])
        elif t == "route":
            ch = sum(outs[int(v)] for v in b["layers"].split(","))
        elif t == "shortcut":
            ch = outs[int(b["from"])]
        else:  # upsample, maxpool, yolo keep the channel count
            ch = outs[-1] if outs else chans[0]
        outs.append(ch)
    return chans + outs


class Darknet(nn.Module):
    """Darknet network. ``forward(x (B, H, W, 3))`` returns the last layer's
    activation as (B, C, H*W), spatial flattened channel-major — the layout
    downstream attention expects (src/xview_et/agent.py:593-594).

    ``folded=True`` builds the eval-inference variant: every conv carries a
    bias and no BatchNorm modules exist — load it with the state dict of
    :func:`fold_darknet_params` (running stats folded into the conv weights).
    """

    def __init__(self, cfg: DarknetConfig, folded: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.folded = folded
        self.dtype = dtype
        self._blocks = cfg.block_dicts()[1:]
        chans = output_channels(cfg)
        self.module_list = nn.ModuleList()
        for i, b in enumerate(self._blocks):
            seq = nn.Sequential()
            if b["type"] == "convolutional":
                bn = int(b.get("batch_normalize", "0")) and not folded
                k = int(b["size"])
                pad = (k - 1) // 2 if int(b["pad"]) else 0
                seq.add_module(f"conv_{i}", Conv2d(
                    chans[i], int(b["filters"]), k, stride=int(b["stride"]),
                    padding=pad, bias=not bn, dtype=dtype))
                if bn:
                    seq.add_module(f"batch_norm_{i}",
                                   BatchNorm2d(int(b["filters"]), 1e-5, dtype))
                if b.get("activation") == "leaky":
                    # torch nn.LeakyReLU() default slope 0.01
                    # (src/models/dark_net.py:33)
                    seq.add_module(f"leaky_{i}", nn.LeakyReLU(leaky_slope(dtype)))
            elif b["type"] not in ("upsample", "route", "shortcut", "maxpool",
                                   "yolo"):
                raise ValueError(f"unsupported block type: {b['type']}")
            self.module_list.append(seq)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC views → NCHW
        outputs = []
        for b, mod in zip(self._blocks, self.module_list):
            t = b["type"]
            if t == "convolutional":
                x = mod(x)
            elif t == "upsample":
                x = F.interpolate(x, scale_factor=int(b["stride"]), mode="nearest")
            elif t == "route":
                x = torch.cat([outputs[int(v)] for v in b["layers"].split(",")],
                              dim=1)
            elif t == "shortcut":
                x = outputs[-1] + outputs[int(b["from"])]
            elif t == "maxpool":
                k, s = int(b["size"]), int(b["stride"])
                # TF "SAME" padding with -inf, as flax's max_pool
                pads = []
                for n in (x.shape[3], x.shape[2]):
                    total = max((-(-n // s) - 1) * s + k - n, 0)
                    pads += [total // 2, total - total // 2]
                x = F.max_pool2d(F.pad(x, pads, value=float("-inf")), k, s)
            outputs.append(x)  # yolo: feature-extraction mode, identity
        return x.flatten(2)


def fold_darknet_params(cfg: DarknetConfig, state_dict: Dict[str, torch.Tensor],
                        input_std=None, eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """Fold eval-mode BatchNorm (and optionally the input ``/std``) into the
    conv weights — the classic inference transform:

        BN(conv(x)) = conv(x)·γ/√(σ²+ε) + (β − μ·γ/√(σ²+ε))

    With ``input_std`` the first conv also absorbs the ``/s`` of the input
    normalisation ``(x − m)/s`` (kernel divided per input channel); the
    caller subtracts the mean (it cannot be folded into a zero-padded conv).
    Takes an unfolded ``Darknet`` state dict and returns the state dict of
    ``Darknet(cfg, folded=True)``; same math up to float reassociation."""
    out: Dict[str, torch.Tensor] = {}
    first = None
    for i, b in _conv_blocks(cfg):
        pre = f"module_list.{i}."
        w = state_dict[pre + f"conv_{i}.weight"]
        bn = pre + f"batch_norm_{i}."
        if int(b.get("batch_normalize", "0")) and bn + "weight" in state_dict:
            scale = state_dict[bn + "weight"] / torch.sqrt(
                state_dict[bn + "running_var"] + eps)
            w = w * scale[:, None, None, None]
            bias = state_dict[bn + "bias"] - state_dict[bn + "running_mean"] * scale
        else:
            bias = state_dict[pre + f"conv_{i}.bias"]
        out[pre + f"conv_{i}.weight"] = w
        out[pre + f"conv_{i}.bias"] = bias
        first = first or pre + f"conv_{i}.weight"
    if input_std is not None and first is not None:
        s = torch.as_tensor(input_std, dtype=torch.float32, device=out[first].device)
        out[first] = out[first] / s[None, :, None, None]
    return out
