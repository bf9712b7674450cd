"""int8 quantized Darknet eval tower (torch counterpart of
``avdn_tpu/models/darknet_quant.py``; opt-in, ``--quant int8``).

Runs the BN-folded inference tower (``darknet.fold_darknet_params``, the
bias-carrying conv form quantization wants) with:

* **weights**: per-output-channel symmetric int8
  (``scale = amax(|W|)/127`` over the (Cin, k, k) receptive field);
* **activations**: per-EXAMPLE dynamic symmetric int8, the scale taken from
  each layer input's abs-max over its own (C, H, W) at call time — no
  calibration set, and batch-invariant: an episode's result never depends on
  what it was batched with;
* **accumulation**: the integer values convolved in float32 (TF32 off),
  dequantised and biased in one rounding per conv, leaky-ReLU in float32.

The JAX package runs an s8 × s8 → s32 convolution only on a TPU and
convolves the same integer values in float32 elsewhere; the port does the
latter on the card too (an int8 tensor-core conv is queued, ROADMAP.md
queue 2). Partial sums reach 127²·9·Cin, past 2²⁴, so the float32
accumulation rounds and the summation order of the backend shows.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from avdn_tpu_torch.geometry.transforms import fma
from avdn_tpu_torch.models.darknet import DarknetConfig, _conv_blocks
from avdn_tpu_torch.utils.logging import span

_QMAX = 127.0


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-12) / 127``, correctly rounded on every device. A CUDA
    tensor divided by a Python number is multiplied by the number's rounded
    reciprocal instead, one ulp off at times, and a scale one ulp off moves
    every value on a rounding boundary to the next int8 step."""
    return torch.clamp(amax, min=1e-12) / amax.new_full((), _QMAX)


def quantize_darknet_params(cfg: DarknetConfig,
                            folded: Dict[str, torch.Tensor]) -> Dict[str, dict]:
    """The state dict of ``Darknet(cfg, folded=True)`` → ``{conv index:
    {weight_q int8 (Cout, Cin, k, k), scale (Cout,) float32, bias (Cout,)
    float32}}``."""
    out = {}
    for i, _ in _conv_blocks(cfg):
        pre = f"module_list.{i}.conv_{i}."
        w = folded[pre + "weight"].float()
        scale = _scale(w.abs().amax(dim=(1, 2, 3)))
        q = torch.clamp(torch.round(w / scale[:, None, None, None]), -_QMAX, _QMAX)
        out[i] = {"weight_q": q.to(torch.int8), "scale": scale,
                  "bias": folded[pre + "bias"].float()}
    return out


def _quant_act(x: torch.Tensor):
    """Per-example dynamic symmetric int8 of an activation: the abs-max is
    taken over everything but the batch axis. Returns the integer values
    (float32) and the (B, 1, 1, 1) scales."""
    scale = _scale(x.abs().amax(dim=tuple(range(1, x.ndim)), keepdim=True))
    return torch.clamp(torch.round(x / scale), -_QMAX, _QMAX), scale


def quant_forward(cfg: DarknetConfig, qparams: Dict[int, dict], x: torch.Tensor):
    """Quantized eval forward of the mean-subtracted NHWC views ``x`` (the
    /std is folded into conv 0's weights before quantization); mirrors
    ``Darknet.forward``. Returns (B, C, H*W) float32."""
    x = x.float().permute(0, 3, 1, 2)
    outputs = []
    for i, b in enumerate(cfg.block_dicts()[1:]):
        t = b["type"]
        if t == "convolutional":
            k = int(b["size"])
            pad = (k - 1) // 2 if int(b["pad"]) else 0
            p = qparams[i]
            xq, act_scale = _quant_act(x)
            acc = F.conv2d(xq, p["weight_q"].float(), None, int(b["stride"]), pad)
            # dequantise and add the bias rounded once, as XLA's contracted
            # multiply-add (the next layer's rounding to int8 amplifies an ulp)
            x = fma(acc, act_scale * p["scale"][None, :, None, None],
                    p["bias"][None, :, None, None].expand_as(acc))
            if b.get("activation") == "leaky":
                x = F.leaky_relu(x, 0.01)
        elif t == "upsample":
            x = F.interpolate(x, scale_factor=int(b["stride"]), mode="nearest")
        elif t == "route":
            x = torch.cat([outputs[int(v)] for v in b["layers"].split(",")], dim=1)
        elif t == "shortcut":
            x = outputs[-1] + outputs[int(b["from"])]
        elif t == "maxpool":
            kk, s = int(b["size"]), int(b["stride"])
            pads = []
            for n in (x.shape[3], x.shape[2]):
                total = max((-(-n // s) - 1) * s + kk - n, 0)
                pads += [total // 2, total - total // 2]
            x = F.max_pool2d(F.pad(x, pads, value=float("-inf")), kk, s)
        elif t != "yolo":
            raise ValueError(f"unsupported block type: {t}")
        outputs.append(x)
    return x.flatten(2)


class QuantDarknet(nn.Module):
    """Stand-in for ``Darknet(folded=True)`` in the eval rollout: the same
    call surface, quantized execution over ``qparams`` (set from
    ``quantize_darknet_params(cfg, fold_darknet_params(...))`` before each
    rollout). Inference only; float32 output whatever the towers'
    dtype."""

    def __init__(self, cfg: DarknetConfig):
        super().__init__()
        self.cfg = cfg
        self.qparams: Dict[int, dict] = {}

    def forward(self, x):
        with span("models.darknet"):
            return quant_forward(self.cfg, self.qparams, x)
