"""Seeded random weights, drawn on the device in one call a model.

The scheme is the port's ``init_state`` (LeCun-normal weights, zero biases,
unit norms, embeddings of std 1/√features, BatchNorm at identity
statistics), but every random leaf is a slice of one ``torch.randn`` drawn
on the device from ``--seed``. The benchmark loads the same weights into the
port's models and, after the window, into the reference's, so the reference
takes nothing the port made.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from harness.data import sub_seed

_RANDOM_NAMES = ("in_proj_weight", "weight_ih", "weight_hh")
_ZERO_NAMES = ("in_proj_bias", "bias_ih", "bias_hh")


@torch.no_grad()
def init_weights(models, seed: int, device) -> None:
    """Overwrite every parameter and BatchNorm statistic of ``models``
    (in place) with the seed's weights."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    for model in models:
        plan = []  # (leaf, scale) of the random leaves, in module order
        seen = set()
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                plan.append((mod.weight, 1.0 / math.sqrt(mod.weight[0].numel())))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                plan.append((mod.weight, 1.0 / math.sqrt(mod.weight.shape[1])))
            elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
                mod.reset_parameters()
                if isinstance(mod, nn.BatchNorm2d):
                    mod.reset_running_stats()
        seen.update(id(t) for t, _ in plan)
        for name, p in model.named_parameters():
            if id(p) in seen:
                continue
            if name.endswith(_RANDOM_NAMES):
                plan.append((p, 1.0 / math.sqrt(p.shape[1])))
                seen.add(id(p))
            elif name.endswith(_ZERO_NAMES):
                p.zero_()
        total = sum(t.numel() for t, _ in plan)
        draw = torch.randn(total, generator=g, device=device)
        off = 0
        for t, scale in plan:
            n = t.numel()
            t.copy_(draw[off:off + n].view(t.shape).mul_(scale))
            off += n
        del draw
