"""How far fp32 rounding moves the port's Darknet-53 gradients in train-mode
BatchNorm: the tower alone (random weights from ``--seed``, ``--batch``
random 224² inputs, the gradient of a fixed random projection of its
output) in float32 through the one-process BatchNorm (``F.batch_norm``)
and through the data-parallel step's formula (``_global_batch_forward``:
E[x²] − E[x]² of the batch sums, here over one process), each against the
same tower in float64.

    python tools/bn_conditioning_torch.py [--batch 8] [--seed 0] [--device cpu]

Prints one JSON line: per path the output's largest difference relative to
the output's largest magnitude, the largest gradient difference relative
to its leaf's largest magnitude (with the leaf), and the whole gradient's
difference relative to its norm.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _grads(model, x, proj, global_formula):
    from avdn_tpu_torch.parallel import batch as pbatch

    real = pbatch.active
    if global_formula:
        pbatch.active = lambda: True
    try:
        out = model(x)
    finally:
        pbatch.active = real
    (out * proj.to(out.dtype)).sum().backward()
    return out.detach(), {n: p.grad for n, p in model.named_parameters()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cpu")
    ns = ap.parse_args(argv)
    import torch

    import avdn_tpu_torch.models.darknet as darknet
    from avdn_tpu_torch.device import use_fp32_numerics
    from avdn_tpu_torch.train.loop import init_state

    use_fp32_numerics()
    tower = darknet.Darknet(darknet.DarknetConfig.default(img_size=224))
    init_state([tower], torch.Generator().manual_seed(ns.seed))
    tower = tower.to(ns.device).train()
    g = torch.Generator().manual_seed(ns.seed + 1)
    x = torch.randn((ns.batch, 224, 224, 3), generator=g).to(ns.device)
    with torch.no_grad():
        shape = tower(x).shape
    proj = torch.randn(shape, generator=g).to(ns.device)
    runs = {"plain": _grads(copy.deepcopy(tower), x, proj, False),
            "global_batch_formula": _grads(copy.deepcopy(tower), x, proj, True)}

    # float64: the two-pass statistics, no float32 cast anywhere
    def forward64(self, y):
        mean = y.mean(dim=(0, 2, 3))
        d = y - mean[:, None, None]
        var = (d * d).mean(dim=(0, 2, 3))
        return d * (torch.rsqrt(var + self.eps) * self.weight)[:, None, None] \
            + self.bias[:, None, None]

    real_forward = darknet.BatchNorm2d.forward
    darknet.BatchNorm2d.forward = forward64
    try:
        out64, g64 = _grads(copy.deepcopy(tower).double(), x.double(), proj, False)
    finally:
        darknet.BatchNorm2d.forward = real_forward
    norm64 = float(torch.sqrt(sum((v ** 2).sum() for v in g64.values())))
    result = {"batch": ns.batch, "seed": ns.seed, "device": ns.device}
    for name, (out, grads) in runs.items():
        leaf = max((float((grads[k].double() - g64[k]).abs().max() / g64[k].abs().max()), k)
                   for k in g64)
        diff = float(torch.sqrt(sum(((grads[k].double() - g64[k]) ** 2).sum() for k in g64)))
        result[name] = {
            "out_rel": float((out.double() - out64).abs().max() / out64.abs().max()),
            "grad_leaf_worst": leaf[0], "grad_leaf": leaf[1],
            "grad_diff_over_norm": diff / norm64}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
