#!/usr/bin/env python3
"""Device time of the backward of −NSS down to the (N, 8, 8) saliency head,
and of its parts, on the card at the shapes of the train paths.

    python3 tools/bench_saliency_grad.py [--root DIR] [--batches 8 16 80 160 240]
                                         [--out FILE]

For each N and each head dtype (float32; bfloat16, the production recipe's)
it makes seeded heads x8 (N, 8, 8) and ground-truth maps (N, 224, 224) with
a constant head (item 1) and an empty ground truth (item 2), runs the
forward of −NSS through DIR's port as its rollouts do, and times with
torch.profiler (the summed device time of the kernels, per call):

* ``backward``: ``torch.autograd.grad(neg_nss, x8, upstream)``, all that the
  backward launches between dL/d(−NSS) and dL/dx8, with its launches per
  call;
* ``upsample_backward``: the upsample's backward alone,
  ``torch.autograd.grad(pred, x8, dpred)``: what a backward that forms the
  full-resolution dL/dpred spends besides that, and the head kernel saves;
* ``kernel``: the head kernel alone through its wrapper
  (``saliency_head_grad``), and with each split of an item's rows through
  ``_head_grad_launch``: 8, 16 or 32 bands (``kernel_ticket_{8,16,32}_*``).

Each is timed cold (input sets cycled past the 50 MB L2) and hot (one set).
``--root`` names the checkout whose ``avdn_tpu_torch`` is measured (default:
the one beside this script), so that two commits are compared in one call
on one card: unpack the parent with ``git archive`` into a gitignored
directory and run parent, change, change, parent. Needs a card; prints the
card's name and power limit (nvidia-smi), then one JSON line per (N, dtype).
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLD_BYTES = 128 * 2 ** 20


def _smoke():
    """chip_smoke.py beside this script, for its profiler helpers."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(N, dtype, seed):
    import torch

    g = torch.Generator().manual_seed(seed)
    x8 = 0.3 + 0.4 * torch.randn((N, 8, 8), generator=g)
    gt = (torch.rand((N, 224, 224), generator=g) > 0.85).float()
    x8[1] = 0.25  # a constant head: a constant map, std = 0
    gt[2] = 0.0   # no fixation
    up = 0.5 + torch.rand(N, generator=g)
    return x8.to(dtype).cuda(), gt.cuda(), up.cuda()


def _timed(smoke, fns, launches=None):
    """Device ms per call of ``fns`` (one callable, or a list cycled
    through) and kernels per call."""
    turn = itertools.cycle(fns if isinstance(fns, list) else [fns])
    if launches is None:  # the most any of two sessions recorded
        counts = [smoke.device_time_ms(lambda: next(turn)(), n=10) for _ in range(2)]
        launches = max(round(c[1]) for c in counts if c is not None)
    got = smoke.device_time_ms(lambda: next(turn)(), n=50, launches=launches)
    return (None, launches) if got is None else got


def bench(N, dtype_name, smoke):
    import torch

    from avdn_tpu_torch.ops import saliency

    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    n_sets = max(1, -(-COLD_BYTES // (N * 224 * 224 * 4)))  # the GT maps
    sets = [_inputs(N, dtype, 1000 * N + k) for k in range(n_sets)]

    def graph(x8, gt):
        x8 = x8.clone().requires_grad_(True)
        _, neg, *_ = saliency.saliency_head_reductions(x8, gt)
        return x8, neg

    def backward(x8, gt, up):
        x8, neg = graph(x8, gt)
        return lambda: torch.autograd.grad(neg, x8, up, retain_graph=True)

    def up_backward(x8, gt, up):
        x8 = x8.clone().requires_grad_(True)
        pred = saliency.saliency_upsample(x8).float()
        dpred = torch.ones_like(pred)
        return lambda: torch.autograd.grad(pred, x8, dpred, retain_graph=True)

    def kernel(blocks):
        def make(x8, gt, up):
            stats = saliency.saliency_fused(saliency.saliency_upsample(x8).float(), gt)[0]
            if blocks is None:
                return lambda: saliency.saliency_head_grad(x8, gt, stats, up)
            return lambda: saliency._head_grad_launch(x8, gt, stats, up, 0, blocks)
        return make

    rec = {"N": N, "dtype": dtype_name, "input_sets_cold": n_sets}
    # the default split (head_grad_blocks), then each other: 8, 16, 32 bands
    parts = {"backward": (backward, None), "upsample_backward": (up_backward, None),
             "kernel": (kernel(None), 1)}
    parts.update({f"kernel_ticket_{b}": (kernel(b), 1) for b in (8, 16, 32)})
    for name, (make, launches) in parts.items():
        calls = [make(*s) for s in sets]
        rec[f"{name}_cold_ms"], launches = _timed(smoke, calls, launches)
        rec[f"{name}_hot_ms"], _ = _timed(smoke, calls[0], launches)
        rec[f"{name}_launches"] = launches
    return rec


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=HERE,
                   help="checkout whose avdn_tpu_torch is measured")
    p.add_argument("--batches", type=int, nargs="+", default=[8, 16, 80, 160, 240])
    p.add_argument("--out", default=None, help="also append the JSON lines here")
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_saliency_grad: needs a CUDA card")
    smoke = _smoke()
    import avdn_tpu_torch

    if not os.path.abspath(avdn_tpu_torch.__file__).startswith(root + os.sep):
        sys.exit(f"bench_saliency_grad: imported {avdn_tpu_torch.__file__}, not {root}'s")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    for N in args.batches:
        for dtype in ("float32", "bfloat16"):
            rec = dict(bench(N, dtype, smoke), root=root, card=card)
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")


if __name__ == "__main__":
    main()
