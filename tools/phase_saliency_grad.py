#!/usr/bin/env python3
"""Where the head-gradient kernel's time goes inside a block, on the card.

    python3 tools/phase_saliency_grad.py [--batches 8 16 80 240] [--blocks B]

Compiles ``avdn_tpu_torch/csrc/saliency_head_grad.cu`` with
``-DHEAD_GRAD_MARKS`` into ``build/phase_saliency_grad/``: thread 0 of every
block then records ``clock64()`` (the SM's cycle counter) at each phase
boundary of the kernel (its ``MARK(k)`` lines). Launches it through the
port's wrapper on seeded float32 inputs at each N (the default split of
``ops/saliency.py:head_grad_blocks`` unless ``--blocks``), three times, and
prints, per N, the mean and max cycles of each phase over the blocks of the
third launch:

  setup    the bulk copies issued, the head, stats row and u loaded, the
           coefficients and the integer taps;
  wait     a barrier (every warp sees the copies' mbarrier) and the rest of
           the wait for the copies;
  taps     the taps' weights from the table, a barrier (and bf16's head rows);
  rows     the rows: p, dL/dp, d_rows and the warp's partial dx8;
  barrier  the barrier after the rows;
  warps    the block's partial from its warps';
  ticket   the partial stored, the fence and the ticket;
  last     the last block's sum of the item's partials (last blocks only).

Needs a card and nvcc. Cycles are the SM's; the card's name, power limit and
current SM clock are printed beside them (nvidia-smi).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ["setup", "wait", "taps", "rows", "barrier", "warps", "ticket", "last"]
SLOTS = 16  # the kernel's kMarkSlots


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", type=int, nargs="+", default=[8, 16, 80, 240])
    p.add_argument("--blocks", type=int, default=None)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        sys.exit("phase_saliency_grad: needs a CUDA card")
    from avdn_tpu_torch.ops import build, saliency as sal

    out_dir = os.path.join(ROOT, "build", "phase_saliency_grad")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libhead_grad_marks.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DHEAD_GRAD_MARKS",
                           "-o", lib_path, os.path.join(build.CSRC, "saliency_head_grad.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"phase_saliency_grad: nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    fn = lib.saliency_head_grad_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.saliency_head_grad_marks_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.saliency_head_grad_marks_clear.argtypes = [ctypes.c_longlong]
    sal._head_grad_kernel = lambda: fn  # the wrapper launches the instrumented build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout
    print(smi.strip(), flush=True)
    for N in args.batches:
        g = torch.Generator().manual_seed(N)
        x8 = (0.3 + 0.4 * torch.randn((N, 8, 8), generator=g)).cuda()
        gt = (torch.rand((N, 224, 224), generator=g) > 0.85).float().cuda()
        up = torch.ones(N, device="cuda")
        stats = sal.saliency_fused(sal.saliency_upsample(x8).float(), gt)[0]
        blocks = args.blocks or sal.head_grad_blocks(N, sal._n_sms(torch.cuda.current_device()))
        n_blocks = N * blocks
        for i in range(3):
            if i == 2:  # only the third launch's marks: the last blocks differ
                torch.cuda.synchronize()
                if lib.saliency_head_grad_marks_clear(n_blocks * SLOTS):
                    sys.exit("phase_saliency_grad: clearing the marks failed")
            sal._head_grad_launch(x8, gt, stats, up, 0, blocks)
        torch.cuda.synchronize()
        buf = torch.zeros(n_blocks * SLOTS, dtype=torch.int64)
        err = lib.saliency_head_grad_marks_read(buf.data_ptr(), n_blocks * SLOTS)
        if err:
            sys.exit(f"phase_saliency_grad: reading the marks failed: CUDA error {err}")
        marks = buf.reshape(n_blocks, SLOTS)[:, :len(PHASES) + 1].double()
        parts = []
        for k, name in enumerate(PHASES, start=1):
            seen = (marks[:, k] != 0) & (marks[:, k - 1] != 0)
            d = (marks[:, k] - marks[:, k - 1])[seen]
            if len(d):
                parts.append(f"{name} {d.mean().item():.0f} (max {d.max().item():.0f})")
        total = (marks[:, 7] - marks[:, 0])[marks[:, 7] != 0]
        print(f"N={N} float32, {blocks} blocks an item: mean cycles per phase, thread 0 "
              f"of each block: " + ", ".join(parts) + f"; start to ticket "
              f"{total.mean().item():.0f}", flush=True)


if __name__ == "__main__":
    main()
