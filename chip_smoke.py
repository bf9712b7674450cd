#!/usr/bin/env python3
"""Drive the PyTorch port (avdn_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. device  — the card's name and power limit (nvidia-smi), torch and CUDA.
2. build   — every CUDA kernel under avdn_tpu_torch/csrc, one nvcc each, and
             the host library (csrc/avdn_host.cpp: the INTER_AREA resampler
             and the WordPiece encoder) with the host C++ compiler, all in
             parallel, into build/avdn_tpu_torch/; prints the compiler and
             flags of each.
3. kernels — each kernel against its plain PyTorch version on the card at
             the main path's shapes (the fused saliency kernel: B = 4, 8 and
             16, the per-step batches, and 40, 80, 160 and 240, T·B of the
             fused teacher path; each nss_r; repeated launches bitwise equal;
             the backward of −NSS to the 8×8 saliency head, ``grad_kernel``,
             at the same N, fp32 and bf16 heads, against the
             plain version, with an empty-ground-truth and a constant-head
             item, one launch per backward and no other kernel, no upsample
             backward and no full-resolution buffer in it), with device
             times from torch.profiler, cold (held against the HBM byte
             bound) and hot in L2; then ``oracle``: the teacher oracle's
             kernel (``csrc/teacher_oracle.cu``) bit-equal to
             ``teacher_action_batch_plain`` at B = 4, 16 and 40 (max_gt_len
             12, both feedback modes), one launch a call, its device time
             cold and hot beside its byte bound, and the plain version's
             kernels and wall time a call.
4. slice   — the ET-HAA inference path at full width (BERT-base 12×768,
             Darknet-53 at 224 px, HAA trunk 2×768, T = 10, a 4096 px
             8-slot map bank), fp32 and the exact render, random weights
             from a seed: Navigator serves 3 requests of 8 items (no
             saliency-kernel launch), then over the same 24 items the
             student nav eval (T launches per batch), the time-fused
             teacher HA eval (one launch per batch, N = T·B = 80) and the
             step-by-step HA eval (T launches per batch), the last two held
             against each other; then the census of live tensors on the card
             (``utils/debug.py:format_memory_census(10)``).
4b. serve_http — phase 4's Navigator behind the port's HTTP front-end
             (``serve_http.make_server`` on 127.0.0.1): 6 concurrent
             clients of 4 items coalesced into batches of at most 8, one
             request of 20 items split into 8 + 8 + 4 and equal to
             ``navigate()``, ``/healthz``, a 400 and a 413, no saliency
             launch; then ``tools/bench_serving_torch.py``'s ``bench`` (8
             clients × 32 requests × 2 items, 256 requests): its JSON line
             with eps/s, p50/p90/p99 and the Navigator's wall by phase.
5. valid   — the port's validation driver, ``valid()``, at full width on an
             ANDH-format dataset written here (val_seen / val_unseen JSON,
             the maps as .tif files), the random weights through
             ``--resume_file`` as a reference-format .pt, fp32 and the exact
             render: its metric records and launch counts (no
             ``--inference``, so no debug images: phase 6 writes them).
6. defaults — the shipped eval defaults, with no render or dtype flag: the
             two-pass render with the crop sized from the dataset (1024 px),
             bf16 towers, the BN-folded tower. Navigator serves 3 requests of
             8, the student nav eval and the fused HA eval run over the 24
             items, the opt-in modes (``--render_subsample 2``, ``--quant
             int8``, ``--et_decode_trunk True``) one batch each, the fp32
             decode trunk is held against the full re-encode, and
             ``valid()`` runs as ``--inference True`` with its debug images.
6b. train  — the port's train CLI at full width (B = 8, T = 10, no preset:
             fp32, the exact render, student feedback, the fused teacher,
             AdamW) from the seed's random init on the phase-5 dataset's
             train split: one interval of 3 steps with its checkpoint and
             validation, then ``--resume_file latest`` and 3 more steps
             (the loop runs whole epochs); finite losses and grad norms,
             the checkpoints loadable by ``valid()``, the saliency
             launches per step (forward T + 1, backward T), the median step
             wall, peak memory and one profiled step (idle share, launches,
             top kernels; no upsample backward), and the model FLOPs per
             step (``utils/flops.py``) with the median step's MFU against
             the card's dense fp32 peak (TF32 off).
6c. train_production — the same with ``--preset production`` (B = 16, bf16
             towers, the two-pass render in both rollouts, dots remat), T =
             10, on the val splits and 48 train items: the saliency launches
             per step (forward 10 at N = 16 and 1 at N = 160, backward 10 at
             N = 16), the step wall, idle share, launches and peak memory;
             then one step at B = 16 with and without remat (peak memory of
             each); the MFU against the dense bf16 peak. Then one train step at tiny width, dropout 0, on the card
             and on the CPU: loss and grad norms within 1e-4 in fp32, and
             within 2e-2 in the production recipe's bf16 (teacher feedback
             through the step loop, fp32 render weights on both sides).
6c'. dp    — data parallelism on the one card: the real train step in a
             world of one process over NCCL (full width, B = 8, fp32, exact)
             against the step with no process group (bit-equal, or the gap
             and its reason, within 1e-5 / 1e-3); then ``cli.train_et`` in two
             processes over gloo (NCCL refuses two ranks on one device),
             B = 4 a rank on 16 train items: 2 steps, a checkpoint and a
             validation, ``--resume_file latest`` and 2 more; both exit 0,
             rank 0 alone writes checkpoints, the replicas (weights and Adam
             moments) bit-identical, the metric records equal, each step's
             saliency launches 10 at N = 4 and 1 at N = 40 forward and 10 at
             N = 4 backward on each rank (step walls and peak memory per
             rank); one step at dropout 0 against one process at B = 8, the
             loss within 1e-4 relative and per group (BERT, Darknet, VLN)
             the gradient difference's norm within 1e-4 / 1e-1 / 1e-4 of the
             gradient's norm, bars that the control (BatchNorm on each
             rank's own statistics) must fail.
6d. lstm   — the HAA-LSTM family (``--family lstm``: BERT-base, Darknet-53,
             ``HAALSTM`` hidden 768, T = 10) from a random init written as a
             reference LSTM-layout .pt: serving (no saliency launch), the
             nav eval, the fused and step HA evals (held against each other)
             and ``valid()`` at the reference numerics and the defaults; the
             ``cli.train_lstm`` at ``scripts/run_lstm_haa.sh``'s recipe (B =
             4, ``--nss_w 0``: forward T + 1, backward 0 launches a step), one
             step at ``--nss_w 0.1`` (the head gradient T times at N = 4),
             and card vs CPU at tiny width (a student rollout, a train step;
             1e-4).
6e. entry  — the shipped entry points as a user runs them, at full width,
             each in a process of its own: a dataset written by
             ``python -m avdn_tpu_torch.data.demo`` (4 train and 4 items a
             val split, with a ``yolo_v3.cfg`` of the default Darknet-53 and
             a ``vocab.txt``); ``bash scripts/run_et_haa_torch.sh`` (B = 4,
             T = 10, ``--nss_w 0.1``, ``--eval_first True``, 2 steps) with
             ``--profile_dir``: exit 0,
             finite losses, a checkpoint, the validation records, both hand
             kernels in the trace; ``scripts/run_lstm_haa_torch.sh`` alike
             (``--nss_w 0``: the forward kernel only); ``--inference True``
             from the ET run's ``best_val_unseen.pt``;
             ``tools/repro_valid_torch.py`` on an empty root (SKIPPED, exit
             0) and through ``scripts/repro_valid_torch.sh`` on the release
             layout written here (random weights as ``best_val_unseen`` in the
             reference layout with a torch AdamW state and the reference's
             dead ET modules): its table, every metric finite; the dataset
             viewer (one JPG per item); the host library against its plain
             versions: ``area_resize`` bit-equal to ``data/resample.py`` on a
             3000 × 4000 tile and the native encoder equal to the Python one
             on the demo dialogs and a non-ASCII text, both timed (host CPU
             named). The independent ones run side by side; the host
             library's timings run alone at the end.
7. render  — the two-pass render fp32 on the card against the CPU (B = 2),
             bf16 against fp32 weights (B = 8), and the per-call time of the
             exact and two-pass renders at B = 8 and N = 80.
8. parity  — one student rollout at B = 2 on the card and on the CPU (plain
             versions) with the same weights and inputs.
9. profile — one nav-eval batch and one fused HA-eval batch under
             torch.profiler (device busy time, top kernels) and each layer
             of a rollout step timed alone, for the exact fp32 config and for
             the defaults (with the int8 tower and the decode step).

To keep the wall near what it was before phases 6–7 came, phase 5 runs
without debug images and phase 9 times each layer over fewer calls (5
profiled, 3 × 3 timed).

The line before the last is the JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``. Without a card, or without the package
beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
T_STEPS = 10
SERVE_BATCH = 8
N_ITEMS = 24
N_MAPS = 4
MAP_PX = 2048
LAT_RATIO = 5e-6  # degrees per pixel (xView-like ground sampling)
DEG_TO_M = 11.13e4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
# B of the saliency kernel: the per-step B (8; 16 in the production preset;
# 4 in the LSTM recipe, scripts/run_lstm_haa.sh) and the fused teacher
# path's T·B (80 here, 160 in the production phase, 40 in the LSTM recipe;
# 15 × 16 at the default horizon)
SALIENCY_BATCHES = (4, SERVE_BATCH, 16, T_STEPS * 4, T_STEPS * SERVE_BATCH, T_STEPS * 16,
                    15 * 16)
COLD_BYTES = 128 * 2 ** 20  # input copies cycled through for an L2-cold time


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cuda_time_ms(fn, n: int = 100, trials: int = 7) -> float:
    """Time of one ``fn()`` on the device's timeline: CUDA events around
    ``n`` back-to-back calls (after a warm-up), divided by ``n``; the median
    of ``trials``. Where the host enqueues slower than the device runs, this
    is the host's rate."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def kernel_events(prof):
    """The CUDA kernel rows of a torch.profiler run (not the aten ops that
    launched them, whose device time would count the same kernels twice)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and getattr(e, "self_device_time_total", 0) > 0]


def device_time_ms(fn, n: int = 50, launches: int | None = None,
                   attempts: int = 5):
    """Device time of one ``fn()`` and the kernels it launches: the summed
    time of the CUDA kernels that ``n`` calls launch (torch.profiler),
    divided by ``n``, and their count divided by ``n``. On the H100 machine
    a session now and then records no kernel, or fewer than were launched;
    a session that records none, or other than ``launches`` per call where
    that is known, is run again, up to ``attempts`` times, and then the
    result is None."""
    got = _profiled_sessions(fn, n, launches, attempts)
    return None if got is None or got[2] != got[3] else got[:2]


def _profiled_sessions(fn, n, launches, attempts):
    """Up to ``attempts`` torch.profiler sessions of ``n`` calls of ``fn``:
    ``(ms per call, kernels per call, kernels recorded, kernels launched)``
    of the first session that recorded every launch (every session that
    recorded any, where ``launches`` per call is not known), else of the
    fullest session that recorded at least 90 % of ``n · launches``, its
    time the mean recorded kernel times ``launches``; else None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    partial = None
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = kernel_events(prof)
        total_us = sum(e.self_device_time_total for e in kernels)
        count = sum(e.count for e in kernels)
        if total_us > 0 and launches is None:
            return total_us / 1e3 / n, count / n, count, count
        if total_us > 0 and count == launches * n:
            return total_us / 1e3 / n, launches, count, count
        if (total_us > 0 and 0.9 * launches * n <= count < launches * n
                and (partial is None or count > partial[2])):
            partial = (total_us / 1e3 / count * launches, launches, count, launches * n)
        log(f"[profile] torch.profiler session {attempt} of {attempts} recorded "
            f"{count} kernels for {n} calls: " + ", ".join(
                f"{e.count} x {e.key[:60]}" for e in kernels))
    return partial


def kernel_time_ms(fn, n: int = 50):
    """Device time of one launch of a one-kernel ``fn`` and the number of
    the ``n`` launches that the profiler session behind it recorded
    (``n`` unless no session of five recorded them all); fails the run if
    no session recorded at least 90 % of them."""
    got = _profiled_sessions(fn, n, 1, 5)
    if got is None:
        fail("torch.profiler recorded too few of the kernels launched")
    return got[0], got[2]


# ----------------------------------------------------------------- inputs --


def saliency_inputs(B: int, device):
    """Seeded (B, 224, 224) prediction / ground-truth maps with an empty
    ground truth (item 2) and a constant prediction (item 1)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(SEED + B)
    pred = 0.3 + 0.4 * torch.randn((B, 224, 224), generator=g)
    gt = (torch.rand((B, 224, 224), generator=g) > 0.85).float()
    pred[1] = 0.25
    gt[2] = 0.0
    return pred.to(device), gt.to(device)


def oracle_inputs(B: int, max_t: int, seed: int, device):
    """Seeded teacher-oracle inputs at the rollout's scale (GPS offsets of a
    few 1e-3 degrees, views of 40-400 m): (corners (B, 4, 2), ended (B,),
    gt_corners (B, max_t, 4, 2), gt_len (B,) int64). Each GT path is a walk
    of views padded with zeros, as the batcher pads it (a quarter of the
    items with other views instead), its goal sometimes with coincident
    corners. Each current view is, by item: near a GT step; the goal
    itself; a GT step itself; anywhere on the map; four coincident or
    collinear corners; a view a few centimetres wide (the axis solve near
    singular); or far from the path (no intersection, the polyline missing
    the view); a fifth of them in another corner order. A fifth of the
    items have ended."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def views(center, edge_deg, heading):
        base = np.array([[1, -1], [1, 1], [-1, 1], [-1, -1]], np.float64)
        c, s = np.cos(heading)[..., None], np.sin(heading)[..., None]
        x, y = base[:, 0], base[:, 1]
        q = np.stack([x * c - y * s, x * s + y * c], -1) * (edge_deg / 2)[..., None, None]
        return q + center[..., None, :]

    gt_len = rng.integers(1, max_t + 1, B)
    walk = rng.normal(0, 4e-4, (B, max_t, 2))
    walk[:, 0] = 0
    centers = rng.uniform(0.002, 0.008, (B, 1, 2)) + np.cumsum(walk, 1)
    edge = np.clip(rng.uniform(40, 400, (B, 1)) * np.exp(np.cumsum(
        rng.normal(0, 0.1, (B, max_t)), 1)), 40, 400) / DEG_TO_M
    heading = rng.uniform(0, 2 * np.pi, (B, 1)) + np.cumsum(rng.normal(0, 0.3, (B, max_t)), 1)
    gt = views(centers, edge, heading)
    pad = np.arange(max_t)[None, :] >= gt_len[:, None]
    other = views(rng.uniform(0, 0.01, (B, max_t, 2)), edge, heading)
    gt = np.where(pad[..., None, None] & (rng.uniform(size=B) < 0.25)[:, None, None, None],
                  other, np.where(pad[..., None, None], 0.0, gt))
    rows = np.arange(B)
    goal = gt_len - 1
    dup = rng.uniform(size=B) < 0.05  # the goal's corners 1 and 2 coincide
    gt[rows[dup], goal[dup], 2] = gt[rows[dup], goal[dup], 1]

    j = rng.integers(0, gt_len)
    kind = rng.integers(0, 10, B)
    corners = gt[rows, j] + rng.normal(0, 1.5e-4, (B, 1, 2))
    corners = np.where((kind == 4)[:, None, None], gt[rows, goal], corners)
    corners = np.where((kind == 5)[:, None, None], gt[rows, j], corners)
    anywhere = views(rng.uniform(0, 0.01, (B, 2)), edge[:, 0], heading[:, 0])
    corners = np.where((kind == 6)[:, None, None], anywhere, corners)
    point = corners[:, :1].repeat(4, 1)
    line = corners[:, :1] + np.linspace(0, 1, 4)[None, :, None] * (corners[:, 2:3] - corners[:, :1])
    corners = np.where((kind == 7)[:, None, None],
                       np.where((rows % 2 == 0)[:, None, None], point, line), corners)
    tiny = views(corners.mean(1), rng.uniform(1e-7, 2e-5, B), heading[:, 0])
    corners = np.where((kind == 8)[:, None, None], tiny, corners)
    corners = np.where((kind == 9)[:, None, None], corners + 0.02, corners)
    order = rng.uniform(size=B) < 0.2
    corners[order] = corners[order][:, rng.permutation(4)]
    ended = rng.uniform(size=B) < 0.2

    def dev(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).to(device)

    return (dev(corners, torch.float32), dev(ended, torch.bool),
            dev(gt, torch.float32), dev(gt_len, torch.int64))


def make_maps(device):
    """N_MAPS decoded RGB uint8 maps: a smooth random field (upsampled from
    a coarse grid) plus fine texture, like aerial imagery at ~0.5 m/px."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    coarse = torch.rand((N_MAPS, 3, 32, 32), generator=g) * 200 + 20
    fine = torch.rand((N_MAPS, 3, MAP_PX, MAP_PX), generator=g) * 40 - 20
    field = F.interpolate(coarse.to(device), size=(MAP_PX, MAP_PX),
                          mode="bilinear", align_corners=False)
    maps = (field + fine.to(device)).clamp(0, 255).to(torch.uint8)
    return [m.permute(1, 2, 0).contiguous().cpu().numpy() for m in maps]


def make_items(seed=SEED + 2, prefix=""):
    """N_ITEMS ANDH-format items (the fields of avdn_tpu/data/demo.py) over
    the N_MAPS maps: view edges of 40–400 m, 2–5 step GT paths, 1–3
    attention circles, one or two dialog rounds; ``prefix`` starts each
    route index."""
    import numpy as np

    rng = np.random.default_rng(seed)
    extent = MAP_PX * LAT_RATIO
    items = []
    for i in range(N_ITEMS):
        k = i % N_MAPS
        botm_left = [30.0 + 0.1 * k, -115.0 + 0.1 * k]
        top_right = [botm_left[0] + extent, botm_left[1] + extent]
        edge = rng.uniform(40.0, 400.0) / DEG_TO_M
        margin = 0.8 * edge  # the view (half-diagonal 0.71 edge) stays inside
        c = np.array(botm_left) + rng.uniform(margin, extent - margin, 2)
        heading = float(rng.integers(0, 360))
        step = rng.uniform(-1, 1, 2)
        step /= np.linalg.norm(step)
        path = []
        for _ in range(int(rng.integers(2, 6))):
            h = edge * rng.uniform(0.9, 1.1) / 2
            base = np.array([[h, -h], [h, h], [-h, h], [-h, -h]])
            th = -heading / 180 * np.pi
            rot = np.array([[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]])
            path.append((base @ rot.T + c).tolist())
            c = np.clip(c + step * edge * 0.6, np.array(botm_left) + margin,
                        np.array(top_right) - margin)
        att = [[[float(c[0] + rng.uniform(-1, 1) * edge / 4),
                 float(c[1] + rng.uniform(-1, 1) * edge / 4)],
                int(rng.integers(10, 60))] for _ in range(int(rng.integers(1, 4)))]
        pre = ["[QUE] where should i go next? [INS] head north over the road."]
        if i % 3 == 0:
            pre.append("[QUE] am i close yet? [INS] keep going past the lot.")
        items.append({
            "map_name": f"smoke_map_{k}",
            "route_index": f"{prefix}{i}_1",
            "angle": heading + rng.uniform(-0.4, 0.4),
            "gt_path_corners": path,
            "instructions": f"Fly toward the gray building number {i} [SEP]",
            "pre_dialogs": pre,
            "attention_list": att,
            "lat_ratio": LAT_RATIO,
            "lng_ratio": LAT_RATIO,
            "gps_botm_left": botm_left,
            "gps_top_right": top_right,
            "destination": path[-1],
        })
    return items


# ----------------------------------------------------------------- phases --


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port runs on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0].strip()
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


def phase_build():
    from avdn_tpu_torch.ops import build

    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"[build] {sorted(reports)} in {time.perf_counter() - t0:.3f} s")
    log(f"[build] kernels {build.kernel_sources()}: {build._nvcc()} "
        f"{' '.join(build.NVCC_FLAGS)}")
    log(f"[build] host library {build.host_sources()}: {build.host_compiler()} "
        f"{' '.join(build.HOST_FLAGS)}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def _reductions_agree(got, want, where):
    """Kernel vs plain (neg_nss, valid, precision, recall): valid flags
    equal, the rest within 1e-4 (neg_nss on the valid items)."""
    import torch

    if not torch.equal(got[1], want[1]):
        fail(f"{where}: valid flags differ")
    m = want[1]
    for name, a, b in zip(("neg_nss", "precision", "recall"),
                          (got[0][m], got[2], got[3]), (want[0][m], want[2], want[3])):
        if not torch.allclose(a, b, rtol=0, atol=1e-4):
            fail(f"{where}: {name} differs by {(a - b).abs().max().item()}")


def phase_kernels(card):
    """The fused saliency kernel against its plain version at every B the
    rollouts give it, then its times: device time cold (cycling through
    input copies that together exceed the 50 MB L2), which the HBM byte
    bound is held against, and hot in L2 (one buffer, as the rollout sees
    it), and the wrapper call back to back."""
    import torch

    from avdn_tpu_torch.ops.saliency import (_n_sms, cluster_size,
                                             saliency_fused, saliency_reductions,
                                             saliency_reductions_plain,
                                             saliency_stats_plain)

    sms = _n_sms(torch.cuda.current_device())
    log(f"[kernels] {sms} SMs")
    rec = {}
    for B in SALIENCY_BATCHES:
        pred, gt = saliency_inputs(B, "cuda")
        want_stats = saliency_stats_plain(pred, gt)
        err = 0.0
        for nss_r in (0, 1, -1):
            runs = [saliency_fused(pred, gt, nss_r) for _ in range(3)]
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for run in runs[1:] for a, b in zip(runs[0], run)):
                fail(f"saliency kernel B={B} nss_r={nss_r}: repeated launches differ")
            got_stats = runs[0][0]
            if not torch.allclose(got_stats, want_stats, rtol=2e-5, atol=1e-2):
                fail(f"saliency_stats B={B}: kernel vs plain max diff "
                     f"{(got_stats - want_stats).abs().max().item()}")
            err = max(err, (got_stats - want_stats).abs().max().item())
            _reductions_agree(runs[0][1:], saliency_reductions_plain(pred, gt, nss_r),
                              f"saliency_reductions B={B} nss_r={nss_r}")
        set_bytes = 2 * pred.numel() * 4
        n_copies = -(-COLD_BYTES // set_bytes)
        copies = [(pred.clone(), gt.clone()) for _ in range(n_copies)]
        turn = itertools.cycle(copies)
        hot_ms, hot_rec = kernel_time_ms(lambda: saliency_reductions(pred, gt))
        cold_ms, cold_rec = kernel_time_ms(lambda: saliency_reductions(*next(turn)))
        plain = device_time_ms(lambda: saliency_reductions_plain(pred, gt))
        if plain is None:
            fail("torch.profiler recorded no kernel of the plain version")
        plain_ms = plain[0]
        call_ms = cuda_time_ms(lambda: saliency_reductions(pred, gt))
        del copies, turn
        bytes_moved = set_bytes + B * 45  # stats 8 + 3 floats + 1 flag per item
        flops = 8 * pred.numel()
        bound_ms = max(bytes_moved / HBM_BYTES_PER_S, flops / 67e12) * 1e3
        cluster = cluster_size(B, sms)
        log(f"[kernels] saliency B={B} C={cluster}: max_abs_err {err} | device time cold "
            f"{cold_ms * 1e3} us ({n_copies} input copies; {cold_rec} of 50 launches "
            f"recorded), bound {bound_ms * 1e3} us (bytes, HBM), share of bound "
            f"(bound/cold) {bound_ms / cold_ms:.3f} | hot (L2) {hot_ms * 1e3} us "
            f"({hot_rec} of 50) | plain {plain_ms * 1e3} us | wrapper call back "
            f"to back {call_ms * 1e3} us | {card}")
        # ms is the cold time: the HBM byte bound holds only for inputs read
        # from HBM, and inputs hot in L2 can beat it
        rec[B] = dict(cluster=cluster, max_abs_err=err, ms=cold_ms, hot_ms=hot_ms,
                      plain_ms=plain_ms, bound_ms=bound_ms, call_ms=call_ms,
                      ms_launches_recorded=[cold_rec, 50],
                      hot_ms_launches_recorded=[hot_rec, 50])
    return rec


def build_args(out_dir, extra=(), defaults=False):
    """The run's flags: the exact render in fp32 (``--render_twopass False
    --bf16 False``), or with ``defaults`` no render or dtype flag at all."""
    from avdn_tpu_torch.config import parse_args

    numerics = [] if defaults else ["--render_twopass", "False", "--bf16", "False"]
    return parse_args([
        "--output_dir", out_dir, "--seed", str(SEED),
        "--max_action_len", str(T_STEPS), "--batch_size", str(SERVE_BATCH),
        *numerics, *extra,
    ])


def _rollouts_agree(fused, step, where):
    """The fused HA eval against the step loop: stop flags identical;
    actions, corners, HA precision, recall and NSS within 1e-4."""
    import torch

    for name in ("alive_pre", "alive_post", "ha_valid"):
        if not torch.equal(getattr(fused, name), getattr(step, name)):
            fail(f"{where}: {name} differ between the fused and step HA evals")
    m = step.ha_valid
    err = 0.0
    for name in ("actions_wp", "actions_alt", "pred_progress", "corners",
                 "ha_precision", "ha_recall", "ha_nss"):
        a, b = getattr(fused, name), getattr(step, name)
        if name.startswith("ha_"):
            a, b = a[m], b[m]
        d = (a - b).abs().max().item() if a.numel() else 0.0
        if not d <= 1e-4:
            fail(f"{where}: {name} differ by {d} between the fused and step HA evals")
        err = max(err, d)
    return err


def phase_slice(card, device="cuda", extra_args=()):
    import numpy as np
    import torch

    from avdn_tpu_torch.metrics.nav import assemble_trajectories, eval_metrics
    from avdn_tpu_torch.ops.saliency import saliency_stats
    from avdn_tpu_torch.serve import Navigator
    from avdn_tpu_torch.train.step import make_eval_rollout

    maps = make_maps(device)
    by_name = {f"smoke_map_{k}": maps[k] for k in range(N_MAPS)}
    items = make_items()
    args = build_args(os.path.join(ROOT, "build", "chip_smoke"), extra_args)

    t0 = time.perf_counter()
    nav = Navigator(args, serve_batch=SERVE_BATCH, device=device,
                    map_loader=lambda it: by_name[it["map_name"]])
    sync(device)
    log(f"[slice] Navigator built in {time.perf_counter() - t0:.3f} s "
        f"(BERT {nav.bert.cfg.num_layers}x{nav.bert.cfg.hidden_size}, trunk "
        f"{nav.vln.cfg.encoder_layers}x{nav.vln.cfg.demb}, Darknet "
        f"{sum(p.numel() for p in nav.darknet.parameters())} params, bank "
        f"{tuple(nav.bank.array.shape)})")

    # ---- serving: 3 requests of 8 items; no saliency statistics ----
    saliency_stats.launches = 0
    t0 = time.perf_counter()
    preds = {}
    for lo in range(0, N_ITEMS, SERVE_BATCH):
        preds.update(nav.navigate(items[lo: lo + SERVE_BATCH]))
    serve_s = time.perf_counter() - t0
    serve_launches = saliency_stats.launches
    if len(preds) != N_ITEMS:
        fail(f"serving returned {len(preds)} predictions, expected {N_ITEMS}")
    for rec in preds.values():
        corners = np.stack([np.asarray(c) for c, _ in rec["path_corners"]])
        if corners.shape[1:] != (4, 2) or not np.isfinite(corners).all():
            fail("serving: non-finite or misshapen path corners")
    if serve_launches != 0:
        fail(f"serving launched saliency_stats {serve_launches} times, expected 0")
    log(f"[slice] serving: {len(preds)} predictions in {serve_s:.3f} s "
        f"(3 requests x {SERVE_BATCH}), saliency_stats launches 0 | {card}")

    # ---- validation: student nav eval, fused and step-by-step HA evals ----
    import dataclasses

    paths = (
        ("nav_eval", make_eval_rollout(nav.cfg, nav.bert, nav.darknet, nav.vln,
                                       teacher=False, compute_losses=True), T_STEPS),
        ("ha_eval_fused", make_eval_rollout(nav.cfg, nav.bert, nav.darknet, nav.vln,
                                            teacher=True, collect_ha=True), 1),
        ("ha_eval_step", make_eval_rollout(
            dataclasses.replace(nav.cfg, fused_teacher=False), nav.bert, nav.darknet,
            nav.vln, teacher=True, collect_ha=True), T_STEPS),
    )
    on_card = torch.device(device).type == "cuda"
    norm = [Navigator._normalize_item(it) for it in items]
    chunks = [nav.prepare(norm[lo: lo + SERVE_BATCH])
              for lo in range(0, N_ITEMS, SERVE_BATCH)]
    sync(device)
    launches, outs, ha_metrics = {}, {}, {}
    for name, fn, per_batch in paths:
        saliency_stats.launches = 0
        t0 = time.perf_counter()
        out_preds, walls, outs[name] = {}, [], []
        for bank, batch, meta in chunks:
            tb = time.perf_counter()
            before = saliency_stats.launches
            out = fn(bank, batch, torch.Generator(device).manual_seed(SEED)).cpu()
            walls.append(time.perf_counter() - tb)
            got = saliency_stats.launches - before
            if on_card and got != per_batch:
                fail(f"{name}: {got} saliency_stats launches in a batch, "
                     f"expected {per_batch}")
            if not all(np.isfinite(getattr(out, f).numpy()).all()
                       for f in ("actions_wp", "corners", "loss")):
                fail(f"{name}: non-finite outputs")
            outs[name].append(out)
            out_preds.update(assemble_trajectories(out, meta))
        wall = time.perf_counter() - t0
        launches[name] = saliency_stats.launches
        metrics, _ = eval_metrics(out_preds, human_att_eval=name != "nav_eval")
        ha_metrics[name] = metrics
        log(f"[slice] {name}: {len(out_preds)} episodes in {wall:.3f} s (per batch "
            f"{', '.join(f'{w:.3f}' for w in walls)} s), saliency_stats launches "
            f"{launches[name]} ({per_batch} per batch of {SERVE_BATCH}, N = "
            f"{SERVE_BATCH * (T_STEPS if per_batch == 1 else 1)}) "
            f"{json.dumps(metrics, sort_keys=True)} | {card}")
    err = max(_rollouts_agree(f, s, f"batch {i}") for i, (f, s) in enumerate(
        zip(outs["ha_eval_fused"], outs["ha_eval_step"])))
    for k, v in ha_metrics["ha_eval_step"].items():
        if not abs(ha_metrics["ha_eval_fused"][k] - v) <= 1e-4:
            fail(f"HA metric {k}: fused {ha_metrics['ha_eval_fused'][k]} vs step {v}")
    log(f"[slice] fused vs step HA eval: stops identical, max diff {err} "
        "(actions, corners, HA), HA metrics within 1e-4")
    return nav, norm, maps, launches
def write_dataset(root, maps, items, train_items):
    """The smoke items as an ANDH dataset: ``val_seen`` (the first 16
    items), ``val_unseen`` (the other 8), ``train`` (24 more items of the
    same kind over the same maps) and the maps as .tif files (BGR, as OpenCV
    writes and the bank decodes them)."""
    import cv2

    anno = os.path.join(root, "AVDN", "annotations")
    img = os.path.join(root, "AVDN", "train_images")
    os.makedirs(anno, exist_ok=True)
    os.makedirs(img, exist_ok=True)
    for k, m in enumerate(maps):
        if not cv2.imwrite(os.path.join(img, f"smoke_map_{k}.tif"), m[:, :, ::-1]):
            fail(f"could not write smoke_map_{k}.tif")
    for split, part in (("val_seen", items[:16]), ("val_unseen", items[16:]),
                        ("train", train_items)):
        with open(os.path.join(anno, f"{split}_data.json"), "w") as f:
            json.dump(part, f)


def save_agent(nav, path):
    """The Navigator's weights as a reference-format agent checkpoint, with
    the ``position_ids`` buffer a released HF BERT carries."""
    import torch

    blob = {}
    for key, model in (("lang_model", nav.bert), ("vision_model", nav.darknet),
                       ("vln_model", nav.vln)):
        sd = {k: v.cpu() for k, v in model.state_dict().items()}
        blob[key] = {"epoch": 1, "state_dict": sd}
    blob["lang_model"]["state_dict"]["bert.embeddings.position_ids"] = \
        torch.arange(512)[None]
    torch.save(blob, path)


VALID_ROOT = os.path.join(ROOT, "build", "chip_smoke_valid")


def phase_valid(card, nav, maps, device="cuda", extra_args=(), defaults=False):
    """``valid()`` at full width on the smoke dataset: T saliency launches
    per nav batch and one per HA batch, the metric keys of the golden with
    finite values. The exact-mode run writes the dataset and ``nav``'s
    weights as the checkpoint and runs without ``--inference`` (no debug
    images); the ``defaults`` run (no render or dtype flag) is the CLI's
    ``--inference True``, debug images included."""
    root = VALID_ROOT
    pt = os.path.join(root, "agent.pt")
    tag = "[defaults]" if defaults else "[valid]"
    if not defaults:
        t0 = time.perf_counter()
        write_dataset(os.path.join(root, "data"), maps, make_items(),
                      make_items(SEED + 3, prefix="t"))
        save_agent(nav, pt)
        log(f"[valid] dataset and checkpoint written in {time.perf_counter() - t0:.3f} s")
    args = build_args(os.path.join(root, "out_defaults" if defaults else "out"), [
        "--root_dir", os.path.join(root, "data"),
        "--inference", "True" if defaults else "False",
        "--resume_file", pt, *extra_args], defaults=defaults)
    return run_valid(tag, args, card, device, defaults)


def run_valid(tag, args, card, device="cuda", defaults=False):
    """``valid(args)`` on the smoke dataset's val splits: T saliency launches
    per nav batch and one per HA batch (checked on the card), the metric
    keys of the golden (``eval_metrics_twopass_bf16.json`` with
    ``defaults``, else ``eval_metrics_exact.json``) with finite values, and
    under ``--inference`` the debug images. Returns the launches."""
    import torch

    from avdn_tpu_torch.ops.saliency import saliency_stats
    from avdn_tpu_torch.train.loop import valid

    for name in ("metrics.jsonl", "valid.txt"):
        if os.path.exists(os.path.join(args.log_dir, name)):
            os.remove(os.path.join(args.log_dir, name))

    saliency_stats.launches = 0
    t0 = time.perf_counter()
    results, timers = valid(args, device=device)
    sync(device)
    wall = time.perf_counter() - t0
    launches = saliency_stats.launches
    n_batches = -(-16 // args.batch_size) + -(-8 // args.batch_size)
    want = n_batches * (T_STEPS + 1)
    if torch.device(device).type == "cuda" and launches != want:
        fail(f"{tag} valid: {launches} saliency_stats launches, expected {want} "
             f"(T = {T_STEPS} per nav batch, 1 per HA batch, {n_batches} batches each)")

    golden_name = "eval_metrics_twopass_bf16.json" if defaults else "eval_metrics_exact.json"
    with open(os.path.join(ROOT, "tests", "golden", golden_name)) as f:
        golden = set(json.load(f))
    with open(os.path.join(args.log_dir, "metrics.jsonl")) as f:
        got = {k: v for line in f for k, v in json.loads(line).items()
               if k != "step" and not k.startswith("throughput/")}
    with open(os.path.join(args.log_dir, "valid.txt")) as f:
        mode_line = f.readline().strip()
    if set(got) != golden:
        fail(f"{tag} valid: metric keys differ from {golden_name}'s: "
             f"+{sorted(set(got) - golden)} -{sorted(golden - set(got))}")
    bad = [k for k, v in got.items() if not (isinstance(v, float) and v == v
                                              and abs(v) != float("inf"))]
    if bad:
        fail(f"{tag} valid: non-finite metrics {bad}")
    n_images = 0
    if args.inference:
        images = os.listdir(os.path.join(args.pred_dir, "debug_images"))
        overlays = [n for n in images if "_att" not in n and "_input" not in n]
        heatmaps = [n for n in images if "_pred_att_" in n]
        if len(overlays) < N_ITEMS or not heatmaps:
            fail(f"{tag} valid: {len(overlays)} trajectory overlays and "
                 f"{len(heatmaps)} saliency heatmaps written")
        n_images = len(images)
    t = timers.totals
    log(f"{tag} valid(): {wall:.3f} s wall; nav eval {t['nav_eval']:.3f} s, HA eval "
        f"{t['ha_eval']:.3f} s, debug images {t.get('debug_images', 0.0):.3f} s (the "
        "heatmaps inside the HA eval), map loading "
        f"{t['map_load']:.3f} s summed over decode threads ({timers.counts['map_load']} "
        f"maps, overlapping the evals); saliency_stats launches {launches} "
        f"(T = {T_STEPS} per nav batch, 1 per HA batch); {n_images} debug images | {card}")
    log(f"{tag} {mode_line}")
    log(f"{tag} metrics {json.dumps(results, sort_keys=True)}")
    return launches


def _run_paths(paths, chunks, device, tag, card):
    """Run each ``(name, rollout, launches per batch)`` over the prepared
    chunks from saliency-kernel count 0: the launches per batch (checked on
    the card), finite outputs, the walls and the metrics. Returns
    ``({name: launches}, {name: [outputs]})``."""
    import numpy as np
    import torch

    from avdn_tpu_torch.metrics.nav import assemble_trajectories, eval_metrics
    from avdn_tpu_torch.ops.saliency import saliency_stats

    on_card = torch.device(device).type == "cuda"
    launches, outs = {}, {}
    for name, fn, per_batch in paths:
        saliency_stats.launches = 0
        t0 = time.perf_counter()
        preds, walls, outs[name] = {}, [], []
        for bank, batch, meta in chunks:
            tb = time.perf_counter()
            before = saliency_stats.launches
            out = fn(bank, batch, torch.Generator(device).manual_seed(SEED)).cpu()
            walls.append(time.perf_counter() - tb)
            got = saliency_stats.launches - before
            if on_card and got != per_batch:
                fail(f"{tag} {name}: {got} saliency_stats launches in a batch, "
                     f"expected {per_batch}")
            if not all(np.isfinite(getattr(out, f).numpy()).all()
                       for f in ("actions_wp", "corners", "loss")):
                fail(f"{tag} {name}: non-finite outputs")
            outs[name].append(out)
            preds.update(assemble_trajectories(out, meta))
        wall = time.perf_counter() - t0
        launches[name] = saliency_stats.launches
        metrics, _ = eval_metrics(preds, human_att_eval="ha_eval" in name)
        log(f"{tag} {name}: {len(preds)} episodes in {wall:.3f} s (per batch "
            f"{', '.join(f'{w:.3f}' for w in walls)} s), saliency_stats launches "
            f"{launches[name]} ({per_batch} per batch of {SERVE_BATCH}) "
            f"{json.dumps(metrics, sort_keys=True)} | {card}")
    return launches, outs


def _max_diff(a, b, fields=("actions_wp", "actions_alt", "pred_progress")):
    return max((getattr(a, f) - getattr(b, f)).abs().max().item() for f in fields)


def phase_defaults(card, nav_exact, maps, device="cuda", extra_args=()):
    """The shipped eval defaults, chosen as a user gets them: no render or
    dtype flag, the crop sized from the phase-5 dataset's annotations. Checks
    that they resolve to the two-pass render with the auto crop (1024 px at
    5e-6 deg/px), bf16 towers (fp32 on the CPU) and the BN fold; serves 3
    requests of 8 (no saliency launch); runs the student nav eval (T
    launches per batch) and the time-fused HA eval (1 per batch) over the 24
    items; runs the opt-in modes (``--render_subsample 2``, ``--quant int8``,
    ``--et_decode_trunk True``) on one batch each; holds the fp32 decode
    trunk against the full re-encode (fp32 towers of ``nav_exact``: stops
    identical, actions within 1e-4). Returns the Navigator, the prepared
    chunks and the launch counts by path."""
    import dataclasses

    import numpy as np
    import torch

    from avdn_tpu_torch.ops.saliency import saliency_stats
    from avdn_tpu_torch.serve import Navigator
    from avdn_tpu_torch.sim.warp2pass import auto_render_crop
    from avdn_tpu_torch.train.step import make_eval_rollout

    on_card = torch.device(device).type == "cuda"
    maps_by_name = {f"smoke_map_{k}": maps[k] for k in range(N_MAPS)}
    items = make_items()
    args = build_args(os.path.join(ROOT, "build", "chip_smoke_defaults"), [
        "--root_dir", os.path.join(VALID_ROOT, "data"),
        "--resume_file", os.path.join(VALID_ROOT, "agent.pt"), *extra_args],
        defaults=True)
    t0 = time.perf_counter()
    nav = Navigator(args, serve_batch=SERVE_BATCH, device=device,
                    map_loader=lambda it: maps_by_name[it["map_name"]])
    sync(device)
    cfg = nav.cfg
    dtype = str(torch.bfloat16 if on_card else torch.float32)
    got = dict(render_twopass=cfg.render_twopass, render_crop=cfg.render_crop,
               render_bf16=cfg.render_bf16, fold_bn_eval=cfg.fold_bn_eval,
               quant=cfg.quant, et_decode_trunk=cfg.et_decode_trunk,
               dtypes=[str(m.dtype) for m in (nav.bert, nav.darknet, nav.vln)])
    want = dict(render_twopass=True, render_crop=auto_render_crop(LAT_RATIO),
                render_bf16=True, fold_bn_eval=True, quant="none",
                et_decode_trunk=False, dtypes=[dtype] * 3)
    if got != want:
        fail(f"[defaults] the unset flags resolved to {got}, expected {want}")
    log(f"[defaults] Navigator built in {time.perf_counter() - t0:.3f} s with no render "
        f"or dtype flag: {json.dumps(got)}")

    # ---- serving: 3 requests of 8 items; no saliency statistics ----
    saliency_stats.launches = 0
    t0 = time.perf_counter()
    preds = {}
    for lo in range(0, N_ITEMS, SERVE_BATCH):
        preds.update(nav.navigate(items[lo: lo + SERVE_BATCH]))
    serve_s = time.perf_counter() - t0
    if len(preds) != N_ITEMS or saliency_stats.launches != 0:
        fail(f"[defaults] serving: {len(preds)} predictions, "
             f"{saliency_stats.launches} saliency launches (expected {N_ITEMS}, 0)")
    for rec in preds.values():
        corners = np.stack([np.asarray(c) for c, _ in rec["path_corners"]])
        if corners.shape[1:] != (4, 2) or not np.isfinite(corners).all():
            fail("[defaults] serving: non-finite or misshapen path corners")
    log(f"[defaults] serving: {len(preds)} predictions in {serve_s:.3f} s "
        f"(3 requests x {SERVE_BATCH}), saliency_stats launches 0 | {card}")

    # ---- the nav eval and the fused HA eval over the 24 items ----
    norm = [Navigator._normalize_item(it) for it in items]
    chunks = [nav.prepare(norm[lo: lo + SERVE_BATCH])
              for lo in range(0, N_ITEMS, SERVE_BATCH)]
    sync(device)
    student = make_eval_rollout(cfg, nav.bert, nav.darknet, nav.vln, teacher=False,
                                compute_losses=True)
    launches, outs = _run_paths((
        ("defaults_nav_eval", student, T_STEPS),
        ("defaults_ha_eval_fused", make_eval_rollout(
            cfg, nav.bert, nav.darknet, nav.vln, teacher=True, collect_ha=True), 1),
    ), chunks, device, "[defaults]", card)

    # ---- the opt-in modes, one nav-eval batch each ----
    base = outs["defaults_nav_eval"][0]
    for name, over in (("subsample2", dict(render_twopass=False, render_subsample=2)),
                       ("int8", dict(quant="int8")),
                       ("decode_trunk", dict(et_decode_trunk=True))):
        fn = make_eval_rollout(dataclasses.replace(cfg, **over), nav.bert, nav.darknet,
                               nav.vln, teacher=False, compute_losses=True)
        _, got = _run_paths(((f"mode_{name}", fn, T_STEPS),), chunks[:1], device,
                            "[defaults]", card)
        out = got[f"mode_{name}"][0]
        log(f"[defaults] mode {name} ({json.dumps(over)}): one batch, max action diff "
            f"{_max_diff(out, base)} from the defaults run, stop steps equal "
            f"{torch.equal(out.alive_post, base.alive_post)}")

    # ---- fp32 decode trunk against the full re-encode (exact-mode towers) ----
    bank, batch, _ = nav_exact.prepare(norm[:SERVE_BATCH])
    res = {}
    for decode in (False, True):
        fn = make_eval_rollout(dataclasses.replace(nav_exact.cfg, et_decode_trunk=decode),
                               nav_exact.bert, nav_exact.darknet, nav_exact.vln,
                               teacher=False, compute_losses=True)
        res[decode] = fn(bank, batch, torch.Generator(device).manual_seed(SEED)).cpu()
    err = _max_diff(res[True], res[False])
    if not torch.equal(res[True].alive_post, res[False].alive_post) or not err <= 1e-4:
        fail(f"[defaults] fp32 decode trunk vs full re-encode: stops equal "
             f"{torch.equal(res[True].alive_post, res[False].alive_post)}, actions {err}")
    log(f"[defaults] fp32 decode trunk vs full re-encode at B={SERVE_BATCH}, "
        f"T={T_STEPS}: stop steps identical, max action diff {err}")
    return nav, chunks, launches


def phase_render(card, nav, chunks, device="cuda"):
    """The two-pass render against its references: fp32 on the card vs the
    CPU at B = 2 (views within 1e-3 on the 0–255 scale, saliency equal);
    the bf16 weights vs fp32 on the card at B = 8 (mean < 1.0, p99 < 6.0,
    the bounds of the JAX package's tests); then the per-call time of the
    exact gather and of the two-pass render (bf16 and fp32 weights) at
    B = 8 and at N = T·B = 80, wall and kernels."""
    import torch

    from avdn_tpu_torch.rollout.engine import _corners_to_img
    from avdn_tpu_torch.sim.render import render_batch
    from avdn_tpu_torch.sim.warp2pass import render_batch_twopass

    crop = nav.cfg.render_crop
    bank, batch, _ = chunks[0]
    ep = batch.episode
    quad = _corners_to_img(ep.start_corners, ep.extent, ep.lat_ratio)
    inputs = (ep.map_idx, quad, ep.circles, ep.n_circles)

    def twopass(n, bf16, dev=device, b=bank):
        return render_batch_twopass(b, *(t[:n].to(dev) for t in inputs),
                                    crop_hw=crop, bf16=bf16)

    card_v, card_s = twopass(2, False)
    cpu_v, cpu_s = twopass(2, False, "cpu", bank.cpu())
    err = (card_v.cpu() - cpu_v).abs().max().item()
    if not err <= 1e-3 or not torch.equal(card_s.cpu(), cpu_s):
        fail(f"[render] two-pass fp32 card vs CPU: views {err}, saliency equal "
             f"{torch.equal(card_s.cpu(), cpu_s)}")
    log(f"[render] two-pass fp32 (crop {crop}) card vs CPU at B=2: max view diff {err} "
        "(0-255), saliency identical")
    if torch.device(device).type != "cuda":
        return
    d = (twopass(SERVE_BATCH, True)[0] - twopass(SERVE_BATCH, False)[0]).abs().flatten()
    mean, p99 = d.mean().item(), torch.quantile(d[::7].float(), 0.99).item()
    if not (mean < 1.0 and p99 < 6.0):
        fail(f"[render] two-pass bf16 vs fp32: mean {mean}, p99 {p99} (bounds 1.0, 6.0)")
    log(f"[render] two-pass bf16 vs fp32 weights at B={SERVE_BATCH}: mean |diff| {mean}, "
        f"p99 {p99}, max {d.max().item()} (0-255; bounds 1.0, 6.0)")

    for n in (SERVE_BATCH, T_STEPS * SERVE_BATCH):
        tiled = [t.repeat(-(-n // SERVE_BATCH), *([1] * (t.ndim - 1)))[:n] for t in inputs]
        for name, fn in (
                ("exact", lambda: render_batch(bank, *tiled)),
                ("twopass_bf16", lambda: render_batch_twopass(bank, *tiled, crop_hw=crop)),
                ("twopass_fp32", lambda: render_batch_twopass(bank, *tiled, crop_hw=crop,
                                                              bf16=False))):
            ms = cuda_time_ms(fn, n=1, trials=3)
            got = device_time_ms(fn, n=2)
            kernels = ("not measured (the profiler lost kernel records)" if got is None
                       else f"{got[0]:.4f} ms in {got[1]:g} launches")
            log(f"[render] {name} N={n}: {ms:.4f} ms per call, kernels {kernels} "
                f"(crop {crop}) | {card}")
            torch.cuda.empty_cache()


def phase_parity(nav, items):
    import torch

    from avdn_tpu_torch.data.batcher import make_train_batch
    from avdn_tpu_torch.train.step import make_eval_rollout

    bank, slot_of = nav.bank.prepare(items[:2])
    batch, _ = make_train_batch(items[:2], nav.tokenizer, slot_of, nav.bcfg,
                                device=nav.device)
    card_out = make_eval_rollout(nav.cfg, nav.bert, nav.darknet, nav.vln,
                                 teacher=False)(
        bank, batch, torch.Generator(nav.device).manual_seed(SEED)).cpu()
    cpu_models = [copy.deepcopy(m).cpu() for m in (nav.bert, nav.darknet, nav.vln)]
    cpu_batch, _ = make_train_batch(items[:2], nav.tokenizer, slot_of, nav.bcfg)
    t0 = time.perf_counter()
    cpu_out = make_eval_rollout(nav.cfg, *cpu_models, teacher=False)(
        bank.cpu(), cpu_batch, torch.Generator().manual_seed(SEED))
    if not torch.equal(card_out.alive_post, cpu_out.alive_post):
        fail("card/CPU parity: stop steps differ")
    err = max((getattr(card_out, f) - getattr(cpu_out, f)).abs().max().item()
              for f in ("actions_wp", "actions_alt", "pred_progress"))
    if not err <= 1e-3:
        fail(f"card/CPU parity: actions differ by {err}")
    log(f"[parity] B=2 student rollout, card vs CPU: stop steps identical, "
        f"max action diff {err} (CPU side {time.perf_counter() - t0:.3f} s)")


def profile_rollouts(nav, prepared, card, tag):
    """One nav-eval batch and one fused HA-eval batch of ``nav``'s config:
    the unprofiled wall, the device busy time from torch.profiler, the
    device idle share and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from avdn_tpu_torch.train.step import make_eval_rollout

    bank, batch = prepared
    gen = torch.Generator("cuda").manual_seed(SEED)
    for name, fn in (
            ("nav_eval", make_eval_rollout(nav.cfg, nav.bert, nav.darknet, nav.vln,
                                           teacher=False, compute_losses=True)),
            ("ha_eval_fused", make_eval_rollout(nav.cfg, nav.bert, nav.darknet,
                                                nav.vln, teacher=True, collect_ha=True))):
        fn(bank, batch, gen)
        sync("cuda")
        t0 = time.perf_counter()
        fn(bank, batch, gen)
        sync("cuda")
        wall_ms = (time.perf_counter() - t0) * 1e3
        # kernels only: the host ops would add some 40k events per profiled run
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(bank, batch, gen)
            sync("cuda")

        kernels = kernel_events(prof)
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        log(f"{tag} {name} B={SERVE_BATCH} T={T_STEPS}: wall {wall_ms:.3f} ms "
            f"(unprofiled), kernels {busy_ms:.3f} ms in "
            f"{sum(e.count for e in kernels)} launches (profiled run), device idle "
            f"{1 - busy_ms / wall_ms:.3f} of the unprofiled wall | {card}")
        for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                        reverse=True)[:10]:
            log(f"{tag}   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
                f"{e.key[:90]}")


def time_layers(layers, card, tag, B):
    """Each layer of ``{name: fn}`` timed alone: CUDA events per call (the
    median of 3 runs of 3 calls) and the kernels' device time from
    torch.profiler (5 calls)."""
    for name, fn in layers.items():
        # the fused kernel is one launch per call; other layers' counts
        # are whatever the profiler records
        one = 1 if name == "saliency_reductions" else None
        got = device_time_ms(fn, n=5, launches=one)
        kernels = ("not measured (the profiler lost kernel records)" if got is None
                   else f"{got[0]:.4f} ms in {got[1]:g} launches per call")
        log(f"{tag} layer {name}: {cuda_time_ms(fn, n=3, trials=3):.4f} ms "
            f"per call, kernels {kernels}, at B={B} | {card}")


def phase_profile_defaults(nav, chunks, card):
    """The defaults' nav-eval and fused HA-eval batches profiled, and the
    layers the eval modes add timed alone at B = 8: the bf16 towers (BERT
    twice, the folded Darknet, the trunk over the full history), the int8
    Darknet, one step of the decode trunk and the bf16 two-pass render."""
    import torch

    from avdn_tpu_torch.models import et_fast
    from avdn_tpu_torch.models.darknet import Darknet, fold_darknet_params
    from avdn_tpu_torch.models.darknet_quant import QuantDarknet, quantize_darknet_params
    from avdn_tpu_torch.rollout.engine import RGB_MEAN, RGB_STD, _corners_to_img
    from avdn_tpu_torch.sim.warp2pass import render_batch_twopass
    from avdn_tpu_torch.train.step import _encode_language

    bank, batch, _ = chunks[0]
    profile_rollouts(nav, (bank, batch), card, "[defaults-profile]")
    ep = batch.episode
    B, T = SERVE_BATCH, T_STEPS
    with torch.inference_mode():
        params = fold_darknet_params(nav.darknet.cfg, nav.darknet.state_dict(),
                                     input_std=RGB_STD)
        folded = Darknet(nav.darknet.cfg, folded=True, dtype=nav.darknet.dtype)
        folded = folded.cuda().eval()
        folded.load_state_dict(params)
        quant = QuantDarknet(nav.darknet.cfg)
        quant.qparams = quantize_darknet_params(nav.darknet.cfg, params)
        lang_feat, lang_cls = _encode_language(nav.bert, batch, nav.cfg)
        quad = _corners_to_img(ep.start_corners, ep.extent, ep.lat_ratio)
        views, _ = render_batch_twopass(bank, ep.map_idx, quad, ep.circles,
                                        ep.n_circles, crop_hw=nav.cfg.render_crop)
        x = views - torch.tensor(RGB_MEAN, device="cuda")
        feats = folded(x)
        frames = feats[:, None].expand(B, T, *feats.shape[1:]).float().contiguous()
        dirs = torch.zeros((B, T, 2), device="cuda")
        lengths = torch.full((B,), T, dtype=torch.long, device="cuda")
        lang_kv = et_fast.make_lang_cache(nav.vln, lang_feat, dtype=nav.vln.dtype)
        cache = et_fast.init_cache(nav.vln.cfg, B, T, dtype=nav.vln.dtype, device="cuda")
        time_layers({
            "bert_2_passes_bf16": lambda: _encode_language(nav.bert, batch, nav.cfg),
            "render_twopass_bf16": lambda: render_batch_twopass(
                bank, ep.map_idx, quad, ep.circles, ep.n_circles,
                crop_hw=nav.cfg.render_crop),
            "darknet53_folded_bf16": lambda: folded(x),
            "darknet53_int8": lambda: quant(x),
            "et_trunk_full_history_bf16": lambda: nav.vln(lang_feat, lang_cls, frames,
                                                          dirs, lengths),
            "et_decode_step_bf16": lambda: et_fast.decode_step(
                nav.vln, lang_kv, cache, lang_cls, feats, dirs[:, 0], T - 1, lengths,
                dtype=nav.vln.dtype),
        }, card, "[defaults-profile]", B)


def phase_profile(nav, items, card):
    """Where one nav-eval batch and one fused HA-eval batch (B = 8, T = 10)
    spend their time: the device busy share from torch.profiler, the top
    kernels by device time, and each layer of a rollout step timed alone
    with CUDA events."""
    import torch

    from avdn_tpu_torch.models.darknet import Darknet, fold_darknet_params
    from avdn_tpu_torch.ops.saliency import (saliency_reductions, saliency_reductions_plain,
                                             saliency_upsample)
    from avdn_tpu_torch.rollout.engine import (RGB_MEAN, RGB_STD, _corners_to_img,
                                               dynamics_update)
    from avdn_tpu_torch.sim.oracle import teacher_action_batch
    from avdn_tpu_torch.sim.render import render_batch
    from avdn_tpu_torch.train.step import _encode_language

    bank, batch, _ = nav.prepare(items[:SERVE_BATCH])
    ep = batch.episode
    profile_rollouts(nav, (bank, batch), card, "[profile]")

    B, T = SERVE_BATCH, T_STEPS
    with torch.inference_mode():
        folded = Darknet(nav.darknet.cfg, folded=True).cuda().eval()
        folded.load_state_dict(fold_darknet_params(
            nav.darknet.cfg, nav.darknet.state_dict(), input_std=RGB_STD))
        lang_feat, lang_cls = _encode_language(nav.bert, batch, nav.cfg)
        quad = _corners_to_img(ep.start_corners, ep.extent, ep.lat_ratio)
        views, gt_sal = render_batch(bank, ep.map_idx, quad, ep.circles, ep.n_circles)
        x = views - torch.tensor(RGB_MEAN, device="cuda")
        feats = folded(x)
        frames = feats[:, None].expand(B, T, *feats.shape[1:]).contiguous()
        dirs = torch.zeros((B, T, 2), device="cuda")
        lengths = torch.full((B,), T, dtype=torch.long, device="cuda")
        action, sal_head = nav.vln(lang_feat, lang_cls, frames, dirs, lengths)
        pred_sal = saliency_upsample(sal_head, gt_sal.shape[-1]).float()
        ended = torch.zeros((B,), dtype=torch.bool, device="cuda")
        layers = {
            "bert_2_passes": lambda: _encode_language(nav.bert, batch, nav.cfg),
            "render": lambda: render_batch(bank, ep.map_idx, quad, ep.circles,
                                           ep.n_circles),
            "darknet53_folded": lambda: folded(x),
            "et_trunk_full_history": lambda: nav.vln(lang_feat, lang_cls, frames,
                                                     dirs, lengths),
            "saliency_reductions": lambda: saliency_reductions(pred_sal, gt_sal),
            "saliency_reductions_plain": lambda: saliency_reductions_plain(pred_sal, gt_sal),
            "oracle": lambda: teacher_action_batch(ep.start_corners, ended,
                                                   ep.gt_corners, ep.gt_len, False),
            "dynamics": lambda: dynamics_update(
                ep.start_corners, ep.start_dir, action[:, :2], action[:, 2].clamp(0, 1),
                action[:, 3], 0.5, 0, T, ep.extent),
        }
        time_layers(layers, card, "[profile]", B)


GRAD_BATCHES = SALIENCY_BATCHES
#: a two-conv Darknet for the card-vs-CPU train step (the 224 px input to a
#: (32, 7, 7) feature map, as the full tower's (512, 7, 7))
TINY_DARKNET_CFG = """
[net]
channels=3
height=224
width=224

[convolutional]
batch_normalize=1
filters=16
size=3
stride=8
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=3
stride=4
pad=1
activation=leaky
"""


def head_inputs(N: int, dtype, device):
    """Seeded (N, 8, 8) saliency heads in ``dtype``, (N, 224, 224) ground
    truths and item weights, with a constant head (item 1: a constant map,
    std = 0) and an empty ground truth (item 2)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(SEED + 7 * N)
    x8 = 0.3 + 0.4 * torch.randn((N, 8, 8), generator=g)
    gt = (torch.rand((N, 224, 224), generator=g) > 0.85).float()
    weight = 0.5 + torch.rand(N, generator=g)
    x8[1] = 0.25
    gt[2] = 0.0
    return x8.to(dtype).to(device), gt.to(device), weight.to(device)


#: the head-gradient kernel's tolerance, max abs error over max |grad|
#: against the plain version: fp32 sums in another order; bf16 flips single
#: ulps of a bf16-rounded contraction where the order differs
HEAD_GRAD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
#: bf16: the largest share of the gradient's elements that may differ from
#: the plain version's. Another order flips a few in a thousand; a kernel
#: that dropped the bf16 rounding of dL/dp or of d_rows would change far
#: more, yet (d_rows) stay within HEAD_GRAD_TOL
#: (tests/test_torch_saliency_head.py:test_flip_share_sees_a_dropped_rounding)
HEAD_GRAD_BF16_FLIP_SHARE = 0.01


def phase_grad_kernel(card):
    """The backward of −NSS to the saliency head (``csrc/saliency_head_grad.cu``)
    on the card, at N = 4, 8 and 16 (a step of the LSTM recipe, the reference
    and the production recipe), 40, 80 and 160 (the fused teacher's T·B) and
    240, for float32 and
    bfloat16 heads and each nss_r, on inputs with a constant head (std = 0)
    and an empty ground truth, through ``saliency_head_reductions`` and the
    loss's ``where(valid, −NSS, 0)`` with random item weights: one forward
    and one backward launch per autograd pass, the gradient within
    HEAD_GRAD_TOL of ``saliency_head_grad_plain``'s (in bf16 differing in
    at most HEAD_GRAD_BF16_FLIP_SHARE of its elements), exactly 0 on the
    invalid items, no (N, 224, 224) buffer in the backward
    (``max_memory_allocated``), and, from torch.profiler, no kernel in the
    op's backward but the head kernel (no upsample backward, no GEMM).
    Then three launches bitwise equal, the device time cold (cycling copies
    of the GT maps and heads past the L2) against the HBM byte bound (4
    bytes a pixel of the items whose gradient is not 0, read once) and hot,
    the plain version's, and the wrapper call back to back."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from avdn_tpu_torch.ops.saliency import (saliency_fused, saliency_head_grad,
                                             saliency_head_grad_plain,
                                             saliency_head_reductions, saliency_stats,
                                             saliency_upsample)

    rec = {}
    for N in GRAD_BATCHES:
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            where = f"grad kernel N={N} {dtype_name}"
            x8, gt, weight = head_inputs(N, dtype, "cuda")
            map_bytes = N * gt.shape[1] * gt.shape[2] * 4
            err = flips = 0.0
            for nss_r in (0, 1, -1):
                x = x8.clone().requires_grad_(True)
                fwd, bwd = saliency_stats.launches, saliency_head_grad.launches
                _, neg, valid, _, _ = saliency_head_reductions(x, gt, nss_r)
                loss = (weight * torch.where(valid, neg, 0.0)).sum()
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                loss.backward()
                torch.cuda.synchronize()
                extra = torch.cuda.max_memory_allocated() - base
                if (saliency_stats.launches - fwd, saliency_head_grad.launches - bwd) != (1, 1):
                    fail(f"{where}: {saliency_stats.launches - fwd} forward and "
                         f"{saliency_head_grad.launches - bwd} backward launches, "
                         "expected 1, 1")
                if extra >= map_bytes // 2:
                    fail(f"{where}: the backward allocated {extra} bytes, a "
                         f"full-resolution map is {map_bytes}")
                want = saliency_head_grad_plain(x8, gt, weight * valid, nss_r).float()
                got = x.grad.float()
                e = (got - want).abs().max().item() / want.abs().max().item()
                if not (torch.isfinite(got).all() and e <= HEAD_GRAD_TOL[dtype_name]):
                    fail(f"{where} nss_r={nss_r}: max abs err / max |grad| {e}")
                share = (got != want).float().mean().item()
                if dtype == torch.bfloat16 and share > HEAD_GRAD_BF16_FLIP_SHARE:
                    fail(f"{where} nss_r={nss_r}: {share} of the gradient's elements "
                         f"differ from the plain version's (at most "
                         f"{HEAD_GRAD_BF16_FLIP_SHARE}): a bf16 rounding point dropped?")
                flips = max(flips, share)
                if got[1].abs().max().item() != 0 or got[2].abs().max().item() != 0:
                    fail(f"{where} nss_r={nss_r}: nonzero gradient on the std = 0 "
                         "or Σg = 0 item")
                err = max(err, e)

            # the op's backward alone, under the profiler: the head kernel only
            x = x8.clone().requires_grad_(True)
            _, neg, valid, _, _ = saliency_head_reductions(x, gt)
            up = (weight * valid).contiguous()
            for _ in range(5):  # a session now and then records no kernel
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    torch.autograd.grad(neg, x, up, retain_graph=True)
                    torch.cuda.synchronize()
                names = [e.key for e in kernel_events(prof)]
                if names:
                    break
            if not names or any("head_grad_kernel" not in k for k in names):
                fail(f"{where}: the op's backward launched {names}, expected the "
                     "head kernel alone")

            stats = saliency_fused(saliency_upsample(x8).float(), gt)[0]
            runs = [saliency_head_grad(x8, gt, stats, up) for _ in range(3)]
            torch.cuda.synchronize()
            if not all(torch.equal(runs[0], r) for r in runs[1:]):
                fail(f"{where}: repeated launches differ")
            n_copies = -(-COLD_BYTES // map_bytes)
            copies = [(x8.clone(), gt.clone()) for _ in range(n_copies)]
            turn = itertools.cycle(copies)
            hot_ms, hot_rec = kernel_time_ms(lambda: saliency_head_grad(x8, gt, stats, up))
            cold_ms, cold_rec = kernel_time_ms(
                lambda: saliency_head_grad(*next(turn), stats, up))
            plain = device_time_ms(lambda: saliency_head_grad_plain(x8, gt, up))
            if plain is None:
                fail("torch.profiler recorded no kernel of the plain head gradient")
            call_ms = cuda_time_ms(lambda: saliency_head_grad(x8, gt, stats, up))
            del copies, turn
            live = int(((up != 0) & valid).sum())  # items whose GT the kernel reads
            elt = x8.element_size()
            bytes_moved = (live * map_bytes // N + N * (2 * 64 * elt + 8 * 4 + 4)
                           + 8 * gt.shape[2] * 4)  # GT, x8 in, dx8 out, stats, u, weights
            flops = 14 * live * map_bytes // N // 4
            bound_ms = max(bytes_moved / HBM_BYTES_PER_S, flops / 67e12) * 1e3
            log(f"[grad_kernel] N={N} {dtype_name}: max_abs_err/max|grad| {err}, share "
                f"of elements differing {flips} | device "
                f"time cold {cold_ms * 1e3} us ({n_copies} input copies; {cold_rec} of 50 "
                f"launches recorded), bound {bound_ms * 1e3} us (bytes, HBM; {live} of "
                f"{N} items read), share of bound (bound/cold) {bound_ms / cold_ms:.3f} "
                f"| hot (L2) {hot_ms * 1e3} us ({hot_rec} of 50) | plain "
                f"{plain[0] * 1e3} us in {plain[1]:g} kernels | wrapper call back to "
                f"back {call_ms * 1e3} us | backward kernels {names} | {card}")
            rec.setdefault(str(N), {})[dtype_name] = dict(
                max_abs_err=err, differing_share=flips, ms=cold_ms, hot_ms=hot_ms,
                plain_ms=plain[0], bound_ms=bound_ms, call_ms=call_ms, live_items=live,
                ms_launches_recorded=[cold_rec, 50],
                hot_ms_launches_recorded=[hot_rec, 50])
    return rec


#: B of the teacher oracle: a rollout step of the LSTM recipe, and of the
#: production preset and the validation cell; 40 is on no path and shows
#: that the time does not grow with B (one block an item)
ORACLE_BATCHES = (4, 16, 40)
ORACLE_MAX_T = 12  # --max_gt_len's default


def _same_bits(a, b) -> bool:
    import torch

    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (torch.isnan(a) & torch.isnan(b))).all())


def phase_oracle_kernel(card):
    """The teacher oracle's kernel (``csrc/teacher_oracle.cu``) against
    ``teacher_action_batch_plain`` on the card at ORACLE_BATCHES,
    max_gt_len ORACLE_MAX_T, in both feedback modes: every output bit-equal
    and one launch a call. Then its device time, cold (cycling through input
    copies past the L2) and hot, beside its byte bound (each input byte read
    once, 16 bytes an item written), the plain version's device time and
    kernels a call, and both wall times a call back to back (the plain
    version's is its host's)."""
    import torch

    from avdn_tpu_torch.sim.oracle import teacher_action_batch, teacher_action_batch_plain

    rec = {}
    for B in ORACLE_BATCHES:
        for tf in (True, False):
            args = oracle_inputs(B, ORACLE_MAX_T, SEED + B, "cuda")
            before = teacher_action_batch.launches
            got = teacher_action_batch(*args, tf)
            want = teacher_action_batch_plain(*args, tf)
            torch.cuda.synchronize()
            if teacher_action_batch.launches - before != 1:
                fail(f"oracle B={B}: {teacher_action_batch.launches - before} launches")
            for k in ("waypoint_ratio", "altitude", "progress"):
                if not _same_bits(got[k], want[k]):
                    fail(f"oracle B={B} teacher_forcing={tf}: {k} differs from the "
                         "plain version's")
        set_bytes = sum(t.numel() * t.element_size() for t in args) + 16 * B
        n_copies = -(-COLD_BYTES // set_bytes)
        copies = [t.expand(n_copies, *t.shape).contiguous() for t in args]
        turn = itertools.cycle(range(n_copies))

        def cold():
            i = next(turn)
            return teacher_action_batch(*(c[i] for c in copies), True)

        hot_ms, hot_rec = kernel_time_ms(lambda: teacher_action_batch(*args, True))
        cold_ms, cold_rec = kernel_time_ms(cold)
        plain = device_time_ms(lambda: teacher_action_batch_plain(*args, True), n=5)
        if plain is None:
            fail("torch.profiler recorded no kernel of the plain oracle")
        call_ms = cuda_time_ms(lambda: teacher_action_batch(*args, True))
        plain_call_ms = cuda_time_ms(lambda: teacher_action_batch_plain(*args, True),
                                     n=5, trials=3)
        del copies, turn
        bound_ms = set_bytes / HBM_BYTES_PER_S * 1e3
        log(f"[oracle] B={B} max_gt_len={ORACLE_MAX_T}: bit-equal to the plain version "
            f"in both modes, 1 launch a call | device time cold {cold_ms * 1e3} us "
            f"({cold_rec} of 50 launches recorded), bound {bound_ms * 1e3} us (bytes, "
            f"HBM: {set_bytes} B; the launch's own latency is the real floor) | hot (L2) "
            f"{hot_ms * 1e3} us ({hot_rec} of 50) | plain {plain[0] * 1e3} us of device "
            f"time in {plain[1]:g} kernels a call, wall {plain_call_ms * 1e3} us a call "
            f"| kernel wall a call back to back {call_ms * 1e3} us | {card}")
        rec[str(B)] = dict(ms=cold_ms, hot_ms=hot_ms, bound_ms=bound_ms, bytes=set_bytes,
                           plain_ms=plain[0], plain_kernels=plain[1],
                           plain_call_ms=plain_call_ms, call_ms=call_ms,
                           ms_launches_recorded=[cold_rec, 50],
                           hot_ms_launches_recorded=[hot_rec, 50])
    return rec


TRAIN_ROOT = os.path.join(ROOT, "build", "chip_smoke_train")
PROD_ROOT = os.path.join(ROOT, "build", "chip_smoke_production")
PROD_BATCH = 16  # --preset production's batch_size


def _train_twice(tag, root, out, flags, device, card, batch, entry="train_et"):
    """The train CLI (``avdn_tpu_torch.cli.<entry>``) twice on ``root``'s
    dataset into ``out``: ``--iters 3
    --log_every 1`` (one interval of 3 steps, its checkpoint and
    validation), then ``--resume_file latest`` and 3 more steps. Each step
    timed (synchronised) with its saliency launches, forward and backward;
    on the card the fifth step (the resume run's second) under
    torch.profiler. Checks 6 finite steps, the checkpoints written and
    loadable into ``valid()``'s models and the resume. The peak memory is
    each step's ``max_memory_allocated`` less what was allocated before its
    run began (the run's models, Adam moments and activations; not what the
    caller holds, nor the previous run's state, released first). Returns
    ``(steps, {path: forward launches}, {path: backward launches}, peak
    GiB)``."""
    import gc
    import shutil

    import numpy as np
    import torch

    import avdn_tpu_torch.train.loop as loop
    import importlib

    from avdn_tpu_torch.compat.from_jax import load_agent_weights, load_reference_agent
    from avdn_tpu_torch.ops.saliency import saliency_head_grad, saliency_stats
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    shutil.rmtree(out, ignore_errors=True)
    steps = []  # per step: wall, forward and backward launches, profiled or not
    real = loop.make_train_step
    mem_base = [0]  # bytes allocated when the current run began

    def make_observed_step(*a, **kw):
        step = real(*a, **kw)

        def observed(*sa, **skw):
            sync(device)
            fwd, bwd = saliency_stats.launches, saliency_head_grad.launches
            profiled = on_card and len(steps) == 4  # the resume run's second
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if profiled:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    res = step(*sa, **skw)
                    sync(device)
                steps.append(dict(prof=prof))
            else:
                res = step(*sa, **skw)
                sync(device)
                steps.append({})
            steps[-1].update(wall=time.perf_counter() - t0,
                             fwd=saliency_stats.launches - fwd,
                             bwd=saliency_head_grad.launches - bwd,
                             peak=(torch.cuda.max_memory_allocated() - mem_base[0]
                                   if on_card else float("nan")))
            return res

        return observed

    base = ["--root_dir", root, "--output_dir", out, "--seed", str(SEED),
            "--max_action_len", str(T_STEPS), "--batch_size", str(batch),
            "--iters", "3", "--log_every", "1", *flags]
    fwd_by_path, bwd_by_path, histories = {}, {}, []
    cli_main = importlib.import_module(f"avdn_tpu_torch.cli.{entry}").main
    loop.make_train_step = make_observed_step
    try:
        for name, extra in ((tag, []), (tag + "_resume", ["--resume_file", "latest"])):
            state = history = None  # the previous run's models and moments
            gc.collect()
            if on_card:
                mem_base[0] = torch.cuda.memory_allocated()
            saliency_stats.launches = saliency_head_grad.launches = 0
            t0 = time.perf_counter()
            state, history = cli_main(base + extra, device=device)
            sync(device)
            wall = time.perf_counter() - t0
            fwd_by_path[name] = saliency_stats.launches
            bwd_by_path[name] = saliency_head_grad.launches
            histories += history
            log(f"[{tag}] {name}: {len(history)} steps to step {state.step} in "
                f"{wall:.3f} s (with the checkpoint and the validation), saliency "
                f"launches forward {fwd_by_path[name]} backward {bwd_by_path[name]}, "
                f"{mem_base[0] / 2 ** 30:.2f} GiB allocated before the run | {card}")
    finally:
        loop.make_train_step = real
    peak_gb = max(st["peak"] for st in steps) / 2 ** 30

    if state.step != 6 or len(histories) != 6:
        fail(f"[{tag}] ended at step {state.step} after {len(histories)} steps, "
             "expected 6 (3, then 3 more after the resume)")
    for i, m in enumerate(histories):
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"[{tag}] step {i + 1}: non-finite {m}")
        steps[i]["metrics"] = m
    ckpt_dir = os.path.join(out, "ckpts")
    names = sorted(os.listdir(ckpt_dir))
    if names != ["best_val_unseen.pt", "latest_dict_3.pt", "latest_dict_6.pt"]:
        fail(f"[{tag}] checkpoints written: {names}")
    args = build_args(os.path.join(out, "load"), [*flags, "--root_dir", root,
                                                  "--family", state.family])
    for name in ("latest_dict_6.pt", "best_val_unseen.pt"):
        load_agent_weights(loop.build_models(args, torch.device(device)),
                           load_reference_agent(os.path.join(ckpt_dir, name), args.family))
    with open(os.path.join(out, "logs", "train.txt")) as f:
        resumed = "latest_dict_3.pt, iteration 3" in f.read()
    if not resumed:
        fail(f"[{tag}] the resume run did not load latest_dict_3.pt")
    return steps, fwd_by_path, bwd_by_path, peak_gb


#: launches of one profiled train step when the backward of −NSS wrote the
#: full-resolution gradient for the upsample's backward (PERF.md §5)
EARLIER_STEP_LAUNCHES = {"train": "131,808", "train_production": "142,126-142,142"}


def _train_summary(tag, steps, peak_gb, card, on_card, bwd_per_step=T_STEPS):
    """Per-step lines, the saliency launches held to T + 1 forward and
    ``bwd_per_step`` backward a step (T in the student pass, one at T·B in
    the fused teacher pass; backward only where the loss holds −NSS, the
    student pass at nss_w > 0: the teacher pass runs with nss_w = 0), the
    median wall of the unprofiled steps after the first (which builds and
    tunes) with the first apart, the peak memory and the profiled step
    (device idle share, launches, top kernels)."""
    if on_card:
        for i, st in enumerate(steps):
            if (st["fwd"], st["bwd"]) != (T_STEPS + 1, bwd_per_step):
                fail(f"[{tag}] step {i + 1}: saliency launches forward {st['fwd']} "
                     f"backward {st['bwd']}, expected {T_STEPS + 1}, {bwd_per_step}")
    for i, st in enumerate(steps):
        m = st["metrics"]
        log(f"[{tag}] step {i + 1}: wall {st['wall'] * 1e3:.1f} ms"
            f"{' (profiled)' if 'prof' in st else ''}, loss {m['loss']:.6f}, grad norm "
            f"vln {m['grad_norm_vln']:.6f} bert {m['grad_norm_bert']:.6f}, saliency "
            f"launches forward {st['fwd']} backward {st['bwd']}")
    walls = [st["wall"] for st in steps[1:] if "prof" not in st]
    summary = dict(step_wall_ms_median=statistics.median(walls) * 1e3,
                   first_step_ms=steps[0]["wall"] * 1e3, peak_gb=peak_gb,
                   steps=len(steps), saliency_launches_per_step=[T_STEPS + 1, bwd_per_step])
    if on_card:
        prof_step = next(st for st in steps if "prof" in st)
        kernels = kernel_events(prof_step["prof"])
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        n_launches = sum(e.count for e in kernels)
        summary.update(profiled_wall_ms=prof_step["wall"] * 1e3, busy_ms=busy_ms,
                       launches=n_launches,
                       idle=1 - busy_ms / (summary["step_wall_ms_median"]))
        upsample_bwd = [e.key for e in kernels if "upsample_bilinear2d_backward" in e.key]
        if upsample_bwd:
            fail(f"[{tag}] the profiled step ran the upsample's backward: {upsample_bwd}")
        earlier = (f" ({EARLIER_STEP_LAUNCHES[tag]} with the full-resolution gradient "
                   "and the upsample's backward, PERF.md)" if tag in EARLIER_STEP_LAUNCHES
                   else "")
        log(f"[{tag}] median step wall {summary['step_wall_ms_median']:.1f} ms over "
            f"{len(walls)} unprofiled steps after the first ({summary['first_step_ms']:.1f}"
            f" ms, it builds and tunes); profiled step: kernels {busy_ms:.3f} ms in "
            f"{n_launches} launches{earlier}, no upsample backward, device idle "
            f"{summary['idle']:.3f} of the median wall; step peak memory {peak_gb:.2f} "
            f"GiB (max_memory_allocated over the steps, less what was allocated before "
            f"the run) | {card}")
        for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                        reverse=True)[:12]:
            log(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
                f"{e.key[:90]}")
    return summary


#: dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at 700 W): float32
#: outside the tensor cores (the port turns TF32 off, device.py:
#: use_fp32_numerics) and bf16 on them
PEAK_TFLOPS = {"float32": (67.0, "dense fp32 without tensor cores, TF32 off"),
               "bfloat16": (989.0, "dense bf16 tensor cores")}


def train_mfu(tag, flags, batch, step_ms, card):
    """The model FLOPs of one train step of the run ``flags`` describe
    (``utils/flops.py:train_step_flops``: 2 FLOPs a multiply-add,
    contractions only, BERT's two passes, the teacher and the student
    rollout of T Darknet forwards and trunk passes each, the backward 2×
    the forward), and the median step's MFU against the card's dense peak
    for the towers' dtype. Returns the numbers for the summary."""
    import torch

    from avdn_tpu_torch.config import parse_args
    from avdn_tpu_torch.models.darknet import output_channels
    from avdn_tpu_torch.train.loop import build_models, train_bf16
    from avdn_tpu_torch.utils.flops import train_step_flops

    args = parse_args(["--output_dir", os.path.join(ROOT, "build", "chip_smoke_mfu"),
                       "--max_action_len", str(T_STEPS), "--batch_size", str(batch),
                       *flags])
    bert, darknet, vln = build_models(args, torch.device("meta"))
    flops = train_step_flops(bert.cfg, darknet.cfg, vln.cfg, batch, args.max_action_len,
                             args.max_instr_len, dialog_len=args.dialog_pad,
                             feat_ch=output_channels(darknet.cfg)[-1])
    dtype = "bfloat16" if train_bf16(args) else "float32"
    peak, what = PEAK_TFLOPS[dtype]
    achieved = flops / (step_ms * 1e-3) / 1e12
    log(f"[{tag}] model FLOPs per step {flops:.6e} (utils/flops.py train_step_flops, "
        f"{args.family}, B = {batch}, T = {args.max_action_len}, instructions "
        f"{args.max_instr_len} and dialog {args.dialog_pad} tokens); median step "
        f"{step_ms:.1f} ms: {achieved:.3f} TFLOP/s, MFU {achieved / peak:.5f} against the "
        f"dense peak {peak:g} TFLOP/s ({what}; NVIDIA H100 SXM data sheet) | {card}")
    return dict(model_flops=flops, tflops=achieved, mfu=achieved / peak,
                peak_tflops=peak, peak_dtype=dtype)


def phase_train(card, device="cuda", extra_args=()):
    """The port's train CLI (``python -m avdn_tpu_torch.cli.train_et`` with no
    preset: fp32 towers, the exact render, ``--feedback student``, the fused
    teacher, AdamW) on the phase-5 dataset's train split, from the seed's
    random init, at full width, B = 8, T = 10 (``_train_twice``: 3 steps, a
    checkpoint and a validation at the eval defaults, a resume and 3 more),
    then ``_train_summary``. Returns ``({path: forward launches}, {path:
    backward launches}, summary)``."""
    import torch

    steps, fwd, bwd, peak = _train_twice(
        "train", os.path.join(VALID_ROOT, "data"), os.path.join(TRAIN_ROOT, "out"),
        list(extra_args), device, card, SERVE_BATCH)
    summary = _train_summary("train", steps, peak, card, torch.device(device).type == "cuda")
    summary.update(train_mfu("train", list(extra_args), SERVE_BATCH,
                             summary["step_wall_ms_median"], card))
    return fwd, bwd, summary


def phase_train_production(card, device="cuda", extra_args=()):
    """The production recipe through the train CLI: ``--preset production``
    (batch 16, bf16 towers, the two-pass render in both rollouts, ``--remat``
    with the ``dots`` policy) at full width, T = 10, on a dataset of the
    phase-5 val splits and 48 train items (3 steps an epoch), from the
    seed's random init: ``_train_twice`` and ``_train_summary`` (on the card
    the student pass launches the forward kernel at N = 16 ten times and its
    backward ten times a step, the fused teacher the forward once at N =
    160). Then one step at B = 16 with and without remat, from the same
    weights and batch: the peak memory of each (``max_memory_allocated``
    after a reset) and the wall of the second of two steps."""
    import torch

    from avdn_tpu_torch.config import parse_args
    from avdn_tpu_torch.data.batcher import make_train_batch
    from avdn_tpu_torch.data.maps import DeviceMapBank
    from avdn_tpu_torch.data.tokenizer import WordPieceTokenizer
    from avdn_tpu_torch.serve import Navigator
    from avdn_tpu_torch.train.loop import (batcher_config, build_models, init_state,
                                           resolve_render_crop, train_bf16,
                                           train_config_from_args)
    from avdn_tpu_torch.train.step import create_train_state, make_train_step

    on_card = torch.device(device).type == "cuda"
    data = os.path.join(PROD_ROOT, "data")
    anno = os.path.join(data, "AVDN", "annotations")
    os.makedirs(anno, exist_ok=True)
    train_items = make_items(SEED + 5, prefix="p") + make_items(SEED + 6, prefix="q")
    with open(os.path.join(anno, "train_data.json"), "w") as f:
        json.dump(train_items, f)
    src = os.path.join(VALID_ROOT, "data", "AVDN")
    for split in ("val_seen", "val_unseen"):
        with open(os.path.join(src, "annotations", f"{split}_data.json")) as f:
            part = json.load(f)
        with open(os.path.join(anno, f"{split}_data.json"), "w") as f:
            json.dump(part, f)
    images = os.path.join(data, "AVDN", "train_images")
    if not os.path.exists(images):
        os.symlink(os.path.join(src, "train_images"), images)

    flags = ["--preset", "production", *extra_args]
    steps, fwd, bwd, peak = _train_twice(
        "train_production", data, os.path.join(PROD_ROOT, "out"), flags, device, card,
        PROD_BATCH)
    summary = _train_summary("train_production", steps, peak, card, on_card)
    summary.update(train_mfu("train_production", flags, PROD_BATCH,
                             summary["step_wall_ms_median"], card))

    # one step with and without remat from the same weights and batch
    args = resolve_render_crop(parse_args(flags + [
        "--root_dir", data, "--output_dir", os.path.join(PROD_ROOT, "mem"),
        "--max_action_len", str(T_STEPS)]))
    if not (args.batch_size == PROD_BATCH and train_bf16(args) and args.remat
            and args.remat_policy == "dots" and args.render_twopass):
        fail(f"[train_production] --preset production gave {args}")
    with open(os.path.join(args.train_anno_dir, "train_data.json")) as f:
        items = [Navigator._normalize_item(it) for it in json.load(f)[:PROD_BATCH]]
    bank = DeviceMapBank(args.train_dataset_dir, (args.map_bank_px,) * 2,
                         n_slots=args.map_bank_slots, device=device)
    arr, slots = bank.prepare(items)
    batch, _ = make_train_batch(items, WordPieceTokenizer.load(None), slots,
                                batcher_config(args), device=device)
    for remat in (True, False):
        args.remat = remat
        cfg = train_config_from_args(args)
        models = build_models(args, torch.device(device), bf16=True)
        init_state(models, torch.Generator().manual_seed(SEED))
        state = create_train_state(cfg, *models)
        step = make_train_step(cfg, *models)
        gen = torch.Generator(device).manual_seed(SEED + 1)
        sync(device)
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        for i in range(2):
            t0 = time.perf_counter()
            m = step(state, arr, batch, gen)
            sync(device)
            wall = time.perf_counter() - t0
        gb = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else float("nan")
        key = "remat_dots" if remat else "no_remat"
        summary[f"{key}_peak_gb"] = gb
        summary[f"{key}_step_ms"] = wall * 1e3
        log(f"[train_production] one step at B = {PROD_BATCH}, "
            f"{'--remat dots' if remat else 'no remat'}: peak memory {gb:.2f} GiB "
            f"(max_memory_allocated, the models and Adam moments included), second "
            f"step {wall * 1e3:.1f} ms, loss {float(m['loss']):.6f} | {card}")
        del models, state, step
    return fwd, bwd, summary


#: the card-vs-CPU train step's configurations: the reference numerics, and
#: the production recipe's (bf16 towers, the two-pass render, dots remat)
#: with fp32 render weights on both sides (the CPU's rule) and teacher
#: feedback through the step loop, so that the views and the trajectory do
#: not depend on the towers' roundings and the remat runs in every step
PARITY_CONFIGS = (
    ("fp32", [], 1e-4),
    ("production", ["--bf16", "True", "--render_twopass", "True", "--render_bf16",
                    "False", "--render_crop", "1024", "--remat", "True",
                    "--remat_policy", "dots", "--feedback", "teacher",
                    "--fused_teacher", "False"], 1e-3),
)
#: the production step's control: the same flags with fp32 towers, on the
#: CPU, which the card's bf16 step must differ from by more than the bar
PARITY_CONTROL = ("production", "fp32 towers", ["--bf16", "False"])


def _models_and_batch(args, device, n_items):
    """``args``' models in the train dtype with the seed's weights on
    ``device``, and a train batch of its first ``n_items`` train items:
    ``(models, bank, batch)``."""
    import torch

    from avdn_tpu_torch.data.batcher import make_train_batch
    from avdn_tpu_torch.data.maps import DeviceMapBank
    from avdn_tpu_torch.data.tokenizer import WordPieceTokenizer
    from avdn_tpu_torch.serve import Navigator
    from avdn_tpu_torch.train.loop import batcher_config, build_models, init_state, train_bf16

    with open(os.path.join(args.train_anno_dir, "train_data.json")) as f:
        items = [Navigator._normalize_item(it) for it in json.load(f)[:n_items]]
    models = build_models(args, torch.device(device), bf16=train_bf16(args))
    init_state(models, torch.Generator().manual_seed(SEED))
    bank = DeviceMapBank(args.train_dataset_dir, (args.map_bank_px,) * 2,
                         n_slots=args.map_bank_slots, device=device)
    arr, slots = bank.prepare(items)
    batch, _ = make_train_batch(items, WordPieceTokenizer.load(None), slots,
                                batcher_config(args), device=device)
    return models, arr, batch


def _tiny_setup(flags, device, root=None, work=TRAIN_ROOT):
    """Models at tiny width (BERT 2×64, the tiny Darknet, trunk 1×64 or the
    LSTM cell at demb 64; every dropout rate 0, the seeded weights) on
    ``device`` under ``flags``, and a batch of the first 2 train items (T =
    3) of ``root`` (default: the phase-5 dataset): ``(args, models, bank,
    batch)``. ``work`` holds the tiny Darknet cfg and the run's output."""
    from avdn_tpu_torch.device import use_fp32_numerics
    from avdn_tpu_torch.models.layers import Dropout

    cfg_path = os.path.join(work, "tiny_darknet.cfg")
    os.makedirs(work, exist_ok=True)
    with open(cfg_path, "w") as f:
        f.write(TINY_DARKNET_CFG)
    args = build_args(os.path.join(work, "parity"), [
        "--root_dir", root or os.path.join(VALID_ROOT, "data"), "--demb", "64",
        "--bert_layers", "2", "--encoder_heads", "4", "--encoder_layers", "1",
        "--darknet_model_file", cfg_path, "--max_instr_len", "32",
        "--dialog_pad", "64", "--max_action_len", "3", "--batch_size", "2",
        "--map_bank_slots", "2", *flags])
    use_fp32_numerics()
    models, arr, batch = _models_and_batch(args, device, 2)
    for m in models:
        for mod in m.modules():
            if isinstance(mod, Dropout):
                mod.p = 0.0
    return args, models, arr, batch


def _tiny_train_step(name, flags, device, root=None, work=TRAIN_ROOT):
    """One train step's loss and the three groups' grad norms at tiny width
    (``_tiny_setup``: B = 2, T = 3, every dropout rate 0) on ``device``
    under ``flags``, from the seeded weights."""
    import torch

    from avdn_tpu_torch.train.loop import train_config_from_args
    from avdn_tpu_torch.train.optim import global_norm
    from avdn_tpu_torch.train.step import make_loss_fn

    args, models, arr, batch = _tiny_setup(flags, device, root, work)
    for m in models:
        m.train()
    t0 = time.perf_counter()
    loss = make_loss_fn(train_config_from_args(args), *models)(
        batch, arr, torch.Generator(device).manual_seed(SEED), 2)
    loss.backward()
    res = [float(loss.detach())] + [
        float(global_norm([torch.zeros_like(p) if p.grad is None else p.grad
                           for p in m.parameters()])) for m in models]
    log(f"[train_parity] {name} {device}: loss {res[0]!r}, grad norms bert {res[1]!r} "
        f"darknet {res[2]!r} vln {res[3]!r} ({time.perf_counter() - t0:.3f} s)")
    return res


def _tiny_student_rollout(flags, device, root=None, work=TRAIN_ROOT):
    """One student-forced eval rollout (the nav eval, losses on) at tiny
    width (``_tiny_setup``) on ``device``: its outputs on the CPU."""
    import torch

    from avdn_tpu_torch.train.loop import eval_config_from_args
    from avdn_tpu_torch.train.step import make_eval_rollout

    args, models, arr, batch = _tiny_setup(flags, device, root, work)
    fn = make_eval_rollout(eval_config_from_args(args), *models, teacher=False)
    return fn(arr, batch, torch.Generator(device).manual_seed(SEED)).cpu()


def _rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def phase_train_parity(card, devices=("cuda", "cpu")):
    """One train step's loss and gradients at tiny width (``_tiny_train_step``,
    TF32 off) on the card and on the CPU (plain versions) from the same
    weights and batch, in each of ``PARITY_CONFIGS``: the loss and the three
    groups' grad norms within 1e-4 relative in fp32, and within 1e-3 in the
    production recipe's bf16 (cuBLAS/cuDNN and the CPU's bf16 kernels round
    their sums at other points). The production bar is a few times the
    readings of sound runs (2.553e-4 on an H100, PERF.md), and the control
    (``PARITY_CONTROL``: the CPU's step with fp32 towers, which moves the
    grad norms by about 2e-2) must fall outside it, or the bar could not
    tell a card path that lost bf16's rounding points."""
    for name, flags, tol in PARITY_CONFIGS:
        res = {device: _tiny_train_step(name, flags, device) for device in devices}
        rel = _rel(res[devices[0]], res[devices[1]])
        if not rel <= tol:
            fail(f"[train_parity] {name}: card vs CPU loss / grad norms differ by "
                 f"{rel} relative (bar {tol})")
        log(f"[train_parity] {name}: card vs CPU one train step at tiny width, dropout "
            f"0, TF32 off: loss and grad norms within {rel:.3e} relative (bar {tol}) "
            f"| {card}")
        if name == PARITY_CONTROL[0]:
            ctl = _tiny_train_step(f"{name} with {PARITY_CONTROL[1]} (control)",
                                   flags + PARITY_CONTROL[2], devices[1])
            rel_ctl = _rel(res[devices[0]], ctl)
            if not rel_ctl > tol:
                fail(f"[train_parity] {name}: the control ({PARITY_CONTROL[1]} on the "
                     f"{devices[1]}) is within the bar: {rel_ctl} relative (bar {tol})")
            log(f"[train_parity] {name} control: card's step vs the {devices[1]}'s "
                f"with {PARITY_CONTROL[1]}: {rel_ctl:.3e} relative, outside the bar "
                f"{tol} | {card}")


LSTM_ROOT = os.path.join(ROOT, "build", "chip_smoke_lstm")
LSTM_BATCH = 4  # scripts/run_lstm_haa.sh's batch_size
#: scripts/run_lstm_haa.sh's training flags (its paths, schedule and
#: pretrained-weight flags aside)
LSTM_RECIPE = ["--feedback", "student", "--max_instr_len", "100", "--lr", "1e-5",
               "--optim", "adamW", "--ml_weight", "0.2", "--nss_w", "0", "--nss_r", "0"]


def save_lstm_agent(models, path):
    """``(bert, darknet, lstm)`` as a reference LSTM agent checkpoint:
    ``lang_model`` and ``vln_model``, the Darknet's keys under
    ``vision_model.`` (src/xview_lstm/agent.py:860-877)."""
    import torch

    from avdn_tpu_torch.compat.from_jax import nest_lstm_agent

    bert, darknet, vln = ({k: v.cpu() for k, v in m.state_dict().items()} for m in models)
    torch.save({"lang_model": {"epoch": 1, "state_dict": bert},
                "vln_model": {"epoch": 1, "state_dict": nest_lstm_agent(darknet, vln)}}, path)


def write_lstm_dataset():
    """The LSTM phase's dataset: the phase-5 val splits and maps (linked) and
    12 of its train items, so that B = 4 takes 3 steps an epoch."""
    data = os.path.join(LSTM_ROOT, "data")
    anno = os.path.join(data, "AVDN", "annotations")
    os.makedirs(anno, exist_ok=True)
    src = os.path.join(VALID_ROOT, "data", "AVDN")
    for split, n in (("val_seen", None), ("val_unseen", None), ("train", 3 * LSTM_BATCH)):
        with open(os.path.join(src, "annotations", f"{split}_data.json")) as f:
            part = json.load(f)[:n]
        with open(os.path.join(anno, f"{split}_data.json"), "w") as f:
            json.dump(part, f)
    images = os.path.join(data, "AVDN", "train_images")
    if not os.path.exists(images):
        os.symlink(os.path.join(src, "train_images"), images)
    return data


def phase_lstm(card, maps, device="cuda", extra_args=()):
    """The HAA-LSTM family (``--family lstm``) at full width (BERT-base,
    Darknet-53 at 224 px, ``HAALSTM`` hidden 768 with its 192/576 cells,
    T = 10) on the phase-5 dataset, from the seed's random init written as
    a reference LSTM-layout ``.pt``: Navigator serves 3 requests of 8 (no
    saliency launch); at the reference numerics the student nav eval (T
    launches a batch), the fused HA eval (one at N = T·B = 80) and the step
    HA eval over the 24 items, the two HA evals held against each other;
    one nav-eval and one fused HA-eval batch profiled (wall, kernels,
    launches, idle); ``valid()`` at the reference numerics and at the
    shipped defaults (with ``--inference``); the ``cli.train_lstm`` at ``run_lstm_haa.sh``'s recipe
    (B = 4, student feedback, ``--nss_w 0``): 3 steps, a checkpoint and a
    validation, a resume and 3 more (forward T + 1 and backward 0 launches a
    step); one step at ``--nss_w 0.1`` (the head-gradient kernel T times at
    N = 4, no upsample backward); and at tiny width, dropout 0, one student
    rollout at B = 2 and one train step on the card and on the CPU. Returns
    ``({path: forward launches}, {path: backward launches}, summary)``."""
    import dataclasses

    import torch

    from avdn_tpu_torch.ops.saliency import saliency_stats
    from avdn_tpu_torch.serve import Navigator
    from avdn_tpu_torch.train.loop import build_models, init_state
    from avdn_tpu_torch.train.step import make_eval_rollout

    on_card = torch.device(device).type == "cuda"
    t_phase = [time.perf_counter()]

    def done(name):
        now = time.perf_counter()
        log(f"[time] lstm {name}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    data = write_lstm_dataset()
    pt = os.path.join(LSTM_ROOT, "lstm_agent.pt")
    lstm_flags = ["--family", "lstm", "--root_dir", data, *extra_args]
    args = build_args(os.path.join(LSTM_ROOT, "eval"), [*lstm_flags, "--resume_file", pt])
    models = build_models(args, torch.device(device))
    init_state(models, torch.Generator().manual_seed(SEED))
    save_lstm_agent(models, pt)
    del models
    maps_by_name = {f"smoke_map_{k}": maps[k] for k in range(N_MAPS)}
    nav = Navigator(args, serve_batch=SERVE_BATCH, device=device,
                    map_loader=lambda it: maps_by_name[it["map_name"]])
    sync(device)
    c = nav.vln.cfg
    log(f"[lstm] Navigator built from {os.path.basename(pt)} (BERT "
        f"{nav.bert.cfg.num_layers}x{nav.bert.cfg.hidden_size}, HAALSTM hidden "
        f"{c.hidden_size}, cells {c.dir_hidden}/{c.vis_hidden}, "
        f"{sum(p.numel() for p in nav.vln.parameters())} params; stop threshold "
        f"{nav.cfg.student_stop})")

    # ---- serving: 3 requests of 8 items; no saliency statistics ----
    items = make_items()
    saliency_stats.launches = 0
    t0 = time.perf_counter()
    preds = {}
    for lo in range(0, N_ITEMS, SERVE_BATCH):
        preds.update(nav.navigate(items[lo: lo + SERVE_BATCH]))
    serve_s = time.perf_counter() - t0
    if len(preds) != N_ITEMS or saliency_stats.launches != 0:
        fail(f"[lstm] serving: {len(preds)} predictions, {saliency_stats.launches} "
             f"saliency launches (expected {N_ITEMS}, 0)")
    log(f"[lstm] serving: {len(preds)} predictions in {serve_s:.3f} s "
        f"(3 requests x {SERVE_BATCH}), saliency_stats launches 0 | {card}")

    # ---- the nav eval, the fused and the step HA evals over the 24 items ----
    norm = [Navigator._normalize_item(it) for it in items]
    chunks = [nav.prepare(norm[lo: lo + SERVE_BATCH]) for lo in range(0, N_ITEMS, SERVE_BATCH)]
    sync(device)
    launches, outs = _run_paths((
        ("lstm_nav_eval", make_eval_rollout(nav.cfg, nav.bert, nav.darknet, nav.vln,
                                            teacher=False, compute_losses=True), T_STEPS),
        ("lstm_ha_eval_fused", make_eval_rollout(nav.cfg, nav.bert, nav.darknet, nav.vln,
                                                 teacher=True, collect_ha=True), 1),
        ("lstm_ha_eval_step", make_eval_rollout(
            dataclasses.replace(nav.cfg, fused_teacher=False), nav.bert, nav.darknet,
            nav.vln, teacher=True, collect_ha=True), T_STEPS),
    ), chunks, device, "[lstm]", card)
    err = max(_rollouts_agree(f, s, f"[lstm] batch {i}") for i, (f, s) in enumerate(
        zip(outs["lstm_ha_eval_fused"], outs["lstm_ha_eval_step"])))
    log(f"[lstm] fused vs step HA eval: stops identical, max diff {err} (actions, "
        "corners, HA)")
    if on_card:
        profile_rollouts(nav, chunks[0][:2], card, "[lstm-profile]")
    del nav, chunks, outs
    done("serving and evals")

    # ---- valid(): the reference numerics, then the shipped defaults ----
    launches["lstm_valid"] = run_valid(
        "[lstm]", build_args(os.path.join(LSTM_ROOT, "valid"),
                             [*lstm_flags, "--resume_file", pt]), card, device)
    launches["lstm_defaults_valid"] = run_valid(
        "[lstm defaults]", build_args(os.path.join(LSTM_ROOT, "valid_defaults"),
                                      [*lstm_flags, "--resume_file", pt, "--inference",
                                       "True"], defaults=True), card, device, defaults=True)
    done("valid")

    # ---- the train CLI at run_lstm_haa.sh's recipe ----
    steps, fwd, bwd, peak = _train_twice(
        "train_lstm", data, os.path.join(LSTM_ROOT, "train"),
        [*LSTM_RECIPE, *extra_args], device, card, LSTM_BATCH, entry="train_lstm")
    launches.update(fwd)
    summary = _train_summary("train_lstm", steps, peak, card, on_card, bwd_per_step=0)
    done("train")

    # ---- one step at --nss_w 0.1: the head gradient, T launches at N = B ----
    bwd["lstm_nss_step"] = _lstm_nss_step(card, data, device, extra_args)
    done("nss step")

    # ---- card vs CPU at tiny width, dropout 0 ----
    if on_card:
        card_out, cpu_out = (_tiny_student_rollout(["--family", "lstm"], d)
                             for d in ("cuda", "cpu"))
        if not torch.equal(card_out.alive_post, cpu_out.alive_post):
            fail("[lstm] card vs CPU student rollout: stop steps differ")
        err = _max_diff(card_out, cpu_out)
        if not err <= 1e-4:
            fail(f"[lstm] card vs CPU student rollout: actions differ by {err}")
        res = {d: _tiny_train_step("lstm", ["--family", "lstm"], d) for d in ("cuda", "cpu")}
        rel = _rel(res["cuda"], res["cpu"])
        if not rel <= 1e-4:
            fail(f"[lstm] card vs CPU train step: loss / grad norms differ by {rel}")
        summary.update(card_vs_cpu_rollout=err, card_vs_cpu_train_step=rel)
        log(f"[lstm] card vs CPU at tiny width, dropout 0, TF32 off: student rollout at "
            f"B = 2 stop steps identical, max action diff {err}; one train step's loss "
            f"and grad norms within {rel:.3e} relative (bar 1e-4) | {card}")
    done("parity")
    return launches, bwd, summary


def _lstm_nss_step(card, data, device, extra_args=()):
    """One ``--family lstm`` train step at B = 4, T = 10, ``--nss_w 0.1``,
    full width (after one that builds): the forward kernel T + 1 times, the
    head-gradient kernel T times at N = 4 (the student pass; the teacher
    pass runs at nss_w 0), and under torch.profiler no upsample backward.
    Returns the backward launches of the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from avdn_tpu_torch.ops.saliency import saliency_head_grad, saliency_stats
    from avdn_tpu_torch.train.loop import train_config_from_args
    from avdn_tpu_torch.train.step import create_train_state, make_train_step

    on_card = torch.device(device).type == "cuda"
    args = build_args(os.path.join(LSTM_ROOT, "nss"), [
        "--family", "lstm", "--root_dir", data, *LSTM_RECIPE, "--nss_w", "0.1",
        "--batch_size", str(LSTM_BATCH), *extra_args])
    cfg = train_config_from_args(args)
    models, arr, batch = _models_and_batch(args, device, LSTM_BATCH)
    state = create_train_state(cfg, *models)
    step = make_train_step(cfg, *models)
    gen = torch.Generator(device).manual_seed(SEED + 1)
    step(state, arr, batch, gen)
    sync(device)
    saliency_stats.launches = saliency_head_grad.launches = 0
    t0 = time.perf_counter()
    if on_card:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            m = step(state, arr, batch, gen)
            sync(device)
    else:
        m = step(state, arr, batch, gen)
    wall = time.perf_counter() - t0
    fwd, bwd = saliency_stats.launches, saliency_head_grad.launches
    if on_card and (fwd, bwd) != (T_STEPS + 1, T_STEPS):
        fail(f"[lstm] --nss_w 0.1 step: saliency launches forward {fwd} backward {bwd}, "
             f"expected {T_STEPS + 1}, {T_STEPS}")
    names = [e.key for e in kernel_events(prof)] if on_card else []
    if any("upsample_bilinear2d_backward" in k for k in names):
        fail("[lstm] --nss_w 0.1 step ran the upsample's backward")
    if on_card and not any("head_grad_kernel" in k for k in names):
        fail(f"[lstm] --nss_w 0.1 step: the profiler recorded no head-gradient kernel "
             f"among {len(names)} kernels")
    if not all(torch.isfinite(v) for v in m.values()):
        fail(f"[lstm] --nss_w 0.1 step: non-finite {m}")
    log(f"[lstm] one step at --nss_w 0.1, B = {LSTM_BATCH}: saliency launches forward "
        f"{fwd} backward {bwd} (the head gradient at N = {LSTM_BATCH}), no upsample "
        f"backward, loss {float(m['loss']):.6f}, wall {wall * 1e3:.1f} ms (profiled) | {card}")
    return bwd


# ------------------------------------------------------------ serve_http --


def _http(method, url, obj=None, timeout=600):
    """``(status, JSON body)`` of one request to the port's HTTP server."""
    import urllib.error
    import urllib.request

    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _same_records(recs, preds, items, where):
    """The HTTP records equal ``preds`` (a ``navigate()`` result) item for
    item, in request order, exactly."""
    import numpy as np

    if len(recs) != len(items):
        fail(f"{where}: {len(recs)} records for {len(items)} items")
    for it, rec in zip(items, recs):
        key = it["map_name"] + "__" + it["route_index"]
        want = preds[key]
        if rec["instr_id"] != key:
            fail(f"{where}: record {rec['instr_id']} where {key} was asked")
        for field in ("path_corners", "actions", "progress"):
            got_flat = np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in
                                       _flatten(rec[field])])
            want_flat = np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in
                                        _flatten(want[field])])
            if got_flat.shape != want_flat.shape or not np.array_equal(got_flat, want_flat):
                fail(f"{where}: {key} {field} differs from navigate()'s")


def _flatten(x):
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _flatten(v)]
    return [x]


BENCH_CLIENTS, BENCH_REQUESTS, BENCH_ITEMS = 8, 32, 2  # phase serve_http's bench


def phase_serve_http(card, nav):
    """The port's HTTP front-end (``avdn_tpu_torch.serve_http.make_server``
    on 127.0.0.1) over phase 4's full-width Navigator (fp32, the exact
    render, ``serve_batch`` 8): ``/healthz``; 6 concurrent clients of 4
    items, coalesced into batches of at most 8; one request of 20 items,
    split into batches of 8, 8 and 4 and answered once, in order, equal to
    ``nav.navigate()`` of the same items; a 400 and a 413; no saliency
    launch. Then ``tools/bench_serving_torch.py``'s ``bench`` (8 clients ×
    32 requests × 2 items: 256 requests, so p99 is the 3rd-largest latency,
    not the largest): its JSON line with eps/s, p50/p99 and the Navigator's
    wall by phase. Returns the launches (0)."""
    import importlib.util
    import threading

    from avdn_tpu_torch.ops.saliency import saliency_stats
    from avdn_tpu_torch.serve_http import make_server

    raw = make_items()
    sizes = []
    real_prepare = nav.prepare

    def prepare(chunk):
        sizes.append(len(chunk))
        return real_prepare(chunk)

    nav.prepare = prepare
    saliency_stats.launches = 0
    server = make_server(nav, host="127.0.0.1", port=0, max_wait_ms=200.0, max_items=64)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_port}"
    try:
        code, body = _http("GET", base + "/healthz")
        if code != 200 or body.get("serve_batch") != SERVE_BATCH:
            fail(f"[serve_http] /healthz: {code} {body}")
        _http("POST", base + "/navigate", {"items": raw[:SERVE_BATCH]})  # warm-up
        # 6 concurrent clients of 4 items
        del sizes[:]
        replies = [None] * 6
        t0 = time.perf_counter()

        def client(c):
            its = [dict(it, route_index=f"c{c}k{k}_1")
                   for k, it in enumerate(raw[4 * c: 4 * c + 4])]
            replies[c] = (its, _http("POST", base + "/navigate", {"items": its}))

        threads = [threading.Thread(target=client, args=(c,)) for c in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        for its, (code, body) in replies:
            ids = [r["instr_id"] for r in body.get("predictions", [])]
            if code != 200 or ids != [it["map_name"] + "__" + it["route_index"]
                                      for it in its]:
                fail(f"[serve_http] a concurrent client got {code}: {ids}")
        coalesced = list(sizes)
        if sum(coalesced) != 24 or max(coalesced) > SERVE_BATCH:
            fail(f"[serve_http] 6 clients x 4 items ran as batches of {coalesced}")
        log(f"[serve_http] 6 concurrent clients x 4 items: 24 predictions in "
            f"{wall:.3f} s, coalesced into batches of {coalesced} (at most "
            f"{SERVE_BATCH}) | {card}")
        # one request of 20 items: split into 8, 8 and 4
        big = [dict(raw[k], route_index=f"big{k}_1") for k in range(20)]
        del sizes[:]
        t0 = time.perf_counter()
        code, body = _http("POST", base + "/navigate", {"items": big})
        wall = time.perf_counter() - t0
        split = list(sizes)
        if code != 200 or split != [8, 8, 4]:
            fail(f"[serve_http] the 20-item request: {code}, batches {split}")
        _same_records(body["predictions"], nav.navigate(big), big, "[serve_http] 20 items")
        log(f"[serve_http] one request of 20 items: batches {split}, answered once in "
            f"{wall:.3f} s, in request order, equal to navigate() of the same items | "
            f"{card}")
        code, body = _http("POST", base + "/navigate", {"items": [{"instructions": "x"}]})
        if code != 400 or "item 0" not in body.get("error", ""):
            fail(f"[serve_http] a malformed item: {code} {body}")
        code, body = _http("POST", base + "/navigate", {"items": [{}] * 65})
        if code != 413:
            fail(f"[serve_http] 65 items over max_items 64: {code} {body}")
        log("[serve_http] /healthz 200, a malformed item 400, 65 items over max_items "
            "64 413")
    finally:
        server.shutdown()
        server.service.close()
        thread.join(timeout=60)
        nav.prepare = real_prepare
    spec = importlib.util.spec_from_file_location(
        "bench_serving_torch", os.path.join(ROOT, "tools", "bench_serving_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    res = tool.bench(nav, raw, clients=BENCH_CLIENTS, requests_per_client=BENCH_REQUESTS,
                     items_per_request=BENCH_ITEMS)
    res["config"] = "full width, fp32, exact render"
    res["card"] = card
    log(f"[serve_http] bench_serving_torch {json.dumps(res)}")
    launches = saliency_stats.launches
    if launches != 0:
        fail(f"[serve_http] serving launched saliency_stats {launches} times, expected 0")
    return launches


# ------------------------------------------------------------------- dp --

DP_ROOT = os.path.join(ROOT, "build", "chip_smoke_dp")
DP_BATCH = 4  # items per rank; the global batch is 8
DP_ITEMS = 16  # train items: 8 a rank, 2 steps an epoch at B = 4
DP_TIMEOUT_S = 900  # both ranks' processes, spawn to exit
DP_GROUP_TIMEOUT_S = 600  # a rendezvous or collective waiting on a lost rank
# Two ranks vs one process at the global batch, dropout 0: the loss relative,
# and per group (BERT, Darknet, VLN) the gradient difference's norm over the
# gradient's norm. A direction error shows in the norm of the difference,
# not in the difference of the norms. Sound readings at full width on the
# card (NVIDIA H100 80GB HBM3, 700 W; PERF.md): the loss 9.3e-8, the groups
# 7.6e-7, 1.77e-2, 4.4e-7. The Darknet's is the random-init Darknet-53's
# fp32 conditioning in train-mode BatchNorm (3.4e-2 between the one-process
# step's two BatchNorm formulas; tools/bn_conditioning_torch.py).
DP_LOSS_BAR = 1e-4
DP_DIFF_BARS = (1e-4, 1e-1, 1e-4)


def _over_dp_bars(gap):
    """The largest of ``gap``'s readings as a multiple of its bar."""
    return max([gap["loss_rel"] / DP_LOSS_BAR]
               + [d / b for d, b in zip(gap["diff_rel"], DP_DIFF_BARS)])


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _step_with_grads(cfg, models, arr, batch, group, seed=SEED + 1):
    """One ``make_train_step`` step: ``(loss, {name: the gradient the
    optimizers were given})``."""
    import torch

    from avdn_tpu_torch.train import optim
    from avdn_tpu_torch.train.step import create_train_state, make_train_step

    state = create_train_state(cfg, *models)
    seen = []
    real = optim.Adam.step

    def record(opt, grads, *a, **kw):
        seen.append([g.detach().clone() for g in grads])
        return real(opt, grads, *a, **kw)

    optim.Adam.step = record
    try:
        m = make_train_step(cfg, *models, group=group)(
            state, arr, batch, torch.Generator(arr.device).manual_seed(seed))
    finally:
        optim.Adam.step = real
    grads = {f"{i}.{n}": g for i, (opt, gs) in enumerate(zip(state.optimizers(), seen))
             for n, g in zip(opt.names, gs)}
    return float(m["loss"]), grads


def _grad_gap(got, want):
    """How far the step ``got`` (loss, {name: gradient}) is from ``want``:
    the loss's relative difference; per group (BERT, Darknet, VLN) the
    gradient norm's relative difference and the difference's norm over the
    norm; and the largest difference relative to its leaf's largest
    magnitude, with the leaf (BERT's attention key biases, zero in exact
    arithmetic, relative to their group's largest gradient)."""
    import torch

    def groups(g):
        out = {}
        for k, v in g.items():
            out.setdefault(k.split(".")[0], []).append(k)
        return out

    gap = dict(loss_rel=abs(got[0] - want[0]) / abs(want[0]), norm_rel=[], diff_rel=[])
    worst = (0.0, "")
    for _, keys in sorted(groups(want[1]).items()):
        norm = float(torch.sqrt(sum((want[1][k].double() ** 2).sum() for k in keys)))
        mine = float(torch.sqrt(sum((got[1][k].double() ** 2).sum() for k in keys)))
        diff = float(torch.sqrt(sum(((got[1][k] - want[1][k]).double() ** 2).sum()
                                    for k in keys)))
        gap["norm_rel"].append(abs(mine - norm) / norm)
        gap["diff_rel"].append(diff / norm)
        top = max(float(want[1][k].abs().max()) for k in keys)
        for k in keys:
            scale = top if "attention.self.key.bias" in k else float(want[1][k].abs().max())
            worst = max(worst, (float((got[1][k] - want[1][k]).abs().max())
                                / max(scale, 1e-30), k))
    gap["leaf_worst"], gap["leaf"] = worst
    return gap


def _describe_gap(gap):
    return (f"loss {gap['loss_rel']:.3e} relative; grad norms (BERT, Darknet, VLN) "
            + ", ".join(f"{x:.3e}" for x in gap["norm_rel"]) + " relative; the "
            "differences' norms " + ", ".join(f"{x:.3e}" for x in gap["diff_rel"])
            + f" of the groups'; the largest leaf difference {gap['leaf_worst']:.3e} "
            f"of its max ({gap['leaf']})")


@contextlib.contextmanager
def global_batch_formula():
    """One process's train step computing BatchNorm as the data-parallel
    step does (``BatchNorm2d._global_batch_forward``, the sums local): what
    a world of one computes without the collectives."""
    from avdn_tpu_torch.parallel import batch as pbatch

    real = pbatch.active
    pbatch.active = lambda: True
    try:
        yield
    finally:
        pbatch.active = real


def write_dp_dataset():
    """Phase 5's val splits and maps, and ``DP_ITEMS`` train items."""
    data = os.path.join(DP_ROOT, "data")
    anno = os.path.join(data, "AVDN", "annotations")
    os.makedirs(anno, exist_ok=True)
    with open(os.path.join(anno, "train_data.json"), "w") as f:
        json.dump(make_items(SEED + 7, prefix="d")[:DP_ITEMS], f)
    src = os.path.join(VALID_ROOT, "data", "AVDN")
    for split in ("val_seen", "val_unseen"):
        with open(os.path.join(src, "annotations", f"{split}_data.json")) as f:
            part = json.load(f)
        with open(os.path.join(anno, f"{split}_data.json"), "w") as f:
            json.dump(part, f)
    images = os.path.join(data, "AVDN", "train_images")
    if not os.path.exists(images):
        os.symlink(os.path.join(src, "train_images"), images)
    return data


def _dp_one_process(card, data, device="cuda", extra_args=()):
    """A world of one process (over NCCL on the card) through the real train
    step (full width, B = 8, fp32, the exact render, dropout on; cuDNN's
    deterministic algorithms), against the same step from the same weights
    with no process group: bit-equal to it with BatchNorm's data-parallel
    formula (``global_batch_formula``),
    and the gap to the one-process formula (``F.batch_norm``) reported, the
    loss within 1e-5. Returns the saliency launches of the step in the
    group."""
    import datetime

    import torch
    import torch.distributed as dist

    from avdn_tpu_torch.ops.saliency import saliency_head_grad, saliency_stats
    from avdn_tpu_torch.train.loop import train_config_from_args

    on_card = torch.device(device).type == "cuda"
    args = build_args(os.path.join(DP_ROOT, "nccl"), ["--root_dir", data, *extra_args])
    models, arr, batch = _models_and_batch(args, device, 2 * DP_BATCH)
    twins = [copy.deepcopy(models) for _ in range(2)]
    cfg = train_config_from_args(args)
    # cuDNN's default weight-gradient algorithms add in a run-dependent order
    # (two runs of one step differ in the Darknet's gradients): bit-equality
    # needs its deterministic ones
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=300))
    try:
        saliency_stats.launches = saliency_head_grad.launches = 0
        t0 = time.perf_counter()
        with_group = _step_with_grads(cfg, models, arr, batch, dist.group.WORLD)
        sync(device)
        wall = time.perf_counter() - t0
        launches = (saliency_stats.launches, saliency_head_grad.launches)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    try:
        with global_batch_formula():
            same_formula = _step_with_grads(cfg, twins[0], arr, batch, None)
        plain = _step_with_grads(cfg, twins[1], arr, batch, None)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del models, twins
    if on_card and launches != (T_STEPS + 1, T_STEPS):
        fail(f"[dp] {backend} world of 1: saliency launches {launches}, expected "
             f"({T_STEPS + 1}, {T_STEPS})")
    if not (with_group[0] == same_formula[0] and all(
            torch.equal(g, same_formula[1][k]) for k, g in with_group[1].items())):
        fail(f"[dp] {backend} world of 1 vs no group, the same BatchNorm formula: not "
             f"bit-equal: {_describe_gap(_grad_gap(with_group, same_formula))}")
    gap = _grad_gap(with_group, plain)
    if not gap["loss_rel"] <= 1e-5:
        fail(f"[dp] {backend} world of 1 vs the one-process step: {_describe_gap(gap)} "
             "(bar 1e-5 on the loss)")
    log(f"[dp] {backend} world of 1, the real step at B = {2 * DP_BATCH}, fp32, exact "
        f"render: {wall * 1e3:.1f} ms, loss {with_group[0]!r}; bit-equal to the step "
        f"with no process group and the same BatchNorm formula; against the "
        f"one-process step (F.batch_norm; flax's E[x^2] - E[x]^2 of the all-reduced "
        f"sums here) {_describe_gap(gap)}; saliency launches forward {launches[0]} "
        f"backward {launches[1]} | {card}")
    return launches, gap


def _dp_two_processes(card, data, device="cuda", extra_args=()):
    """``cli.train_et`` in two processes over gloo on the one card (NCCL
    refuses two ranks on one device), B = 4 a rank: 2 steps, a checkpoint
    and a validation, ``--resume_file latest`` and 2 more; then one step
    with dropout 0, and its control, against one process at B = 8.
    Returns each rank's result."""
    port = _free_port()
    procs, logs = [], []
    for rank in range(2):
        env = dict(os.environ, AVDN_NUM_PROCESSES="2",
                   AVDN_COORDINATOR=f"127.0.0.1:{port}", AVDN_PROCESS_ID=str(rank))
        logs.append(open(os.path.join(DP_ROOT, f"rank{rank}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp_worker", str(rank), data,
             device, json.dumps(list(extra_args))],
            cwd=ROOT, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + DP_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for rank, p in enumerate(procs):
        with open(os.path.join(DP_ROOT, f"rank{rank}.log")) as f:
            text = f.read()
        if p.returncode != 0:
            fail(f"[dp] rank {rank} exited {p.returncode}:\n{text[-6000:]}")
    results = []
    for rank in range(2):
        with open(os.path.join(DP_ROOT, f"rank{rank}.json")) as f:
            results.append(json.load(f))
    return results


def dp_worker(rank, data, device="cuda", extra_args=()):
    """One rank of ``_dp_two_processes`` (``python chip_smoke.py --dp_worker
    <rank> <dataset> <device> <extra flags as JSON>``, with the ``AVDN_*``
    variables set). It joins the group over gloo itself (NCCL refuses two
    ranks on one card), so the driver's ``maybe_init_distributed`` finds it
    joined."""
    import hashlib

    import torch

    import avdn_tpu_torch.ops.saliency as sal
    import avdn_tpu_torch.train.checkpoints as ckpt
    import avdn_tpu_torch.train.loop as loop
    from avdn_tpu_torch.cli.train_et import main as cli_main
    from avdn_tpu_torch.models.layers import Dropout
    from avdn_tpu_torch.parallel import batch as pbatch
    from avdn_tpu_torch.parallel.collectives import init_distributed

    init_distributed(os.environ["AVDN_COORDINATOR"], 2, rank, backend="gloo",
                     timeout_s=DP_GROUP_TIMEOUT_S)
    on_card = torch.device(device).type == "cuda"
    # the N of each saliency launch (the counts stay the wrappers')
    by_n = {"fwd": [], "bwd": []}
    real_fused, real_grad = sal.saliency_fused, sal._head_grad_launch

    def fused(pred, *a, **kw):
        by_n["fwd"].append(pred.shape[0])
        return real_fused(pred, *a, **kw)

    def head_grad(x8, *a, **kw):
        by_n["bwd"].append(x8.shape[0])
        return real_grad(x8, *a, **kw)

    sal.saliency_fused, sal._head_grad_launch = fused, head_grad
    steps, saves = [], []
    real_step, real_save = loop.make_train_step, ckpt.save_checkpoint

    def make_observed_step(*a, **kw):
        step = real_step(*a, **kw)

        def observed(*sa, **skw):
            sync(device)
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            f0, b0 = len(by_n["fwd"]), len(by_n["bwd"])
            t0 = time.perf_counter()
            res = step(*sa, **skw)
            sync(device)
            fwd, bwd = by_n["fwd"][f0:], by_n["bwd"][b0:]
            steps.append(dict(wall_ms=(time.perf_counter() - t0) * 1e3,
                              peak_gb=(torch.cuda.max_memory_allocated() / 2 ** 30
                                       if on_card else float("nan")),
                              fwd={str(n): fwd.count(n) for n in sorted(set(fwd))},
                              bwd={str(n): bwd.count(n) for n in sorted(set(bwd))}))
            return res

        return observed

    def save(ckpt_dir, name, *a, **kw):
        saves.append(name)
        return real_save(ckpt_dir, name, *a, **kw)

    loop.make_train_step, ckpt.save_checkpoint = make_observed_step, save
    out = os.path.join(DP_ROOT, "out")
    base = ["--root_dir", data, "--output_dir", out, "--seed", str(SEED),
            "--max_action_len", str(T_STEPS), "--batch_size", str(DP_BATCH),
            "--iters", "2", "--log_every", "1", *extra_args]
    counts0 = (sal.saliency_stats.launches, sal.saliency_head_grad.launches)
    t0 = time.perf_counter()
    cli_main(base, device=device)
    state, history = cli_main(base + ["--resume_file", "latest"], device=device)
    wall = time.perf_counter() - t0
    launches = (sal.saliency_stats.launches - counts0[0],
                sal.saliency_head_grad.launches - counts0[1])
    loop.make_train_step, ckpt.save_checkpoint = real_step, real_save
    digest = hashlib.sha256()
    for m in state.models():
        for t in m.state_dict().values():
            digest.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    for opt in state.optimizers():
        for t in opt.mu + opt.nu:
            digest.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    del state

    # one step at dropout 0 against one process at the global batch
    from avdn_tpu_torch.train.loop import train_config_from_args
    from avdn_tpu_torch.train.step import _micro_batch

    args = build_args(os.path.join(DP_ROOT, f"parity{rank}"),
                      ["--root_dir", data, *extra_args])
    models, arr, batch = _models_and_batch(args, device, 2 * DP_BATCH)
    for m in models:
        for mod in m.modules():
            if isinstance(mod, Dropout):
                mod.p = 0.0
    half = _micro_batch(batch, rank, 2)
    cfg = train_config_from_args(args)
    ref_models = copy.deepcopy(models) if rank == 0 else None
    ctrl_models = copy.deepcopy(models)
    dp = _step_with_grads(cfg, models, arr, half, torch.distributed.group.WORLD)
    del models
    # the control: the same step with BatchNorm on each rank's own statistics
    real_sum = pbatch.batch_sum
    pbatch.batch_sum = lambda x: x
    try:
        ctrl = _step_with_grads(cfg, ctrl_models, arr, half, torch.distributed.group.WORLD)
    finally:
        pbatch.batch_sum = real_sum
    del ctrl_models
    parity = control = None
    if rank == 0:
        with global_batch_formula():
            one = _step_with_grads(cfg, ref_models, arr, batch, None)
        parity = dict(_grad_gap(dp, one), loss=dp[0], one_process_loss=one[0])
        control = dict(_grad_gap(ctrl, one), loss=ctrl[0])
    result = dict(rank=rank, steps=steps, saves=saves, history=history,
                  wall_s=wall, launches=list(launches),
                  digest=digest.hexdigest(), parity=parity, control=control,
                  peak_gb=max(s["peak_gb"] for s in steps))
    with open(os.path.join(DP_ROOT, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    torch.distributed.destroy_process_group()


def phase_dp(card, device="cuda", extra_args=()):
    """Data parallelism on the one card: a world of one process over NCCL
    through the real step (``_dp_one_process``), then two processes
    over gloo (``_dp_two_processes``): both exit 0, rank 0 alone wrote the
    checkpoints, the replicas (weights and Adam moments) bit-identical,
    both ranks' metric records equal, the resume loaded, every step's
    saliency launches 10 at N = 4 and 1 at N = 40 forward and 10 at N = 4
    backward on each rank, and the dropout-0 step within the bars
    (``DP_LOSS_BAR``, ``DP_DIFF_BARS``) of one process at B = 8, which the
    control (the same step with BatchNorm on each rank's own statistics)
    must fail. Returns ``({path: forward launches}, {path: backward
    launches})``."""
    import torch

    import shutil

    on_card = torch.device(device).type == "cuda"
    data = write_dp_dataset()
    if on_card:
        torch.cuda.empty_cache()
    nccl, nccl_gap = _dp_one_process(card, data, device, extra_args)
    if on_card:
        torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(DP_ROOT, "out"), ignore_errors=True)
    t0 = time.perf_counter()
    r0, r1 = _dp_two_processes(card, data, device, extra_args)
    wall = time.perf_counter() - t0
    if r0["digest"] != r1["digest"]:
        fail("[dp] the two ranks' weights and Adam moments differ after 4 steps")
    if r0["saves"] != ["latest_dict_2", "best_val_unseen", "latest_dict_4",
                       "best_val_unseen"] or r1["saves"]:
        fail(f"[dp] checkpoints written: rank 0 {r0['saves']}, rank 1 {r1['saves']}")
    out = os.path.join(DP_ROOT, "out")
    with open(os.path.join(out, "logs", "train.txt")) as f:
        text = f.read()
    if "latest_dict_2.pt, iteration 2" not in text:
        fail("[dp] the resume did not load latest_dict_2.pt")
    recs = []
    for log_dir in ("logs", os.path.join("logs", "proc1")):
        with open(os.path.join(out, log_dir, "metrics.jsonl")) as f:
            recs.append([{k: v for k, v in json.loads(line).items()
                          if not k.startswith("throughput/")} for line in f])
    if recs[0] != recs[1] or not any("spl/val_unseen" in r for r in recs[0]):
        fail("[dp] the two ranks' metric records differ")
    want_fwd = {str(DP_BATCH): T_STEPS, str(DP_BATCH * T_STEPS): 1}
    want_bwd = {str(DP_BATCH): T_STEPS}
    for r in (r0, r1):
        if len(r["steps"]) != 4:
            fail(f"[dp] rank {r['rank']} ran {len(r['steps'])} steps, expected 4")
        for i, st in enumerate(r["steps"]):
            if on_card and (st["fwd"] != want_fwd or st["bwd"] != want_bwd):
                fail(f"[dp] rank {r['rank']} step {i + 1}: saliency launches by N "
                     f"forward {st['fwd']} backward {st['bwd']}, expected {want_fwd} "
                     f"{want_bwd}")
        log(f"[dp] rank {r['rank']}: 4 steps at B = {DP_BATCH} (global "
            f"{2 * DP_BATCH}), walls " + ", ".join(f"{s['wall_ms']:.1f}" for s in
                                                   r["steps"])
            + f" ms; peak memory {r['peak_gb']:.2f} GiB (max_memory_allocated of the "
            f"rank's process); saliency_stats launches {r['launches'][0]} (per step "
            f"{want_fwd} by N), saliency_head_grad {r['launches'][1]} (per step "
            f"{want_bwd}); checkpoints written {r['saves']} | {card}")
    p, c = r0["parity"], r0["control"]
    bars = f"bars: the loss {DP_LOSS_BAR:g}, the differences' norms {DP_DIFF_BARS}"
    if _over_dp_bars(p) > 1.0:
        fail(f"[dp] two ranks vs one process at B = {2 * DP_BATCH}, dropout 0: "
             f"{_describe_gap(p)} ({bars})")
    if _over_dp_bars(c) <= 1.0:
        fail(f"[dp] the control (BatchNorm on each rank's own statistics) passes the "
             f"bars, so they cannot see a missing collective: {_describe_gap(c)} ({bars})")
    log(f"[dp] 2 processes over gloo, cli.train_et 2 steps + validation, resume + 2 "
        f"steps + validation: {wall:.1f} s (both spawns included); replicas "
        f"bit-identical, metric records equal, rank 0 alone wrote checkpoints; one "
        f"step at dropout 0 vs one process at B = {2 * DP_BATCH} (the same BatchNorm "
        f"formula; {bars}): {_describe_gap(p)}; {_over_dp_bars(p):.3g} of the bars | "
        f"{card}")
    log(f"[dp] the control, each rank's BatchNorm on its own statistics, vs one process: "
        f"{_describe_gap(c)}; {_over_dp_bars(c):.3g} of the bars (fails them, as it "
        f"must) | {card}")
    fwd = {"dp_nccl1": nccl[0], "dp_rank0": r0["launches"][0],
           "dp_rank1": r1["launches"][0]}
    bwd = {"dp_nccl1": nccl[1], "dp_rank0": r0["launches"][1],
           "dp_rank1": r1["launches"][1]}
    return fwd, bwd, dict(rank0=r0["steps"], rank1=r1["steps"], parity=p, control=c,
                          nccl_world_of_one_vs_plain=nccl_gap,
                          peak_gb=[r0["peak_gb"], r1["peak_gb"]])


ENTRY_ROOT = os.path.join(ROOT, "build", "chip_smoke_entry")
ENTRY_TIMEOUT_S = 900  # one entry point's process, start to exit
ENTRY_N_TRAIN = 4  # demo train items: one step an epoch at the recipes' B = 4
ENTRY_ITERS = 2  # one interval, 2 epochs (--log_every 2): 2 steps, the second traced
ENTRY_N_VAL = 4  # demo items per val split: one batch at B = 4
ENTRY_VIEWS = 4  # items the viewer draws
RESAMPLE_TILE = (3000, 4000)  # an xView-size tile (2-4k px edges)
NON_ASCII = "Flÿ nörth óver the café, then turn left at the 東 gate"


def start_logged(name, cmd):
    """Start ``cmd`` from the checkout's root in a process group of its own
    (this interpreter's directory first on PATH), its output to
    ``build/chip_smoke_entry/<name>.log``. Returns the run for
    :func:`finish_logged`."""
    env = dict(os.environ, PATH=os.path.dirname(sys.executable) + os.pathsep
               + os.environ.get("PATH", ""))
    out = open(os.path.join(ENTRY_ROOT, name + ".log"), "w")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT,
                            start_new_session=True)
    return dict(name=name, cmd=cmd, proc=proc, out=out, t0=time.perf_counter())


def stop_logged(run):
    """Kill the run's whole process group if it is still running."""
    if run["proc"].poll() is None:
        os.killpg(run["proc"].pid, signal.SIGKILL)
        run["proc"].wait()
    run["out"].close()


def finish_logged(run, timeout=ENTRY_TIMEOUT_S):
    """Wait for a started run (its process group is killed if it outlives
    ``timeout`` from its start). Returns ``(exit code, output, wall s)``."""
    left = timeout - (time.perf_counter() - run["t0"])
    try:
        rc = run["proc"].wait(timeout=max(left, 1.0))
    except subprocess.TimeoutExpired:
        stop_logged(run)
        fail(f"[entry] {run['name']} outlived {timeout} s: {' '.join(run['cmd'])}")
    wall = time.perf_counter() - run["t0"]
    stop_logged(run)
    with open(run["out"].name) as f:
        text = f.read()
    log(f"[entry] {run['name']}: exit {rc} in {wall:.1f} s: {' '.join(run['cmd'])}")
    return rc, text, wall


def run_logged(name, cmd, timeout=ENTRY_TIMEOUT_S):
    """:func:`start_logged` and :func:`finish_logged` in one."""
    return finish_logged(start_logged(name, cmd), timeout)


def _records(out_dir, tag):
    """The run's ``logs/metrics.jsonl`` records, every value finite."""
    import numpy as np

    with open(os.path.join(out_dir, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        if not all(np.isfinite(v) for v in r.values()):
            fail(f"[entry] {tag}: non-finite record {r}")
    return recs


def _trace_launches(trace_path):
    """Launches of the two hand kernels among a Chrome trace's kernels."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return (sum("saliency_fused_kernel" in n for n in names),
            sum("head_grad_kernel" in n for n in names), len(names))


def write_entry_dataset():
    """The demo dataset (``python -m avdn_tpu_torch.data.demo``), with the
    release's ``pretrain_weights``: the default Darknet-53 cfg as
    ``yolo_v3.cfg`` and a ``vocab.txt`` of the special tokens and the demo
    dialogs' words. Returns the root."""
    from avdn_tpu_torch.data.tokenizer import CLS, MASK, PAD, SEP, UNK, basic_tokenize
    from avdn_tpu_torch.models.darknet import default_xview_cfg

    data = os.path.join(ENTRY_ROOT, "data")
    rc, text, _ = run_logged("demo", [sys.executable, "-m", "avdn_tpu_torch.data.demo",
                                      "--out", data, "--n_train", str(ENTRY_N_TRAIN),
                                      "--n_val", str(ENTRY_N_VAL)])
    if rc != 0 or "demo dataset written" not in text:
        fail(f"[entry] the demo generator exited {rc}:\n{text[-4000:]}")
    pw = os.path.join(data, "AVDN", "pretrain_weights")
    os.makedirs(pw, exist_ok=True)
    with open(os.path.join(pw, "yolo_v3.cfg"), "w") as f:
        f.write(default_xview_cfg())
    words = set()
    for split in ("train", "val_seen", "val_unseen"):
        with open(os.path.join(data, "AVDN", "annotations", f"{split}_data.json")) as f:
            for item in json.load(f):
                for text in item["pre_dialogs"] + [item["instructions"]]:
                    words.update(basic_tokenize(text))
    with open(os.path.join(pw, "vocab.txt"), "w") as f:
        f.write("\n".join([PAD, UNK, CLS, SEP, MASK] + sorted(words)) + "\n")
    log(f"[entry] demo dataset under {data}: {len(os.listdir(os.path.join(data, 'AVDN', 'train_images')))} "
        f"tiles, vocab of {len(words) + 5} tokens")
    return data


def start_recipe(family, data, extra_args=()):
    """Start ``bash scripts/run_<family>_haa_torch.sh`` at its recipe with the
    dataset's paths, the depth and a profile directory appended."""
    out = os.path.join(ENTRY_ROOT, f"{family}_out")
    pw = os.path.join(data, "AVDN", "pretrain_weights")
    return start_logged(f"run_{family}_haa_torch", [
        "bash", f"scripts/run_{family}_haa_torch.sh", "--root_dir", data,
        "--output_dir", out, "--iters", str(ENTRY_ITERS),
        "--darknet_model_file", os.path.join(pw, "yolo_v3.cfg"),
        "--darknet_weight_file", os.path.join(pw, "best.pt"),  # absent: random init
        "--profile_dir", os.path.join(out, "profile"), *extra_args])


def check_recipe(card, family, run):
    """A recipe's run: exit 0, one interval's finite losses and a validation
    before and after it, the checkpoints, and the hand kernels in the trace
    of the second step (the backward only at the ET's ``--nss_w 0.1``).
    Returns ``(forward, backward launches in the trace, output dir)``."""
    rc, text, wall = finish_logged(run)
    if rc != 0:
        fail(f"[entry] run_{family}_haa_torch.sh exited {rc}:\n{text[-6000:]}")
    out = os.path.join(ENTRY_ROOT, f"{family}_out")
    recs = _records(out, family)
    losses = [r for r in recs if "loss/IL_loss" in r]
    vals = [r for r in recs if "spl/val_unseen" in r]
    if len(losses) != 1 or len(vals) != 2:
        fail(f"[entry] {family}: {len(losses)} train records and {len(vals)} validation "
             "records, expected 1 and 2 (--eval_first, then the interval's)")
    ckpts = sorted(os.listdir(os.path.join(out, "ckpts")))
    if len(ckpts) != 2 or ckpts[0] != "best_val_unseen.pt" \
            or not ckpts[1].startswith("latest_dict_"):
        fail(f"[entry] {family}: checkpoints {ckpts}")
    fwd, bwd, n = _trace_launches(os.path.join(out, "profile", "trace.json"))
    if fwd == 0 or (bwd > 0) != (family == "et"):
        fail(f"[entry] {family}: the traced step launched the forward kernel {fwd} and "
             f"the backward {bwd} times ({n} kernels)")
    log(f"[entry] run_{family}_haa_torch.sh: {wall:.1f} s for --eval_first, one "
        f"interval ({ckpts[1][len('latest_dict_'):-3]} steps), a checkpoint and a "
        f"validation; IL_loss {losses[0]['loss/IL_loss']:.6f}; val_unseen SPL "
        f"{vals[-1]['spl/val_unseen']:.4f}; the traced second step: saliency forward "
        f"x{fwd}, head gradient x{bwd} of {n} kernels | {card}")
    return fwd, bwd, out


def write_release_checkpoint(path, data, extra_args=()):
    """The seed's random weights at the reference configuration as a
    released ``best_val_unseen``: the reference's ET layout, each entry's
    ``state_dict`` with a torch AdamW ``optimizer`` state, the ET's dead
    modules (``dec_action``, the vision attention's ``c`` head) and HF
    BERT's ``position_ids``."""
    import torch

    from avdn_tpu_torch.config import parse_args
    from avdn_tpu_torch.train.loop import build_models, init_state

    args = parse_args(["--root_dir", data, "--output_dir", os.path.join(ENTRY_ROOT, "ckpt"),
                       "--darknet_model_file",
                       os.path.join(data, "AVDN", "pretrain_weights", "yolo_v3.cfg"),
                       *extra_args])
    models = build_models(args, torch.device("cpu"))
    init_state(models, torch.Generator().manual_seed(SEED))
    g = torch.Generator().manual_seed(SEED + 9)
    blob = {}
    for key, model in zip(("lang_model", "vision_model", "vln_model"), models):
        opt = torch.optim.AdamW(model.parameters(), lr=1e-5)
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
        opt.step()  # the moments a released run leaves behind
        blob[key] = {"epoch": 1, "state_dict": model.state_dict(),
                     "optimizer": opt.state_dict()}
    blob["lang_model"]["state_dict"]["bert.embeddings.position_ids"] = \
        torch.arange(512)[None]
    sd = blob["vln_model"]["state_dict"]
    sd["dec_action.weight"] = torch.randn(args.demb, args.demb, generator=g)
    sd["dec_action.bias"] = torch.randn(args.demb, generator=g)
    sd["attention_layer_vision.c.0.weight"] = torch.randn(256, 768, generator=g)
    torch.save(blob, path)


def _entry_native(card):
    """The host library against its plain versions, on this host: the
    resampler on a generated 3000 × 4000 tile (bit-equal, both timed) and
    the encoder on the demo dialogs and a non-ASCII text (equal ids and
    masks, both timed per batch)."""
    import importlib.util

    import numpy as np

    from avdn_tpu_torch.data.tokenizer import WordPieceTokenizer

    spec = importlib.util.spec_from_file_location(
        "bench_resample", os.path.join(ROOT, "tools", "bench_resample.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    host = f"{bench.cpu_model()}, {os.cpu_count()} cores"
    h, w = RESAMPLE_TILE
    tile = np.random.default_rng(SEED).integers(0, 256, (h, w, 3), dtype=np.uint8)
    rec = bench.time_case(tile, h, int(w * 1.1547), repeats=3)
    if not rec["bit_equal"]:
        fail(f"[entry] native area_resize differs from data/resample.py: {rec}")
    log(f"[entry] area_resize {h}x{w} -> {rec['dst'][0]}x{rec['dst'][1]}: native "
        f"{rec['native_s']:.4f} s, plain (numpy) {rec['plain_s']:.4f} s "
        f"({rec['plain_s'] / rec['native_s']:.2f}x), bit-equal; median of 3 on the host "
        f"({host}) | {card}")

    data = os.path.join(ENTRY_ROOT, "data")
    texts = [NON_ASCII]
    for split in ("val_seen", "val_unseen"):
        with open(os.path.join(data, "AVDN", "annotations", f"{split}_data.json")) as f:
            texts += [" ".join(it["pre_dialogs"]) + " " + it["instructions"]
                      for it in json.load(f)]
    times = {}
    for mode, tok in (("hashed", WordPieceTokenizer.fallback()),
                      ("vocab.txt", WordPieceTokenizer.from_vocab_file(
                          os.path.join(data, "AVDN", "pretrain_weights", "vocab.txt")))):
        for length in (100, 320):  # --max_instr_len and --dialog_pad
            got = tok(texts, max_length=length, pad_to=length)
            want = tok._encode_python(texts, length, length)
            if not all(np.array_equal(a, b) for a, b in zip(got, want)):
                fail(f"[entry] native encoder differs from the Python one ({mode}, {length})")
            native_s, _ = bench.median_s(lambda: tok(texts, length, length), 20)
            plain_s, _ = bench.median_s(lambda: tok._encode_python(texts, length, length), 20)
            times[f"{mode}_{length}"] = (native_s, plain_s)
            log(f"[entry] encoder ({mode} vocabulary, {len(texts)} texts, one non-ASCII, "
                f"max_length = pad_to = {length}): native {native_s * 1e3:.3f} ms, Python "
                f"{plain_s * 1e3:.3f} ms per batch ({plain_s / native_s:.2f}x), equal ids and "
                f"masks; median of 20 on the host ({host}) | {card}")
    return dict(host=host, resample=rec, encoder=times)


def phase_entry(card, extra_args=()):
    """The shipped entry points, each as a user runs it, in a process of its
    own on the card (module docstring, 6e), the independent ones side by
    side; ``extra_args`` are appended to the recipes', ``--inference``'s and
    ``repro_valid``'s flags. Returns ``({path: forward launches}, {path:
    backward launches}, the host library's times)``: the launches seen in
    the recipes' traced steps."""
    import math

    shutil.rmtree(ENTRY_ROOT, ignore_errors=True)
    os.makedirs(ENTRY_ROOT)
    data = write_entry_dataset()
    pw = os.path.join(data, "AVDN", "pretrain_weights")
    empty = os.path.join(ENTRY_ROOT, "empty")
    os.makedirs(empty)
    viz = os.path.join(ENTRY_ROOT, "viz")
    runs = {}
    try:
        runs["et"] = start_recipe("et", data, extra_args)
        runs["lstm"] = start_recipe("lstm", data, extra_args)
        runs["skip"] = start_logged("repro_valid_skip", [
            sys.executable, "tools/repro_valid_torch.py", "--root_dir", empty])
        runs["viewer"] = start_logged("viewer", [
            sys.executable, "tools/visualize_sub_traj_torch.py",
            "--anno_dir", os.path.join(data, "AVDN", "annotations"),
            "--dataset_dir", os.path.join(data, "AVDN", "train_images"),
            "--split", "val_seen", "--out_dir", viz, "--limit", str(ENTRY_VIEWS)])
        write_release_checkpoint(os.path.join(pw, "best_val_unseen"), data, extra_args)
        runs["repro"] = start_logged("repro_valid", [
            "bash", "scripts/repro_valid_torch.sh", data,
            "--output_dir", os.path.join(ENTRY_ROOT, "repro"), *extra_args])

        rc, text, _ = finish_logged(runs["skip"])
        if rc != 0 or "SKIPPED" not in text:
            fail(f"[entry] repro_valid_torch on an empty root exited {rc}:\n{text[-4000:]}")
        rc, text, _ = finish_logged(runs["viewer"])
        jpgs = [n for n in os.listdir(viz) if n.endswith(".jpg")] if os.path.isdir(viz) else []
        if rc != 0 or len(jpgs) != ENTRY_VIEWS:
            fail(f"[entry] the viewer exited {rc} with {len(jpgs)} images:\n{text[-4000:]}")
        log(f"[entry] the viewer wrote {len(jpgs)} images")
        et_fwd, et_bwd, et_out = check_recipe(card, "et", runs["et"])
        runs["inference"] = start_logged("inference", [
            sys.executable, "-m", "avdn_tpu_torch.cli.train_et", "--inference", "True",
            "--resume_file", os.path.join(et_out, "ckpts", "best_val_unseen.pt"),
            "--root_dir", data, "--output_dir", os.path.join(ENTRY_ROOT, "inference"),
            "--max_action_len", str(T_STEPS), "--max_instr_len", "100",
            "--darknet_model_file", os.path.join(pw, "yolo_v3.cfg"), *extra_args])
        lstm_fwd, lstm_bwd, _ = check_recipe(card, "lstm", runs["lstm"])

        rc, text, wall = finish_logged(runs["repro"])
        rows = {}
        for line in text.splitlines():
            parts = line.split()
            if len(parts) == 5 and parts[0] in ("val_seen", "val_unseen") \
                    and parts[4] in ("ok", "DIFF"):
                rows[parts[0], parts[1]] = float(parts[3])
        if rc not in (0, 1) or "SKIPPED" in text or len(rows) != 16 \
                or not all(math.isfinite(v) for v in rows.values()):
            fail(f"[entry] repro_valid_torch.sh exited {rc} with {len(rows)} finite rows "
                 f"(expected 16):\n{text[-6000:]}")
        log(f"[entry] repro_valid_torch.sh on the release layout (random weights): exit "
            f"{rc}, its table of {len(rows)} finite metrics in {wall:.1f} s (DIFF "
            f"expected) | {card}")
        rc, text, wall = finish_logged(runs["inference"])
        if rc != 0 or "Imported reference checkpoint" not in text:
            fail(f"[entry] --inference exited {rc}:\n{text[-6000:]}")
        spl = [r["spl/val_unseen"] for r in _records(os.path.join(ENTRY_ROOT, "inference"),
                                                      "inference") if "spl/val_unseen" in r]
        if len(spl) != 1:
            fail(f"[entry] --inference wrote {len(spl)} validation records")
        log(f"[entry] --inference from the ET run's best_val_unseen.pt: val_unseen SPL "
            f"{spl[0]:.4f} in {wall:.1f} s | {card}")
    finally:
        for run in runs.values():
            stop_logged(run)
    host = _entry_native(card)  # alone: host times on an idle host
    return ({"entry_et_traced_step": et_fwd, "entry_lstm_traced_step": lstm_fwd},
            {"entry_et_traced_step": et_bwd, "entry_lstm_traced_step": lstm_bwd},
            host)


def main() -> None:
    sys.path.insert(0, ROOT)
    try:
        import torch  # noqa: F401

        import avdn_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the repository root")
    t_start = time.perf_counter()
    t_phase = [t_start]

    def done(name):
        now = time.perf_counter()
        log(f"[time] {name}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    card = phase_device()
    phase_build()
    done("device + build")
    krec = phase_kernels(card)
    grec = phase_grad_kernel(card)
    orec = phase_oracle_kernel(card)
    done("kernels")
    nav, items, maps, launches = phase_slice(card)
    from avdn_tpu_torch.utils.debug import format_memory_census

    log("[slice] live tensors on the card:\n" + format_memory_census(10))
    done("slice")
    launches["serve_http"] = phase_serve_http(card, nav)
    done("serve_http")
    launches["valid"] = phase_valid(card, nav, maps)
    done("valid")
    nav_def, chunks, got = phase_defaults(card, nav, maps)
    launches.update(got)
    launches["defaults_valid"] = phase_valid(card, nav, maps, defaults=True)
    done("defaults")
    train_fwd, train_bwd, train_summary = phase_train(card)
    launches.update(train_fwd)
    done("train")
    prod_fwd, prod_bwd, prod_summary = phase_train_production(card)
    launches.update(prod_fwd)
    train_bwd.update(prod_bwd)
    done("train production")
    phase_train_parity(card)
    done("train parity")
    dp_fwd, dp_bwd, dp_summary = phase_dp(card)
    launches.update(dp_fwd)
    train_bwd.update(dp_bwd)
    done("dp")
    lstm_fwd, lstm_bwd, lstm_summary = phase_lstm(card, maps)
    launches.update(lstm_fwd)
    train_bwd.update(lstm_bwd)
    done("lstm")
    entry_fwd, entry_bwd, entry_host = phase_entry(card)
    log(f"[entry] host library: {json.dumps(entry_host)}")
    launches.update(entry_fwd)
    train_bwd.update(entry_bwd)
    done("entry")
    phase_render(card, nav_def, chunks)
    done("render")
    phase_parity(nav, items)
    done("parity")
    phase_profile(nav, items, card)
    done("profile, exact")
    phase_profile_defaults(nav_def, chunks, card)
    done("profile, defaults")
    log(f"[time] all phases: {time.perf_counter() - t_start:.1f} s")

    import torch

    k = krec[SERVE_BATCH]
    g = grec[str(SERVE_BATCH)]["float32"]
    kernels = {"kernels": [{
        "name": "saliency_stats",
        "route": "cuda",
        "source": "avdn_tpu_torch/csrc/saliency_stats.cu",
        "replaces": "avdn_tpu/ops/saliency_pallas.py:41",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max(r["max_abs_err"] for r in krec.values()),
        "ms": k["ms"],
        "ms_launches_recorded": k["ms_launches_recorded"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shape": [SERVE_BATCH, 224, 224],
        "by_batch": {str(B): r for B, r in krec.items()},
    }, {
        "name": "saliency_head_grad",
        "route": "cuda",
        "source": "avdn_tpu_torch/csrc/saliency_head_grad.cu",
        "replaces": ("avdn_tpu/rollout/engine.py:285 (XLA autodiff of "
                     "avdn_tpu/ops/saliency_pallas.py:saliency_stats_xla, the "
                     "saliency_reductions tail and avdn_tpu/models/layers.py:126-131 "
                     "jax.image.resize, the train path; no Pallas kernel)"),
        "launches": sum(train_bwd.values()),
        "launches_by_path": train_bwd,
        "max_abs_err": max(r["max_abs_err"] for by in grec.values() for r in by.values()),
        "ms": g["ms"],
        "ms_launches_recorded": g["ms_launches_recorded"],
        "plain_ms": g["plain_ms"],
        "bound_ms": g["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shape": [SERVE_BATCH, 8, 8],
        "by_batch": grec,
        "train_step": train_summary,
        "train_step_production": prod_summary,
        "train_step_lstm": lstm_summary,
        "train_step_dp": dp_summary,
    }, {
        "name": "teacher_oracle",
        "route": "cuda",
        "source": "avdn_tpu_torch/csrc/teacher_oracle.cu",
        "replaces": ("none: avdn_tpu/sim/oracle.py:teacher_action under vmap, which "
                     "XLA fuses; the port's teacher_action_batch_plain"),
        "launches": None,
        "max_abs_err": 0.0,
        "ms": orec["16"]["ms"],
        "ms_launches_recorded": orec["16"]["ms_launches_recorded"],
        "plain_ms": orec["16"]["plain_ms"],
        "bound_ms": orec["16"]["bound_ms"],
        "bound_by": "bytes (the launch latency in practice)",
        "library_ms": None,
        "shape": [16, ORACLE_MAX_T, 4, 2],
        "by_batch": orec,
    }]}
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp_worker"]:
        dp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4], json.loads(sys.argv[5]))
    else:
        main()
