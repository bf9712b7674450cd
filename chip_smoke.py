#!/usr/bin/env python3
"""Drive the PyTorch port (avdn_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. device  — the card's name and power limit (nvidia-smi), torch and CUDA.
2. build   — every CUDA kernel under avdn_tpu_torch/csrc, one nvcc each, in
             parallel, into build/avdn_tpu_torch/.
3. kernels — each kernel against its plain PyTorch version on the card at
             the main path's shapes (the fused saliency kernel: B = 8 and 16,
             the per-step batches, and 80 and 240, T·B of the fused teacher
             path; each nss_r; repeated launches bitwise equal), with device
             times from torch.profiler, cold (held against the HBM byte
             bound) and hot in L2.
4. slice   — the ET-HAA inference path at full width (BERT-base 12×768,
             Darknet-53 at 224 px, HAA trunk 2×768, T = 10, a 4096 px
             8-slot map bank), fp32 and the exact render, random weights
             from a seed: Navigator serves 3 requests of 8 items (no
             saliency-kernel launch), then the student nav eval and the
             teacher HA eval run over the same 24 items (T launches per
             batch each).
5. parity  — one student rollout at B = 2 on the card and on the CPU (plain
             versions) with the same weights and inputs.
6. profile — one nav-eval batch under torch.profiler (device busy time, top
             kernels) and each layer of a rollout step timed alone.

The line before the last is the JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``. Without a card, or without the package
beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import itertools
import json
import os
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
# B of the saliency kernel: the per-step B (8; 16 in the production preset)
# and the fused teacher path's T·B (80 here; 15 × 16 at the default horizon)
SALIENCY_BATCHES = (SERVE_BATCH, 16, T_STEPS * SERVE_BATCH, 15 * 16)
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
                   attempts: int = 3):
    """Device time of one ``fn()`` and the kernels it launches: the summed
    time of the CUDA kernels that ``n`` calls launch (torch.profiler),
    divided by ``n``, and their count divided by ``n``. On the H100 machine
    a session now and then records no kernel, or fewer than were launched;
    a session that records none, or other than ``launches`` per call where
    that is known, is run again, up to ``attempts`` times, and then the
    result is None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = kernel_events(prof)
        total_us = sum(e.self_device_time_total for e in kernels)
        count = sum(e.count for e in kernels)
        if total_us > 0 and (launches is None or count == launches * n):
            return total_us / 1e3 / n, count / n
        log(f"[profile] torch.profiler session {attempt} of {attempts} recorded "
            f"{count} kernels for {n} calls: " + ", ".join(
                f"{e.count} x {e.key[:60]}" for e in kernels))
    return None


def kernel_time_ms(fn, n: int = 50) -> float:
    """Device time of one launch of a one-kernel ``fn``; fails the run if
    the profiler does not record every launch."""
    got = device_time_ms(fn, n, launches=1)
    if got is None:
        fail("torch.profiler did not record every kernel launched")
    return got[0]


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


def make_items():
    """N_ITEMS ANDH-format items (the fields of avdn_tpu/data/demo.py) over
    the N_MAPS maps: view edges of 40–400 m, 2–5 step GT paths, 1–3
    attention circles, one or two dialog rounds."""
    import numpy as np

    rng = np.random.default_rng(SEED + 2)
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
            "route_index": f"{i}_1",
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
        hot_ms = kernel_time_ms(lambda: saliency_reductions(pred, gt))
        cold_ms = kernel_time_ms(lambda: saliency_reductions(*next(turn)))
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
            f"{cold_ms * 1e3} us ({n_copies} input copies), bound {bound_ms * 1e3} us "
            f"(bytes, HBM), share of bound (bound/cold) {bound_ms / cold_ms:.3f} | hot "
            f"(L2) {hot_ms * 1e3} us | plain {plain_ms * 1e3} us | wrapper call back "
            f"to back {call_ms * 1e3} us | {card}")
        # ms is the cold time: the HBM byte bound holds only for inputs read
        # from HBM, and inputs hot in L2 can beat it
        rec[B] = dict(cluster=cluster, max_abs_err=err, ms=cold_ms, hot_ms=hot_ms,
                      plain_ms=plain_ms, bound_ms=bound_ms, call_ms=call_ms)
    return rec


def build_args(out_dir, extra=()):
    from avdn_tpu_torch.config import parse_args

    return parse_args([
        "--output_dir", out_dir, "--seed", str(SEED),
        "--max_action_len", str(T_STEPS), "--batch_size", str(SERVE_BATCH),
        "--render_twopass", "False", "--bf16", "False",
        "--fused_teacher", "False", *extra,
    ])


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

    # ---- validation: student nav eval + teacher HA eval ----
    nav_eval = make_eval_rollout(nav.cfg, nav.bert, nav.darknet, nav.vln,
                                 teacher=False, compute_losses=True)
    ha_eval = make_eval_rollout(nav.cfg, nav.bert, nav.darknet, nav.vln,
                                teacher=True, collect_ha=True)
    norm = [Navigator._normalize_item(it) for it in items]
    chunks = [nav.prepare(norm[lo: lo + SERVE_BATCH])
              for lo in range(0, N_ITEMS, SERVE_BATCH)]
    sync(device)
    gen = torch.Generator(device).manual_seed(SEED)
    saliency_stats.launches = 0
    for name, fn, ha in (("nav_eval", nav_eval, False), ("ha_eval", ha_eval, True)):
        t0 = time.perf_counter()
        out_preds = {}
        for bank, batch, meta in chunks:
            before = saliency_stats.launches
            out = fn(bank, batch, gen)
            got = saliency_stats.launches - before
            if got != T_STEPS:
                fail(f"{name}: {got} saliency_stats launches in a batch, "
                     f"expected T = {T_STEPS}")
            out = out.cpu()
            if not all(np.isfinite(getattr(out, f).numpy()).all()
                       for f in ("actions_wp", "corners", "loss")):
                fail(f"{name}: non-finite outputs")
            out_preds.update(assemble_trajectories(out, meta))
        wall = time.perf_counter() - t0
        metrics, _ = eval_metrics(out_preds, human_att_eval=ha)
        log(f"[slice] {name}: {len(out_preds)} episodes in {wall:.3f} s "
            f"{json.dumps(metrics, sort_keys=True)} | {card}")
    main_launches = saliency_stats.launches
    if main_launches == 0:
        fail("the main path launched no saliency_stats kernel")
    return nav, norm, main_launches


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


def phase_profile(nav, items, card):
    """Where one nav-eval batch (B = 8, T = 10) spends its time: the device
    busy share from torch.profiler, the top kernels by device time, and each
    layer of a rollout step timed alone with CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from avdn_tpu_torch.models.darknet import Darknet, fold_darknet_params
    from avdn_tpu_torch.ops.saliency import saliency_reductions, saliency_reductions_plain
    from avdn_tpu_torch.rollout.engine import (RGB_MEAN, RGB_STD, _corners_to_img,
                                               dynamics_update)
    from avdn_tpu_torch.sim.oracle import teacher_action_batch
    from avdn_tpu_torch.sim.render import render_batch
    from avdn_tpu_torch.train.step import _encode_language, make_eval_rollout

    bank, batch, _ = nav.prepare(items[:SERVE_BATCH])
    ep = batch.episode
    gen = torch.Generator("cuda").manual_seed(SEED)
    nav_eval = make_eval_rollout(nav.cfg, nav.bert, nav.darknet, nav.vln,
                                 teacher=False, compute_losses=True)
    nav_eval(bank, batch, gen)
    sync("cuda")
    t0 = time.perf_counter()
    nav_eval(bank, batch, gen)
    sync("cuda")
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        nav_eval(bank, batch, gen)
        sync("cuda")

    kernels = kernel_events(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[profile] nav_eval B={SERVE_BATCH} T={T_STEPS}: wall {wall_ms:.3f} ms "
        f"(unprofiled), kernels {busy_ms:.3f} ms in "
        f"{sum(e.count for e in kernels)} launches (profiled run), device idle "
        f"{1 - busy_ms / wall_ms:.3f} of the unprofiled wall | {card}")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:90]}")

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
        action, pred_sal = nav.vln(lang_feat, lang_cls, frames, dirs, lengths)
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
        for name, fn in layers.items():
            # the fused kernel is one launch per call; other layers' counts
            # are whatever the profiler records
            one = 1 if name == "saliency_reductions" else None
            got = device_time_ms(fn, n=20, launches=one)
            kernels = ("not measured (the profiler lost kernel records)" if got is None
                       else f"{got[0]:.4f} ms in {got[1]:g} launches per call")
            log(f"[profile] layer {name}: {cuda_time_ms(fn, n=5, trials=5):.4f} ms "
                f"per call, kernels {kernels}, at B={B} | {card}")


def main() -> None:
    sys.path.insert(0, ROOT)
    try:
        import torch  # noqa: F401

        import avdn_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the repository root")
    card = phase_device()
    phase_build()
    krec = phase_kernels(card)
    nav, items, launches = phase_slice(card)
    phase_parity(nav, items)
    phase_profile(nav, items, card)

    import torch

    k = krec[SERVE_BATCH]
    kernels = {"kernels": [{
        "name": "saliency_stats",
        "route": "cuda",
        "source": "avdn_tpu_torch/csrc/saliency_stats.cu",
        "replaces": "avdn_tpu/ops/saliency_pallas.py:41",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in krec.values()),
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shape": [SERVE_BATCH, 224, 224],
        "by_batch": {str(B): r for B, r in krec.items()},
    }]}
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
