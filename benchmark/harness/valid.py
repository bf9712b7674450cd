"""Traffic kind ``valid``: the port's validation driver,
``train/loop.py:run_validation``, over a seeded val split, again and again
for ``--seconds``.

Each pass is what the train driver runs at every interval: the student nav
eval with its metric records, then the teacher-forced fused HA eval, over
the split (``ANDHDataset`` from annotation JSON under the run directory, the
map bank, prefetched batch assembly). Set-up runs one pass, which warms up
every shape. ``eval_eps`` is the items validated over the window, an item
counting when both passes have run over it; the window closes at the end of
the pass during which ``--seconds`` ran out.

Every rollout output of the window's passes is kept (on the device) and,
after the window, compared record by record with the reference's rollouts
of the same batches, as are the passes' metric records.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from harness import compare, data, kernels, program, refmodels
from harness.weights import init_weights


def run(ctx) -> dict:
    P = program.modules()
    cell, seed, device, tr = ctx.cell, ctx.seed, ctx.device, ctx.cell.traffic
    split = "val_seen"
    items = data.make_items(seed, tr["n_items"], tr["n_maps"], tr["map_px"])
    maps = data.make_maps(seed, tr["n_maps"], tr["map_px"], device)
    data.write_annotations(ctx.run_dir, {split: items})
    args = P.parse_args(ctx.argv, family=cell.config["family"])
    P.use_fp32_numerics()
    bf16 = P.eval_bf16(args, device)
    models = P.build_models(args, device, bf16=bf16)
    init_weights(models, seed, device)
    ecfg = P.eval_config_from_args(args)
    captured = []  # (rollout, batch index, outputs on the device)

    def capture(fn, name):
        state = {"n": 0}

        def call(bank, batch, gen):
            out = ctx.wrap_step(fn(bank, batch, gen))
            captured.append((name, state["n"], out))
            state["n"] += 1
            return out
        return call, state

    student, s_state = capture(P.make_eval_rollout(ecfg, *models, teacher=False), "nav")
    teacher, t_state = capture(P.make_eval_rollout(ecfg, *models, teacher=True,
                                                   collect_ha=True), "ha")
    tokenizer = P.WordPieceTokenizer.load(None)
    bcfg = P.batcher_config(args)
    bank = P.DeviceMapBank(args.val_dataset_dir, (args.map_bank_px,) * 2,
                           n_slots=args.map_bank_slots, device=device,
                           loader=lambda it: maps[it["map_name"]])
    env = P.ANDHDataset(args.val_anno_dir, [split], args.batch_size, seed=seed)
    envs = {split: env}
    writer = P.MetricWriter(args.log_dir, "valid.txt")
    runtime = P.ParallelRuntime()

    def one_pass():
        s_state["n"] = t_state["n"] = 0
        return P.run_validation(args, envs, student, teacher, tokenizer, bank, bcfg,
                                writer, 0, device, runtime)

    first = one_pass()
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start
    captured.clear()

    def passes(seconds=None, n=None):
        results = []
        t0 = time.perf_counter()
        while True:
            results.append(one_pass())
            el = time.perf_counter() - t0
            if (seconds is not None and el >= seconds) or (n is not None and len(results) >= n):
                return results, el

    results, window_s = passes(seconds=ctx.seconds)
    n_items = len(env.data)
    rec = ctx.record
    n_batches = -(-n_items // args.batch_size)
    batch_flops = refmodels.step_flops(ctx.flags, cell.config["family"], "valid")
    rec.update(units=len(results) * n_items, window_s=window_s, unit_name="item",
               flops_per_unit=batch_flops * n_batches / n_items,
               peak_flops=None if bf16 else kernels.FP32_FLOPS)
    window_outputs = list(captured)
    if ctx.trace:
        launches = []

        def traced_pass():
            launches.clear()
            with kernels.recording(P.saliency, launches):
                passes(n=1)
            return n_items

        rec["trace"] = ctx.traced(traced_pass, lambda: passes(n=1) and n_items,
                                  lambda: kernels.counts(launches))
        rec["launches"] = launches
    rec["memory_peak_bytes"] = ctx.memory_peak()
    metrics = {"eval_eps": len(results) * n_items / window_s, "setup_s": setup_s}

    # what the window produced, on the host; then the port is freed
    got = _records(P, window_outputs, env, tokenizer, bcfg, device, args)
    got_metrics = [first] + results
    del models, student, teacher, bank, captured, window_outputs
    gc.collect()
    ctx.free()
    want, want_metrics = reference_pass(ctx, args, maps, seed, split)
    compared = _compare(got, want, got_metrics, want_metrics)
    return dict(metrics=metrics, compared=compared, attempted=len(results) * n_items)


def _records(P, outputs, env, tokenizer, bcfg, device, args):
    """``{(rollout, batch index): records}`` of the captured outputs, the
    batches' metadata rebuilt by the port's batcher from the split's order."""
    from avdn_tpu_torch.metrics.nav import assemble_trajectories

    metas = []
    for items in env:
        _, meta = P.make_train_batch(items, tokenizer, None, bcfg, device="cpu")
        metas.append(meta)
    recs = {}
    for name, bi, out in outputs:
        recs.setdefault((name, bi), []).append(assemble_trajectories(out.cpu(), metas[bi]))
    return recs


def reference_pass(ctx, args, maps, seed, split):
    """The reference's nav and HA rollouts of the split's batches and its
    metric records."""
    from reference.device import use_fp32_numerics
    from reference.metrics.nav import assemble_trajectories, eval_metrics
    from reference.train.step import make_eval_rollout

    cell, device, flags = ctx.cell, ctx.device, ctx.flags
    family = cell.config["family"]
    use_fp32_numerics()
    bf16 = flags.get("bf16") is not False and device.type == "cuda"
    models = refmodels.build_models(flags, family, device, bf16=bf16)
    init_weights(models, seed, device)
    cfg = refmodels.train_config(flags, family, eval_mode=True, render_crop=args.render_crop)
    nav = make_eval_rollout(cfg, *models, teacher=False)
    ha = make_eval_rollout(cfg, *models, teacher=True, collect_ha=True)
    bank = refmodels.Bank(maps, flags["map_bank_px"], device)
    recs, nav_preds, ha_preds = {}, {}, {}
    for bi, (_, batch, meta) in enumerate(refmodels.batches(
            args.val_anno_dir, split, args.batch_size, seed, flags, device, bank.slot_of)):
        for name, fn, preds in (("nav", nav, nav_preds), ("ha", ha, ha_preds)):
            gen = torch.Generator(device).manual_seed(seed)
            r = assemble_trajectories(fn(bank.array, batch, gen).cpu(), meta)
            recs[(name, bi)] = r
            preds.update(r)
    metrics = {split: eval_metrics(nav_preds)[0],
               split + "_human_att": eval_metrics(ha_preds, human_att_eval=True)[0]}
    return recs, metrics


def _compare(got, want, got_metrics, want_metrics):
    out = {"corner_gap_m": 0.0, "action_gap": 0.0,
           "progress_gap": 0.0, "ha_gap": 0.0, "metric_gap": 0.0}
    for key, w in want.items():
        for g in got.get(key, [{}]):
            for k, v in compare.records(g, w).items():
                out[k] = max(out[k], v)
            if key[0] == "ha":
                out["ha_gap"] = max(out["ha_gap"], compare.ha_records(g, w))
    for res in got_metrics:
        for env, w in want_metrics.items():
            g = res.get(env, {})
            for k, v in w.items():
                gap = abs(float(g.get(k, math.nan)) - float(v))
                if not (gap == gap) and v == v:
                    gap = math.inf
                if gap == gap:
                    out["metric_gap"] = max(out["metric_gap"], gap)
    return out
