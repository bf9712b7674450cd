"""Traffic kind ``serve``: the port's Navigator behind its HTTP front end
(``serve_http.make_server`` on 127.0.0.1, in this process), under an open
loop of single-item requests at the traffic file's fixed rate.

The schedule is drawn from ``--seed``: every seed gets the same set of
``rate × seconds`` exponential gaps (their quantiles), in its own order,
and its own items from the seeded pool. Each request is posted when it is
due by a client process of its own (``harness/client.py``, a pool of
threads, so that it takes no interpreter time from the server's
dispatcher); its latency runs from the time it was due
to the time its response was read, so a stall delays every request behind
it. A request that fails counts as a miss above every latency.
``serve_p95_ms`` is the 95th percentile over every request due in the
window.

After the window a seeded sample of the window's responses is compared
with the reference's rollouts of the same items (in batches of the serving
batch size, padded as the Navigator pads).
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import sys
import os
import subprocess
import threading
import time

import numpy as np
import torch

from harness import compare, data, program, refmodels
from harness.weights import init_weights

CLIENT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "client.py")


def schedule(seed: int, rate: float, seconds: float, n_pool: int, salt: int = 5):
    """``(due offsets in s, pool index)`` per request: the same gaps for
    every seed, in the seed's order."""
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng(data.sub_seed(seed, salt))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    rng.shuffle(gaps)
    return np.cumsum(gaps) - gaps[0], rng.integers(0, n_pool, n)


def offer(url, pool, dues, picks, tag):
    """The open loop of ``harness/client.py``, in a client process of its
    own (started, fed and waited for here): per request ``(due, sent,
    done, records or None)`` in seconds from the client's start."""
    job = json.dumps({"url": url, "pool": pool, "dues": [float(d) for d in dues],
                      "picks": [int(p) for p in picks], "tag": tag})
    timeout = (max(dues) if len(dues) else 0) + 600
    proc = subprocess.run([sys.executable, CLIENT], input=job, capture_output=True,
                          text=True, timeout=timeout)
    sys.stderr.write(proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"the serving client exited with {proc.returncode}")
    return [tuple(r) for r in json.loads(proc.stdout)]


def percentile(values, p):
    """tools/bench_serving_torch.py's percentile: the value at index
    ⌊p/100 · n⌋ of the sorted values."""
    v = sorted(values)
    return v[min(len(v) - 1, int(p / 100 * len(v)))]


def start(ctx):
    """The Navigator with the seed's weights behind a server on 127.0.0.1,
    warmed up: ``(nav, server, thread, url, pool, maps, args)``."""
    P = program.modules()
    cell, seed, device, tr = ctx.cell, ctx.seed, ctx.device, ctx.cell.traffic
    pool = data.make_items(seed, tr["n_items"], tr["n_maps"], tr["map_px"])
    maps = data.make_maps(seed, tr["n_maps"], tr["map_px"], device)
    # the annotations the Navigator sizes its two-pass crop from
    data.write_annotations(ctx.run_dir, {"val_seen": pool})
    args = P.parse_args(ctx.argv, family=cell.config["family"])
    nav = P.Navigator(args, serve_batch=tr["serve_batch"], device=device,
                      map_loader=lambda it: maps[it["map_name"]])
    init_weights((nav.bert, nav.darknet, nav.vln), seed, device)
    nav._rollout = ctx.wrap_step(nav._rollout)
    server = P.make_server(nav, host="127.0.0.1", port=0, max_wait_ms=tr["max_wait_ms"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_port}/navigate"
    # warm-up: one request alone, then a burst that coalesces
    offer(url, pool, [0.0], [0], "w0_")
    offer(url, pool, [0.0] * (2 * tr["serve_batch"]), list(range(2 * tr["serve_batch"])), "w")
    ctx.sync()
    return nav, server, thread, url, pool, maps, args


def stop(server, thread):
    server.shutdown()
    server.service.close()
    thread.join(timeout=30)
    server.server_close()


def run(ctx) -> dict:
    seed, tr = ctx.seed, ctx.cell.traffic
    nav, server, thread, url, pool, maps, args = start(ctx)
    service = server.service
    try:
        setup_s = time.perf_counter() - ctx.t_start

        dues, picks = schedule(seed, tr["rate_items_per_s"], ctx.seconds, len(pool))
        b0, d0 = service.batches_run, nav.timers.totals["dispatch"]
        res = offer(url, pool, dues, picks, "r")
        batches = service.batches_run - b0
        rec = ctx.record
        rec.update(batches=batches, items=len(res), units=len(res), unit_name="request",
                   window_s=max(r[2] for r in res),
                   dispatch_s=nav.timers.totals["dispatch"] - d0)
        if ctx.trace:
            t_dues, t_picks = schedule(seed, tr["rate_items_per_s"], tr["trace_seconds"],
                                       len(pool), salt=6)

            def traced_load(n=None):
                tb0 = service.batches_run
                offer(url, pool, t_dues[:n], t_picks[:n], "t")
                return service.batches_run - tb0

            rec["trace"] = ctx.traced(traced_load, lambda: traced_load(len(t_dues) // 2))
        rec["memory_peak_bytes"] = ctx.memory_peak()
    finally:
        stop(server, thread)

    lat = [(done - due) * 1e3 if recs is not None else math.inf
           for due, sent, done, recs in res]
    failed = sum(r[3] is None for r in res)
    late = max(sent - due for due, sent, done, recs in res)
    finite = [x for x in lat if math.isfinite(x)]
    print(f"[serve] {len(res)} requests at {tr['rate_items_per_s']} items/s over "
          f"{ctx.seconds} s, {failed} failed, {batches} batches "
          f"({len(res) / max(batches, 1):.2f} items a batch); latency from the due time "
          f"p50 {percentile(lat, 50):.1f} p95 {percentile(lat, 95):.1f} p99 "
          f"{percentile(lat, 99):.1f} max {max(lat):.1f} ms; generator at most "
          f"{late * 1e3:.1f} ms late; mean {statistics.mean(finite) if finite else 0:.1f} ms",
          file=sys.stderr)
    metrics = {"serve_p95_ms": percentile(lat, 95), "setup_s": setup_s}

    # a seeded sample of the window's answers, against the reference
    rng = np.random.default_rng(data.sub_seed(seed, 7))
    done = [i for i, r in enumerate(res) if r[3] is not None]
    sample = sorted(rng.choice(done, size=min(tr["sample_requests"], len(done)),
                               replace=False).tolist()) if done else []
    got = {res[i][3][0]["instr_id"]: res[i][3][0] for i in sample}
    asked = [dict(pool[picks[i]], route_index=f"r{i}_1") for i in sample]
    crop = args.render_crop
    del nav, server, service
    gc.collect()
    ctx.free()
    want = reference_answers(ctx, asked, maps, seed, tr["serve_batch"], crop)
    compared = compare.records(got, want)
    if failed == len(res):
        compared["corner_gap_m"] = math.inf
    return dict(metrics=metrics, compared=compared, attempted=len(res), failed=failed)


def reference_answers(ctx, asked, maps, seed, serve_batch, crop):
    """The reference's serving rollout of ``asked`` (raw items), in batches
    of ``serve_batch`` padded with copies of their first item."""
    from reference.data.batcher import make_train_batch
    from reference.data.serve_items import normalize_item
    from reference.data.tokenizer import WordPieceTokenizer
    from reference.device import use_fp32_numerics
    from reference.metrics.nav import assemble_trajectories
    from reference.sim.warp2pass import auto_render_crop
    from reference.train.step import make_eval_rollout

    cell, device, flags = ctx.cell, ctx.device, ctx.flags
    family = cell.config["family"]
    use_fp32_numerics()
    bf16 = flags.get("bf16") is not False and device.type == "cuda"
    models = refmodels.build_models(flags, family, device, bf16=bf16)
    init_weights(models, seed, device)
    twopass = flags.get("render_twopass") is not False
    ref_crop = auto_render_crop(min(it["lat_ratio"] for it in asked)) if twopass else 512
    if twopass and ref_crop != crop:
        print(f"[serve] the reference's two-pass crop {ref_crop} px, the port's {crop}",
              file=sys.stderr)
    cfg = refmodels.train_config(flags, family, eval_mode=True, render_crop=ref_crop)
    fn = make_eval_rollout(cfg, *models, teacher=False, compute_losses=False)
    bank = refmodels.Bank(maps, flags["map_bank_px"], device)
    tok = WordPieceTokenizer.fallback()
    bcfg = refmodels.batcher_config(flags)
    gen = torch.Generator(device).manual_seed(seed)
    items = [normalize_item(it) for it in asked]
    out = {}
    for lo in range(0, len(items), serve_batch):
        chunk = items[lo:lo + serve_batch]
        chunk = chunk + [dict(chunk[0], _pad=True)] * (serve_batch - len(chunk))
        batch, meta = make_train_batch(chunk, tok, bank.slot_of, bcfg, device=device)
        out.update(assemble_trajectories(fn(bank.array, batch, gen).cpu(), meta))
    return out
