"""End-to-end serving benchmark of the PyTorch port: N concurrent HTTP
clients → ``avdn_tpu_torch.serve_http`` → the coalescing dispatcher → the
port's ``Navigator`` (map bank, tokenisation, batch build and upload,
rollout on the card) → JSON responses.

Reports sustained episodes per second and request latency percentiles after
a warm-up request (which builds the kernels), and the Navigator's wall by
phase over the measured window (``serve.py``'s ``timers``). The data are
generated from a seed (``chip_smoke.make_maps`` / ``make_items``: 4 maps of
2048 px, 24 items), the weights are random from ``--seed``.

    python tools/bench_serving_torch.py                  # full width, the card
    python tools/bench_serving_torch.py --tiny --device cpu
    python tools/bench_serving_torch.py --render_twopass False --bf16 False

Other flags go to the port's ``config.parse_args`` (unset: the Navigator's
shipped defaults, bf16 towers and the two-pass render). Prints one JSON line:
``{"serving_e2e_eps", "p50_ms", "p90_ms", "p99_ms", "max_ms", "requests",
"batches_run", "nav_phase_s", ...}``; the percentiles are over ``requests``
latencies (the defaults, 8 clients × 32 requests, give 256: p99 is the
3rd-largest). It is a tool, not a benchmark cell.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_CFG = """
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

TINY_FLAGS = ["--demb", "64", "--encoder_heads", "4", "--encoder_layers", "1",
              "--bert_layers", "2", "--max_instr_len", "32", "--dialog_pad", "64",
              "--map_bank_px", "2048", "--map_bank_slots", "4"]


def _post(url, obj, timeout=1200):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def bench(nav, pool, clients=8, requests_per_client=32, items_per_request=2,
          max_wait_ms=5.0) -> dict:
    """Serve ``pool``'s items to ``clients`` concurrent clients through a
    server over ``nav`` on 127.0.0.1 (a free port); each client posts
    ``requests_per_client`` requests of ``items_per_request`` items. The
    server is shut down before it returns."""
    from avdn_tpu_torch.serve_http import make_server
    from avdn_tpu_torch.utils.logging import PhaseTimer

    server = make_server(nav, host="127.0.0.1", port=0, max_wait_ms=max_wait_ms)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_port}"
    try:
        _post(base + "/navigate", {"items": pool[:items_per_request]})  # warm-up
        nav.timers = PhaseTimer()  # the measured window only
        before = server.service.batches_run
        latencies, done, errors = [], [], []
        lock = threading.Lock()

        def client(ci):
            try:
                for r in range(requests_per_client):
                    items = [dict(pool[(ci + r + k) % len(pool)],
                                  route_index=f"c{ci}r{r}k{k}_1")
                             for k in range(items_per_request)]
                    t0 = time.perf_counter()
                    out = _post(base + "/navigate", {"items": items})
                    dt = time.perf_counter() - t0
                    if len(out["predictions"]) != len(items):
                        raise RuntimeError("a reply lost items")
                    with lock:
                        latencies.append(dt)
                        done.append(len(items))
            except Exception as e:  # reported below, after the join
                with lock:
                    errors.append(repr(e))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        batches = server.service.batches_run - before
    finally:
        server.shutdown()
        server.service.close()
        thread.join(timeout=30)
    if errors:
        raise RuntimeError(f"{len(errors)} clients failed: {errors[0]}")
    lat_ms = sorted(1e3 * x for x in latencies)

    def pct(p):
        return lat_ms[min(len(lat_ms) - 1, int(p / 100 * len(lat_ms)))]

    return {
        "serving_e2e_eps": sum(done) / wall,
        "p50_ms": pct(50),
        "p90_ms": pct(90),
        "p99_ms": pct(99),
        "max_ms": lat_ms[-1],
        "episodes": sum(done),
        "requests": len(latencies),
        "wall_s": wall,
        "batches_run": batches,
        "clients": clients,
        "items_per_request": items_per_request,
        "serve_batch": nav.serve_batch,
        "T": nav.cfg.max_action_len,
        "device": str(nav.device),
        "nav_phase_s": dict(nav.timers.totals),
        "nav_phase_counts": dict(nav.timers.counts),
        "nav_phase_profile": nav.timers.summary(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, add_help=True)
    ap.add_argument("--tiny", action="store_true",
                    help="CI-sized models (demb 64, the tiny Darknet)")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--serve_batch", type=int, default=8)
    ap.add_argument("--max_action_len", type=int, default=10)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests_per_client", type=int, default=32)
    ap.add_argument("--items_per_request", type=int, default=2)
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ns, rest = ap.parse_known_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke
    from avdn_tpu_torch.config import parse_args
    from avdn_tpu_torch.serve import Navigator

    flags = ["--output_dir", tempfile.mkdtemp(prefix="avdn_serve_bench_"),
             "--batch_size", str(ns.serve_batch),
             "--max_action_len", str(ns.max_action_len)]
    if ns.tiny:
        cfg_path = os.path.join(flags[1], "tiny.cfg")
        with open(cfg_path, "w") as f:
            f.write(TINY_CFG)
        flags += TINY_FLAGS + ["--darknet_model_file", cfg_path]
    maps = chip_smoke.make_maps("cpu")
    by_name = {f"smoke_map_{k}": m for k, m in enumerate(maps)}
    nav = Navigator(parse_args(flags + rest), serve_batch=ns.serve_batch,
                    device=ns.device, map_loader=lambda it: by_name[it["map_name"]])
    out = bench(nav, chip_smoke.make_items(), ns.clients, ns.requests_per_client,
                ns.items_per_request, ns.max_wait_ms)
    out["config"] = "tiny" if ns.tiny else "full width"
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
