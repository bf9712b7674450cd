"""Cells at tiny width for the CPU tests: every traffic kind of the
benchmark's, on a 2-layer BERT of width 64, a two-conv Darknet, a one-layer
trunk (or the LSTM at width 64), over 2048 px maps."""

from __future__ import annotations

import json
import os
import time

from harness.cell import BENCH_DIR, Cell
from harness.runner import Context

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

TINY_ARGS = {"demb": 64, "bert_layers": 2, "encoder_heads": 4, "encoder_layers": 1,
             "dropout_transformer_encoder": 0.1, "dropout_emb": 0.0, "max_instr_len": 32,
             "dialog_pad": 64, "map_bank_px": 2048, "map_bank_slots": 4}
TINY_TRAFFIC = {"n_items": 8, "n_maps": 2, "map_px": 2048}


def tiny_cell(config: str, traffic: str, tmp_path, limits=None) -> Cell:
    """The shipped configuration ``config`` and traffic ``traffic`` with
    tiny widths and sizes (every other key as shipped); the tiny Darknet cfg
    is written under ``tmp_path``."""
    with open(os.path.join(BENCH_DIR, "configs", config + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic", traffic + ".json")) as f:
        tr = json.load(f)
    os.makedirs(str(tmp_path), exist_ok=True)
    darknet_cfg = os.path.join(str(tmp_path), "darknet.cfg")
    with open(darknet_cfg, "w") as f:
        f.write(TINY_DARKNET_CFG)
    cfg["args"] = {**cfg["args"], **TINY_ARGS, "batch_size": 2, "max_action_len": 3,
                   "darknet_model_file": darknet_cfg}
    tr.update(TINY_TRAFFIC)
    tr["args"] = {k: v for k, v in tr["args"].items()
                  if k not in ("batch_size", "max_action_len")}
    if tr["kind"] == "valid":
        tr["args"]["batch_size"] = 4
    if tr["kind"] == "serve":
        tr.update(serve_batch=2, rate_items_per_s=8.0, sample_requests=4)
    if limits is None:  # the cell's limits, or those of the traffic's shipped cell
        path = os.path.join(BENCH_DIR, "limits", f"{config}.{traffic}.json")
        if not os.path.exists(path):
            path = os.path.join(BENCH_DIR, "limits", f"et_haa.{traffic}.json")
        with open(path) as f:
            limits = json.load(f)
    return Cell(name=f"{config}.{traffic}", config=cfg, traffic=tr, limits=limits,
                end_to_end=[], per_layer=[])


def tiny_context(cell: Cell, tmp_path, seed: int = 3, seconds: float = 0.5,
                 device: str = "cpu") -> Context:
    return Context(cell, seed, seconds, False, device, time.perf_counter(),
                   run_dir=str(tmp_path / "run"))
