"""Reproduce the reference's released-checkpoint validation (BASELINE.md)
with the PyTorch port (the counterpart of ``tools/repro_valid.py``).

Asset-gated: the xView GeoTIFFs, the released ``best_val_unseen`` torch
checkpoint, ``yolo_v3.cfg`` and ``vocab.txt`` ship with the dataset, not the
repo. When any are absent this exits 0 with a clear message naming them;
when all are present it runs the EXACT configuration of the reference's
shipped inference log (the reference's datasets/XVIEW/et_haa_test/logs/
validation_args.json: student-forced, max_action_len=5, max_instr_len=100 —
src/scripts/avdn_paper/run_et_haa.sh:40-43) through the port's ``valid()``
at the reference numerics (the exact render, fp32 towers, TF32 off) on the
card, and diffs every metric against the BASELINE.md table. The released
``best_val_unseen`` is read in the reference's layout: its state dicts are
loaded (the reference's dead ET modules skipped) and its torch optimizer
state, which inference does not restore, is left unread.

Usage:
    python tools/repro_valid_torch.py --root_dir ./datasets \
        [--resume_file .../best_val_unseen] [--tolerance 0.5]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# BASELINE.md table (source: reference valid.txt:4,11)
EXPECTED = {
    "val_seen": {"sr": 15.14, "oracle_sr": 22.97, "spl": 13.68,
                 "gp": 57.46, "oracle_gp": 69.82, "iou": 0.20,
                 "lengths": 120.27, "gt_length": 154.19},
    "val_unseen": {"sr": 19.46, "oracle_sr": 28.47, "spl": 16.36,
                   "gp": 57.46, "oracle_gp": 69.66, "iou": 0.22,
                   "lengths": 118.99, "gt_length": 150.99},
}


def find_assets(root: str, resume_file: str | None):
    avdn = os.path.join(root, "AVDN")
    need = {
        "annotations (val_seen)": os.path.join(
            avdn, "annotations", "val_seen_data.json"),
        "annotations (val_unseen)": os.path.join(
            avdn, "annotations", "val_unseen_data.json"),
        "xView GeoTIFF tiles": os.path.join(avdn, "train_images"),
        "yolo_v3.cfg": os.path.join(avdn, "pretrain_weights", "yolo_v3.cfg"),
        "bert vocab.txt": os.path.join(avdn, "pretrain_weights", "vocab.txt"),
    }
    ckpt = resume_file or os.path.join(avdn, "pretrain_weights",
                                       "best_val_unseen")
    need["released best_val_unseen checkpoint"] = ckpt
    missing = {k: p for k, p in need.items() if not os.path.exists(p)}
    # the tif directory must actually contain tiles
    tifdir = need["xView GeoTIFF tiles"]
    if os.path.isdir(tifdir) and not any(
            f.endswith(".tif") for f in os.listdir(tifdir)):
        missing["xView GeoTIFF tiles"] = tifdir
    return need, missing, ckpt


def main(argv=None, device=None):
    """Returns the exit code: 0 when every metric is within tolerance or an
    asset is missing (SKIPPED), 1 otherwise. ``device`` is the card unless
    the caller asks for the CPU."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root_dir", default="./datasets")
    ap.add_argument("--resume_file", default=None)
    ap.add_argument("--output_dir", default="./out/repro_valid")
    ap.add_argument("--tolerance", type=float, default=0.5,
                    help="absolute tolerance on %%-scale metrics (SR/SPL); "
                         "metre-scale metrics allow 2x this in metres")
    ap.add_argument("--batch_size", type=int, default=16,
                    help="eval batch (metrics are batch-invariant, "
                         "PARITY.md #8)")
    # model-shape overrides, defaulting to the reference configuration
    # (validation_args.json). Used by the dress rehearsal
    # (tests/test_torch_entry.py) to drive the FULL asset-day path with
    # CI-sized models on synthetic release-layout assets.
    ap.add_argument("--demb", type=int, default=768)
    ap.add_argument("--bert_layers", type=int, default=12)
    ap.add_argument("--encoder_heads", type=int, default=12)
    ap.add_argument("--encoder_layers", type=int, default=2)
    ap.add_argument("--max_instr_len", type=int, default=100)
    ap.add_argument("--dialog_pad", type=int, default=320)
    ap.add_argument("--map_bank_px", type=int, default=4096)
    ap.add_argument("--map_bank_slots", type=int, default=8)
    ap.add_argument("--max_action_len", type=int, default=5)
    ns = ap.parse_args(argv)

    need, missing, ckpt = find_assets(ns.root_dir, ns.resume_file)
    if missing:
        print("repro_valid: SKIPPED — missing released assets:")
        for k, p in sorted(missing.items()):
            print(f"  - {k}: expected at {p}")
        print("Place the AVDN dataset release under "
              f"{os.path.join(ns.root_dir, 'AVDN')} and re-run.")
        return 0

    sys.path.insert(0, ROOT)
    from avdn_tpu_torch.config import Args, postprocess_args
    from avdn_tpu_torch.train.loop import valid

    args = postprocess_args(Args(
        root_dir=ns.root_dir,
        output_dir=ns.output_dir,
        inference=True,
        resume_file=ckpt,
        batch_size=ns.batch_size,
        max_action_len=ns.max_action_len,
        max_instr_len=ns.max_instr_len,
        dialog_pad=ns.dialog_pad,
        demb=ns.demb,
        bert_layers=ns.bert_layers,
        encoder_heads=ns.encoder_heads,
        encoder_layers=ns.encoder_layers,
        map_bank_px=ns.map_bank_px,
        map_bank_slots=ns.map_bank_slots,
        feedback="student",
        darknet_model_file=need["yolo_v3.cfg"],
        bert_vocab_file=need["bert vocab.txt"],
        # strict parity: the exact render + fp32 towers (valid() turns TF32
        # off) — the point of this tool is reproducing the reference log
        # bit-for-bit-close, not speed (the shipped eval defaults are the
        # two-pass warp + bf16 towers — PARITY.md)
        render_twopass=False,
        bf16=False,
    ))
    valid(args, device=device)

    recs = [json.loads(l) for l in
            open(os.path.join(args.log_dir, "metrics.jsonl"))]
    got = {}
    for r in recs:
        for k, v in r.items():
            if k == "step" or not isinstance(v, (int, float)):
                continue
            metric, _, env = k.partition("/")
            got.setdefault(env, {})[metric] = v

    failures = []
    print(f"{'env':<11} {'metric':<10} {'reference':>10} {'ours':>10}")
    for env, exp in EXPECTED.items():
        for m, ref in exp.items():
            val = got.get(env, {}).get(m)
            tol = ns.tolerance if m in ("sr", "oracle_sr", "spl", "iou") \
                else 2 * ns.tolerance
            ok = val is not None and abs(val - ref) <= tol
            print(f"{env:<11} {m:<10} {ref:>10.2f} "
                  f"{(val if val is not None else float('nan')):>10.2f}"
                  f"  {'ok' if ok else 'DIFF'}")
            if not ok:
                failures.append((env, m, ref, val))
    if failures:
        print(f"\nrepro_valid: {len(failures)} metric(s) outside tolerance")
        return 1
    print("\nrepro_valid: all metrics within tolerance of BASELINE.md")
    return 0


if __name__ == "__main__":
    sys.exit(main())
