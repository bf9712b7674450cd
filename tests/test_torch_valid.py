"""The port's validation driver against the JAX package's, on the CPU at
tiny width (the fixture of ``tests/test_render_mode_goldens.py``).

* Batch order: the port's ``ANDHDataset`` yields the same ``instr_id``
  batches as the JAX one over two epochs (the wrap-around refill
  reshuffles), per-item and full-trajectory.
* ``load_reference_agent`` drops HF BERT's ``position_ids`` buffer and still
  rejects any other unknown key.
* The golden: a checkpoint trained once by the JAX package with the
  gate-checkpoint recipe of ``tests/test_render_mode_goldens.py`` (iters 8,
  lr 1e-3, exact render), exported with ``tools/export_torch_ckpt.py`` and
  validated by the port's CLI with that file's exact-mode validation flags
  (B = 2, T = 2, demb 64), reproduces ``tests/golden/eval_metrics_exact.json``:
  the same keys, every value within rtol = atol = 1e-3 (``PIN_TOL["exact"]``),
  and SR / oracle SR exactly equal.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from fixtures import write_fixture_dataset
from test_e2e_loop import TINY_DARKNET_CFG, make_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "eval_metrics_exact.json")
PIN_TOL = 1e-3  # tests/test_render_mode_goldens.py PIN_TOL["exact"]


def _ids(batch):
    return [it["map_name"] + "__" + it["route_index"] for it in batch]


@pytest.mark.parametrize("full_traj", [False, True], ids=["per_round", "full_traj"])
def test_batches_match_jax(tmp_path, full_traj):
    from avdn_tpu.data.annotations import ANDHDataset as JaxDataset
    from avdn_tpu_torch.data.annotations import ANDHDataset

    root = write_fixture_dataset(str(tmp_path))
    anno = os.path.join(root, "AVDN", "annotations")
    # batch 3 over 16 items: the last batch of each epoch is refilled
    jenv = JaxDataset(anno, ["val_seen"], 3, seed=5, full_traj=full_traj)
    penv = ANDHDataset(anno, ["val_seen"], 3, seed=5, full_traj=full_traj)
    assert penv.size() == jenv.size() > 0
    for _epoch in range(2):
        jb, pb = list(jenv), list(penv)
        assert [_ids(b) for b in pb] == [_ids(b) for b in jb]
        for pbatch, jbatch in zip(pb, jb):
            for p, j in zip(pbatch, jbatch):
                assert p["angle"] == j["angle"]
                assert p["instructions"] == j["instructions"]
                assert p["pre_dialogs"] == j["pre_dialogs"]
                np.testing.assert_array_equal(np.asarray(p["gt_path_corners"]),
                                              np.asarray(j["gt_path_corners"]))


def test_load_reference_agent_filters_only_position_ids(tmp_path):
    from avdn_tpu_torch.compat.from_jax import load_agent_weights, load_reference_agent
    from avdn_tpu_torch.config import Args, postprocess_args
    from avdn_tpu_torch.train.loop import build_models

    cfg_path = tmp_path / "tiny_yolo.cfg"
    cfg_path.write_text(TINY_DARKNET_CFG)
    args = postprocess_args(Args(output_dir=str(tmp_path / "out"), demb=64,
                                 encoder_heads=4, encoder_layers=1, bert_layers=2,
                                 darknet_model_file=str(cfg_path)))
    models = build_models(args, torch.device("cpu"))
    blob = {k: {"epoch": 1, "state_dict": m.state_dict()} for k, m in
            zip(("lang_model", "vision_model", "vln_model"), models)}
    blob["lang_model"]["state_dict"]["bert.embeddings.position_ids"] = \
        torch.arange(512)[None]
    path = str(tmp_path / "released.pt")
    torch.save(blob, path)
    loaded = load_reference_agent(path)
    assert "bert.embeddings.position_ids" not in loaded["lang_model"]
    load_agent_weights(build_models(args, torch.device("cpu")), loaded)

    for key, extra in (("lang_model", "bert.embeddings.token_type_ids"),
                       ("vln_model", "position_ids")):
        blob[key]["state_dict"][extra] = torch.zeros(1)
        torch.save(blob, path)
        with pytest.raises(RuntimeError, match="Unexpected key"):
            load_agent_weights(build_models(args, torch.device("cpu")),
                               load_reference_agent(path))
        del blob[key]["state_dict"][extra]


def _port_argv(args):
    """The port CLI's flags for a JAX ``make_args`` run."""
    flags = dict(root_dir=args.root_dir, output_dir=args.output_dir,
                 seed=args.seed, batch_size=args.batch_size,
                 max_action_len=args.max_action_len,
                 max_instr_len=args.max_instr_len, dialog_pad=args.dialog_pad,
                 demb=args.demb, encoder_heads=args.encoder_heads,
                 encoder_layers=args.encoder_layers, bert_layers=args.bert_layers,
                 nss_w=args.nss_w, darknet_model_file=args.darknet_model_file,
                 map_bank_px=args.map_bank_px, map_bank_slots=args.map_bank_slots,
                 inference=args.inference, render_twopass=args.render_twopass,
                 submit=args.submit)
    if args.resume_file:
        flags["resume_file"] = args.resume_file
    argv = []
    for k, v in flags.items():
        argv += ["--" + k, str(v)]
    return argv


def _metrics(log_dir):
    recs = [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]
    return {k: float(v) for r in recs for k, v in r.items()
            if k != "step" and isinstance(v, (int, float))
            and not k.startswith("throughput/")}


@pytest.fixture(scope="module")
def golden_run(tmp_path_factory):
    """Train the gate checkpoint in JAX, export it, validate it with the
    port's CLI on the CPU."""
    from avdn_tpu.data import native
    from avdn_tpu.train.loop import train
    from avdn_tpu_torch.cli.train_et import main as port_main

    root = write_fixture_dataset(str(tmp_path_factory.mktemp("andh_valid")))
    out = str(tmp_path_factory.mktemp("out_train"))
    cfg_path = os.path.join(out, "tiny_yolo.cfg")
    with open(cfg_path, "w") as f:
        f.write(TINY_DARKNET_CFG)
    targs = make_args(root, out, cfg_path, iters=8, log_every=1, seed=0,
                      lr=1e-3, render_twopass=False)
    # load the native resampler before the JAX bank's decode threads do: a
    # thread that races its first load falls back to OpenCV (±1 intensity),
    # trains another checkpoint and misses the golden (ROADMAP.md queue 3)
    native.available()
    train(targs)

    spec = importlib.util.spec_from_file_location(
        "export_torch_ckpt", os.path.join(REPO, "tools", "export_torch_ckpt.py"))
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    pt = os.path.join(out, "best_val_unseen.pt")
    export.main(_port_argv(targs) + [
        "--resume_file", os.path.join(targs.ckpt_dir, "best_val_unseen"),
        "--output", pt])

    run_dir = tmp_path_factory.mktemp("port_valid")
    vargs = make_args(root, str(run_dir / "out"), cfg_path, inference=True,
                      seed=0, render_twopass=False, resume_file=pt)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(run_dir)
        results, timers = port_main(_port_argv(vargs), device="cpu")
    return dict(args=vargs, results=results, timers=timers, root=root,
                cfg_path=cfg_path)


def test_valid_reproduces_exact_golden(golden_run):
    got = _metrics(golden_run["args"].log_dir)
    golden = json.load(open(GOLDEN))
    assert set(got) == set(golden), (sorted(set(got) - set(golden)),
                                     sorted(set(golden) - set(got)))
    for k in sorted(golden):
        if k.startswith(("sr/", "oracle_sr/")):
            assert got[k] == golden[k], k
        np.testing.assert_allclose(got[k], golden[k], rtol=PIN_TOL, atol=PIN_TOL,
                                   err_msg=k)


def test_valid_writes_its_records(golden_run):
    args = golden_run["args"]
    assert os.path.exists(os.path.join(args.log_dir, "valid.txt"))
    with open(os.path.join(args.output_dir, "logs", "validation_args.json")) as f:
        assert json.load(f)["resume_file"] == args.resume_file
    images = os.listdir(os.path.join(args.pred_dir, "debug_images"))
    # trajectory overlays for both splits, and per-step attention triples
    assert any(n.startswith("val_seenval") and "_att" not in n for n in images)
    assert any(n.startswith("val_unseenval") and "_att" not in n for n in images)
    for kind in ("_pred_att_0.jpg", "_gt_att_0.jpg", "_input_0.jpg"):
        assert any(n.endswith(kind) for n in images), kind
    assert set(golden_run["results"]) == {"val_seen", "val_unseen",
                                          "val_seen_human_att",
                                          "val_unseen_human_att"}
    assert {"nav_eval", "ha_eval", "map_load", "debug_images"} <= set(
        golden_run["timers"].totals)


def test_valid_submit_writes_eval_ai_file(golden_run, tmp_path, monkeypatch):
    """``--submit`` adds test_unseen and writes its predictions, the Eval.ai
    ``output_test_result.npy``, into the working directory (without
    ``--prefetch``); ``--profile_dir`` writes a Chrome trace of the first
    batch."""
    from avdn_tpu_torch.cli.train_et import main as port_main

    args = make_args(golden_run["root"], str(tmp_path / "out"),
                     golden_run["cfg_path"], inference=True, seed=0,
                     render_twopass=False, submit=True)
    monkeypatch.chdir(tmp_path)
    trace_dir = tmp_path / "trace"
    port_main(_port_argv(args) + ["--prefetch", "False", "--profile_dir",
                                  str(trace_dir)], device="cpu")
    assert json.load(open(trace_dir / "trace.json"))["traceEvents"]
    preds = np.load(tmp_path / "output_test_result.npy", allow_pickle=True).item()
    assert len(preds) == 16
    rec = next(iter(preds.values()))
    assert np.isfinite(np.asarray([c for c, _ in rec["path_corners"]])).all()
