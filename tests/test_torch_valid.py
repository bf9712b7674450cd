"""The port's validation driver against the JAX package's, on the CPU at
tiny width (the fixture of ``tests/test_render_mode_goldens.py``).

* Batch order: the port's ``ANDHDataset`` yields the same ``instr_id``
  batches as the JAX one over two epochs (the wrap-around refill
  reshuffles), per-item and full-trajectory.
* ``load_reference_agent`` drops HF BERT's ``position_ids`` buffer and still
  rejects any other unknown key.
* The golden: a checkpoint trained once by the JAX package with the
  gate-checkpoint recipe of ``tests/test_render_mode_goldens.py`` (iters 8,
  lr 1e-3, exact render), exported with ``tools/export_torch_ckpt.py``
  (made once per session and shared with the eval-mode files,
  ``tests/torch_shared.py``) and validated by the port's CLI with that
  file's exact-mode validation flags (B = 2, T = 2, demb 64), reproduces
  ``tests/golden/eval_metrics_exact.json``: the same keys, every value
  within rtol = atol = 1e-3 (``PIN_TOL["exact"]``), and SR / oracle SR
  exactly equal.
"""

import json
import os

import numpy as np
import pytest
import torch

from fixtures import write_fixture_dataset
from test_e2e_loop import TINY_DARKNET_CFG, make_args
from torch_shared import REPO, gate_checkpoint, port_mode_run
from torch_shared import metrics_of as _metrics

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


@pytest.fixture(scope="module")
def golden_run(tmp_path_factory):
    """The gate checkpoint (trained in JAX and exported), validated with the
    port's CLI on the CPU: the exact-mode run that the eval-mode files
    share (``tests/torch_shared.py``)."""
    gate = gate_checkpoint(tmp_path_factory)
    run = port_mode_run(tmp_path_factory, "exact")
    vargs = make_args(gate["root"], run["output_dir"], gate["cfg_path"],
                      inference=True, seed=0, render_twopass=False,
                      resume_file=gate["pt"], submit=True)
    return dict(args=vargs, results=run["results"], timer_phases=run["timer_phases"],
                run_dir=run["run_dir"])


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
        golden_run["timer_phases"])


def test_valid_submit_writes_eval_ai_file(golden_run):
    """``--submit`` adds test_unseen and writes its predictions, the Eval.ai
    ``output_test_result.npy``, into the working directory (without
    ``--prefetch``); ``--profile_dir`` writes a Chrome trace of the first
    batch, the program's spans merged in over its ops (the oracle's among
    them). (The shared exact run is that run, ``tests/torch_shared.py``.)"""
    run_dir = golden_run["run_dir"]
    events = json.load(open(os.path.join(run_dir, "trace", "trace.json")))["traceEvents"]
    assert events
    oracle = [e for e in events if e.get("name") == "sim.oracle" and e.get("ph") == "X"]
    assert oracle and all(e["cat"] == "span" and e["dur"] > 0 for e in oracle)
    preds = np.load(os.path.join(run_dir, "output_test_result.npy"),
                    allow_pickle=True).item()
    assert len(preds) == 16
    rec = next(iter(preds.values()))
    assert np.isfinite(np.asarray([c for c, _ in rec["path_corners"]])).all()
