"""The port's Navigator against the JAX package's, on the CPU, on the demo
dataset: one exported reference-format ``.pt`` (the JAX tiny model, BN
statistics randomised) loaded by both, ``--render_twopass False --bf16
False``, the first 7 ``val_seen`` items at ``serve_batch=2`` (the last chunk
padded).

Tolerances: the same prediction keys and step counts; ``path_corners`` and
``actions`` within 1e-4 relative; ``eval_metrics`` SR and oracle SR equal,
SPL and GP within 1e-4.

``--resume_file latest`` serves the newest checkpoint that the port's own
``train()`` wrote (one interval at B = 8, T = 2), weight for weight, and
raises ``FileNotFoundError`` naming the checkpoint directory when there is
none (as the JAX ``Navigator`` does).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from fixtures import write_fixture_dataset
from test_e2e_loop import TINY_DARKNET_CFG, make_args
from test_torch_rollout import jax_models, port_args

N_ITEMS = 7


@pytest.fixture(scope="module")
def preds(tmp_path_factory):
    import avdn_tpu.train.loop as jax_loop
    from avdn_tpu.compat.torch_export import export_reference_agent
    from avdn_tpu.metrics import eval_metrics as jax_eval_metrics
    from avdn_tpu.serve import Navigator as JaxNavigator
    from avdn_tpu_torch.metrics.nav import eval_metrics
    from avdn_tpu_torch.serve import Navigator

    root = write_fixture_dataset(str(tmp_path_factory.mktemp("torch_serve")))
    out = str(tmp_path_factory.mktemp("out"))
    cfg_path = os.path.join(out, "tiny_yolo.cfg")
    with open(cfg_path, "w") as f:
        f.write(TINY_DARKNET_CFG)
    args = make_args(root, out, cfg_path, render_twopass=False, bf16=False,
                     max_action_len=5)
    _, (bert, dk, vln), state = jax_models(args, seed=7)
    ckpt = os.path.join(out, "agent.pt")
    export_reference_agent(
        ckpt, "et", dk.cfg.block_dicts(), {"params": state.bert_params},
        {"params": state.darknet_params, "batch_stats": state.batch_stats},
        {"params": state.vln_params}, bert_layers=args.bert_layers,
        et_layers=args.encoder_layers)
    args.resume_file = ckpt
    pargs = port_args(args)
    items = json.load(open(os.path.join(root, "AVDN", "annotations",
                                        "val_seen_data.json")))[:N_ITEMS]
    init = jax_loop.init_state
    # load the JAX package's native resampler before its bank's decode
    # threads do: a thread that races its first load falls back to OpenCV
    # (±1 intensity) and JAX serves other views (ROADMAP.md queue 3)
    from avdn_tpu.data import native

    assert native.available()
    with pytest.MonkeyPatch.context() as mp:
        # the eager JAX init compiles op by op; its weights are replaced by
        # the checkpoint anyway
        mp.setattr(jax_loop, "init_state", lambda *a: jax.jit(
            lambda key: init(*a[:-1], key))(a[-1]))
        want = JaxNavigator(args, serve_batch=2).navigate(items)
    got = Navigator(pargs, serve_batch=2, device="cpu").navigate(items)
    return got, want, eval_metrics(got)[0], jax_eval_metrics(want)[0]


def test_same_predictions(preds):
    got, want, _, _ = preds
    assert len(want) == N_ITEMS
    assert sorted(got) == sorted(want)
    moved = 0
    for k in want:
        g, w = got[k], want[k]
        assert len(g["path_corners"]) == len(w["path_corners"]), k
        assert len(g["actions"]) == len(w["actions"]), k
        for (gc, gd), (wc, wd) in zip(g["path_corners"], w["path_corners"]):
            np.testing.assert_allclose(gc, wc, rtol=1e-4, atol=1e-9)
            np.testing.assert_allclose(gd, wd, rtol=1e-4, atol=1e-4)
        for (gwp, galt), (wwp, walt) in zip(g["actions"], w["actions"]):
            np.testing.assert_allclose(gwp, wwp, rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(galt, walt, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(g["progress"], w["progress"], rtol=1e-4, atol=1e-6)
        moved += len(w["path_corners"]) > 1
    assert moved > 0


def test_same_eval_metrics(preds):
    _, _, got, want = preds
    assert got["sr"] == want["sr"]
    assert got["oracle_sr"] == want["oracle_sr"]
    np.testing.assert_allclose(got["spl"], want["spl"], atol=1e-4)
    np.testing.assert_allclose(got["gp"], want["gp"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["oracle_gp"], want["oracle_gp"], rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def port_trained(tmp_path_factory):
    """One interval of the port's own ``train()`` (B = 8, T = 2, demb 64,
    the exact render) on the shared fixture dataset: its flags and state."""
    from avdn_tpu_torch.cli.train_et import main
    from torch_shared import fixture_dataset, port_argv

    root, cfg_path = fixture_dataset(tmp_path_factory)
    out = str(tmp_path_factory.mktemp("serve_latest") / "out")
    args = make_args(root, out, cfg_path, render_twopass=False, batch_size=8)
    argv = port_argv(args) + ["--iters", "1", "--log_every", "1", "--lr", "1e-3"]
    state, _ = main(argv, device="cpu")
    return argv, state


def test_navigator_serves_latest_training_checkpoint(port_trained):
    """``--resume_file latest`` resolves to the newest ``latest_dict_*.pt``
    that ``train()`` wrote, and the Navigator serves those weights."""
    from avdn_tpu_torch.config import parse_args
    from avdn_tpu_torch.serve import Navigator

    argv, state = port_trained
    args = parse_args(argv + ["--resume_file", "latest"])
    nav = Navigator(args, serve_batch=2, device="cpu")
    assert os.path.basename(args.resume_file) == f"latest_dict_{state.step}.pt"
    for model, trained in zip((nav.bert, nav.darknet, nav.vln), state.models()):
        want = trained.state_dict()
        for name, value in model.state_dict().items():
            assert torch.equal(value, want[name]), name
    items = json.load(open(os.path.join(args.val_anno_dir, "val_seen_data.json")))[:3]
    preds = nav.navigate(items)
    assert len(preds) == 3
    assert all(len(p["path_corners"]) >= 1 for p in preds.values())


def test_navigator_latest_without_checkpoint_raises(port_trained, tmp_path):
    from avdn_tpu_torch.config import parse_args
    from avdn_tpu_torch.serve import Navigator

    argv, _ = port_trained
    args = parse_args(argv + ["--resume_file", "latest", "--output_dir",
                              str(tmp_path / "fresh")])
    with pytest.raises(FileNotFoundError, match="no latest_dict_") as err:
        Navigator(args, serve_batch=2, device="cpu")
    assert args.ckpt_dir.startswith(str(tmp_path)) and args.ckpt_dir in str(err.value)
