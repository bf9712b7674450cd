"""The port's eval rollouts against the JAX package's, step by step, on the
CPU at tiny width (BERT 2×64, the tiny Darknet, trunk 1 layer, T = 5, B = 4).

Both sides get the same weights (the JAX ``init_state`` carried across by
``avdn_tpu_torch.compat.from_jax``, with randomised BatchNorm statistics so
the BN fold is exercised) and batches built by each side's
``make_train_batch`` from the same demo-dataset items, in three modes:
student with losses (the nav eval), student without losses (serving) and the
teacher-forced HA eval with ``fused_teacher=False``. Each package decodes
the maps by its own default path (the JAX package's native resampler, the
port's copy of it), and the two banks must be byte-equal.

Tolerances: stop flags identical; actions, progress and corners within 1e-4
relative; HA precision, recall and NSS within 1e-4; the summed loss within
1e-4 relative (the two sides draw the loss's 1e-5 heading jitter from
different generators).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from fixtures import write_fixture_dataset
from test_e2e_loop import TINY_DARKNET_CFG, make_args

T_STEPS = 5
N_ITEMS = 4


def port_args(jax_args):
    from avdn_tpu_torch.config import Args

    return Args(**dataclasses.asdict(jax_args))


def jax_models(args, seed=0):
    """JAX models + TrainState at fp32, BN statistics randomised."""
    from avdn_tpu.train.loop import build_models, eval_config_from_args, init_state

    cfg = eval_config_from_args(args)
    bert, dk, vln = build_models(args, bf16=False)
    # jitted: the eager init dispatches (and compiles) op by op
    state = jax.jit(lambda key: init_state(args, bert, dk, vln, cfg, key))(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    stats = jax.tree_util.tree_map(lambda x: np.asarray(x), state.batch_stats)
    for name, s in stats.items():
        s["mean"] = rng.normal(0, 0.1, s["mean"].shape).astype(np.float32)
        s["var"] = rng.uniform(0.5, 1.5, s["var"].shape).astype(np.float32)
    state = state.replace(batch_stats=stats)
    return cfg, (bert, dk, vln), state


def port_weights(state, dk_model, args):
    """The JAX state as the port's ``{lang_model, vision_model, vln_model}``
    state dicts."""
    from avdn_tpu_torch.compat import from_jax

    return {
        "lang_model": from_jax.bert_state_dict(
            {"params": state.bert_params}, args.bert_layers),
        "vision_model": from_jax.darknet_state_dict(
            {"params": state.darknet_params, "batch_stats": state.batch_stats},
            dk_model.cfg.block_dicts()),
        "vln_model": from_jax.et_state_dict(
            {"params": state.vln_params}, args.encoder_layers),
    }


def port_models(pargs, weights):
    from avdn_tpu_torch.compat.from_jax import load_agent_weights
    from avdn_tpu_torch.train.loop import build_models

    models = build_models(pargs, torch.device("cpu"))
    load_agent_weights(models, weights)
    return models


def both_batches(args, pargs, items):
    """The same items through each package's bank + batcher."""
    from avdn_tpu.data.batcher import make_train_batch as jax_batch
    from avdn_tpu.data.maps import DeviceMapBank as JaxBank
    from avdn_tpu.data.tokenizer import WordPieceTokenizer as JaxTok
    from avdn_tpu.train.loop import batcher_config as jax_bcfg
    from avdn_tpu_torch.data.batcher import make_train_batch
    from avdn_tpu_torch.data.maps import DeviceMapBank
    from avdn_tpu_torch.data.tokenizer import WordPieceTokenizer
    from avdn_tpu_torch.train.loop import batcher_config

    hw = (args.map_bank_px, args.map_bank_px)
    jbank = JaxBank(args.val_dataset_dir, hw, n_slots=args.map_bank_slots)
    jarr, jslots = jbank.prepare(items)
    jb, jmeta = jax_batch(items, JaxTok.load(None), jslots, jax_bcfg(args))
    pbank = DeviceMapBank(pargs.val_dataset_dir, hw, n_slots=pargs.map_bank_slots,
                          device="cpu")
    parr, pslots = pbank.prepare(items)
    pb, pmeta = make_train_batch(items, WordPieceTokenizer.load(None), pslots,
                                 batcher_config(pargs))
    return (jarr, jb, jmeta), (parr, pb, pmeta)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from avdn_tpu.serve import Navigator as JaxNavigator

    root = write_fixture_dataset(str(tmp_path_factory.mktemp("torch_roll")))
    out = str(tmp_path_factory.mktemp("out"))
    cfg_path = os.path.join(out, "tiny_yolo.cfg")
    with open(cfg_path, "w") as f:
        f.write(TINY_DARKNET_CFG)
    args = make_args(root, out, cfg_path, render_twopass=False, bf16=False,
                     fused_teacher=False, max_action_len=T_STEPS)
    pargs = port_args(args)
    cfg, models, state = jax_models(args)
    pmodels = port_models(pargs, port_weights(state, models[1], args))
    raw = json.load(open(os.path.join(root, "AVDN", "annotations",
                                      "val_seen_data.json")))
    items = [JaxNavigator._normalize_item(it) for it in raw[:N_ITEMS]]
    jside, pside = both_batches(args, pargs, items)
    return dict(args=args, pargs=pargs, cfg=cfg, models=models, state=state,
                pmodels=pmodels, jside=jside, pside=pside)


def run_both(setup, teacher, collect_ha, compute_losses):
    from avdn_tpu.train.step import make_eval_rollout as jax_rollout
    from avdn_tpu_torch.train.loop import eval_config_from_args
    from avdn_tpu_torch.train.step import make_eval_rollout

    kw = dict(teacher=teacher, collect_ha=collect_ha, compute_losses=compute_losses)
    jfn = jax.jit(jax_rollout(setup["cfg"], *setup["models"], **kw))
    jarr, jb, _ = setup["jside"]
    jout = jax.device_get(jfn(setup["state"], jarr, jb, jax.random.PRNGKey(1)))
    pfn = make_eval_rollout(eval_config_from_args(setup["pargs"]),
                            *setup["pmodels"], **kw)
    parr, pb, _ = setup["pside"]
    pout = pfn(parr, pb, torch.Generator().manual_seed(1))
    return jout, pout


def assert_rollouts_match(jout, pout, ha=False, losses=True):
    def j(name):
        return np.asarray(getattr(jout, name))

    def p(name):
        return getattr(pout, name).numpy()

    np.testing.assert_array_equal(p("alive_pre"), j("alive_pre"))
    np.testing.assert_array_equal(p("alive_post"), j("alive_post"))
    for name in ("actions_wp", "actions_alt", "pred_progress"):
        np.testing.assert_allclose(p(name), j(name), rtol=1e-4, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(p("corners"), j("corners"), rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(p("directions"), j("directions"), rtol=1e-4, atol=1e-6)
    if losses:
        for name in ("gt_wp", "gt_alt", "gt_progress"):
            np.testing.assert_allclose(p(name), j(name), rtol=1e-4, atol=1e-6,
                                       err_msg=name)
        np.testing.assert_allclose(float(pout.loss), float(jout.loss), rtol=1e-4)
    if ha:
        np.testing.assert_array_equal(p("ha_valid"), j("ha_valid"))
        m = j("ha_valid")
        assert m.any()
        for name in ("ha_precision", "ha_recall", "ha_nss"):
            np.testing.assert_allclose(p(name)[m], j(name)[m], atol=1e-4, err_msg=name)


def test_batches_match(setup):
    jarr, jb, jmeta = setup["jside"]
    parr, pb, pmeta = setup["pside"]
    np.testing.assert_array_equal(parr.numpy(), np.asarray(jarr))
    for f in dataclasses.fields(jb.episode):
        np.testing.assert_allclose(getattr(pb.episode, f.name).numpy(),
                                   np.asarray(getattr(jb.episode, f.name)),
                                   err_msg=f.name)
    for name in ("ids_instr", "mask_instr", "ids_dialog", "mask_dialog"):
        np.testing.assert_array_equal(getattr(pb, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    assert [m["instr_id"] for m in pmeta] == [m["instr_id"] for m in jmeta]


@pytest.mark.parametrize("mode", ["student_losses", "student_serving", "teacher_ha"])
def test_rollout_matches_jax(setup, mode):
    teacher = mode == "teacher_ha"
    losses = mode != "student_serving"
    jout, pout = run_both(setup, teacher=teacher, collect_ha=teacher,
                          compute_losses=losses)
    assert pout.actions_wp.shape == (T_STEPS, N_ITEMS, 2)
    assert_rollouts_match(jout, pout, ha=teacher, losses=losses)
