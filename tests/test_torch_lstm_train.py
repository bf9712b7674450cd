"""HAA-LSTM training in the port against the JAX package's, on the CPU at
tiny width (BERT 2×64, the tiny Darknet, ``HAALSTM`` at ``demb`` 64 with
its 192/576 cells, B = 2, T = 3, ``--feedback student``, the fused
teacher, ``--nss_w`` 0.1, the exact render), on the fixture's train items.

* One train loss and its backward against ``jax.value_and_grad`` of the JAX
  loss (``test_torch_train_step._jax_loss_and_grads``: the teacher pass at
  ``nss_w`` 0, then the student pass at 0.25 stop threshold; one JAX
  compile), both packages drawing the same dropout masks
  (``torch_shared.shared_dropout_masks``), from the same weights (the port's
  random init with randomised BatchNorm statistics, carried to flax by the
  JAX package's own ``compat/torch_import.py``). Bars of
  ``tests/test_torch_train_step.py``: the loss within 1e-4 relative, every
  gradient leaf of the three groups within 1e-4 of that leaf's largest
  magnitude, the BatchNorm running statistics within 1e-5.
* A JAX LSTM ``TrainState`` one optax step in, carried across by
  ``compat/from_jax.py:train_state_entries(family="lstm")`` and
  ``load_train_state``, then one more step of the same gradients on each
  side: every parameter within 1e-6 of its tensor's largest magnitude (the
  ET check of ``tests/test_torch_train_step.py``).
* The vision tower's own global-norm clip (the JAX package's
  ``darknet_in_vln``): at a small ``grad_clip_vln`` the tower's and the
  cell's Adam moments each have the norm of their own clipped gradient.
* ``--remat`` full and dots: the loss, every gradient, the BatchNorm
  statistics and the generator's state bit-equal to no remat, in float32
  and bfloat16 towers, dropout on.
* Checkpoints in the reference's LSTM layout both ways: the port's
  ``latest_dict`` read by JAX's ``import_reference_agent(…, "lstm")``, and
  JAX's ``export_reference_agent(…, family="lstm")`` read by the port, the
  weights equal and one forward of each tower and the cell within 1e-5.
* ``python -m avdn_tpu_torch.cli.train_lstm`` trains 2 iterations with a
  checkpoint and a validation, and resumes from ``latest``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from test_e2e_loop import make_args
from test_torch_rollout import both_batches, port_args
from test_torch_train_step import (_jax_loss_and_grads, _JaxState,
                                   carried_train_state_steps_like_optax)
from torch_shared import fixture_dataset, port_argv, shared_dropout_masks

T_STEPS = 3
N_ITEMS = 2


def _port_models(pargs, seed=0, bf16=False):
    """The port's models, random init from ``seed``, BatchNorm statistics
    randomised."""
    from avdn_tpu_torch.train.loop import build_models, init_state

    models = build_models(pargs, torch.device("cpu"), bf16=bf16)
    init_state(models, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for m in models[1].modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.from_numpy(
                    rng.normal(0, 0.1, m.num_features).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, m.num_features).astype(np.float32)))
    return models


def _jax_state(args, pmodels):
    """The JAX flax modules and a state holding the port's weights."""
    from avdn_tpu.compat import torch_import
    from avdn_tpu.train.loop import build_models as jax_build_models

    jmodels = jax_build_models(args, bf16=False)
    sds = [{k: v.numpy() for k, v in m.state_dict().items()} for m in pmodels]
    return jmodels, _JaxState(
        torch_import.bert_params_from_torch(sds[0], args.bert_layers),
        torch_import.darknet_params_from_torch(sds[1], jmodels[1].cfg.block_dicts()),
        torch_import.lstm_params_from_torch(sds[2]))


def _port_loss(pargs, pmodels, pside, cfg=None, seed=1):
    from avdn_tpu_torch.train.loop import train_config_from_args
    from avdn_tpu_torch.train.step import make_loss_fn

    for m in pmodels:
        m.train()
    parr, pb, _ = pside
    cfg = cfg or train_config_from_args(pargs)
    gen = torch.Generator().manual_seed(seed)
    return make_loss_fn(cfg, *pmodels)(pb, parr, gen, N_ITEMS), gen


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    from avdn_tpu.serve import Navigator as JaxNavigator

    root, cfg_path = fixture_dataset(tmp_path_factory)
    out = str(tmp_path_factory.mktemp("lstm_train"))
    args = make_args(root, out, cfg_path, family="lstm", render_twopass=False, bf16=False,
                     max_action_len=T_STEPS, batch_size=N_ITEMS, nss_w=0.1)
    pargs = port_args(args)
    pmodels = _port_models(pargs)
    models, state = _jax_state(args, pmodels)
    raw = json.load(open(os.path.join(root, "AVDN", "annotations", "train_data.json")))
    items = [JaxNavigator._normalize_item(it) for it in raw[:N_ITEMS]]
    jside, pside = both_batches(args, pargs, items)
    with pytest.MonkeyPatch.context() as mp:
        shared_dropout_masks(mp)
        jloss, jgrads, jstats, _ = _jax_loss_and_grads(args, models, state, jside,
                                                       dropout_identity=False)
        ploss, _ = _port_loss(pargs, pmodels, pside)
        ploss.backward()
    return dict(root=root, cfg_path=cfg_path, args=args, pargs=pargs, models=models,
                state=state, jloss=jloss, jgrads=jgrads, jstats=jstats,
                ploss=float(ploss.detach()), pmodels=pmodels, pside=pside)


def test_loss_matches_jax(both):
    from avdn_tpu_torch.train.loop import train_config_from_args

    cfg = train_config_from_args(both["pargs"])
    assert (cfg.family, cfg.student_stop, cfg.darknet_in_vln) == ("lstm", 0.25, True)
    assert np.isfinite(both["ploss"])
    np.testing.assert_allclose(both["ploss"], both["jloss"], rtol=1e-4)


@pytest.mark.parametrize("group", ["bert", "darknet", "vln"])
def test_grads_match_jax(both, group):
    from avdn_tpu_torch.compat import from_jax

    args, g = both["args"], both["jgrads"]
    want = {
        "bert": lambda: from_jax.bert_state_dict({"params": g["bert"]}, args.bert_layers),
        "darknet": lambda: from_jax.darknet_state_dict(
            {"params": g["darknet"], "batch_stats": both["jstats"]},
            both["models"][1].cfg.block_dicts()),
        "vln": lambda: from_jax.lstm_state_dict({"params": g["vln"]}),
    }[group]()
    model = both["pmodels"][("bert", "darknet", "vln").index(group)]
    names = [n for n, _ in model.named_parameters()]
    assert set(names) <= set(want), sorted(set(names) - set(want))
    group_max = max(np.abs(np.asarray(want[n])).max() for n in names)
    assert group_max > 0
    bad = []
    for name, p in model.named_parameters():
        w = np.asarray(want[name])
        got = p.grad.numpy()
        if name.endswith("attention.self.key.bias"):
            # zero in exact arithmetic: rounding noise on both sides
            tol, err = 1e-6 * group_max, max(np.abs(got).max(), np.abs(w).max())
        else:
            tol, err = 1e-4 * np.abs(w).max(), np.abs(got - w).max()
        if not err <= tol:
            bad.append((name, float(err), float(tol)))
    assert not bad, bad


def test_bn_running_stats_match_jax(both):
    sd = both["pmodels"][1].state_dict()
    assert both["jstats"]
    for name, stats in both["jstats"].items():
        i = int(name.split("_")[1])
        pre = f"module_list.{i}.batch_norm_{i}."
        for jname, pname in (("mean", "running_mean"), ("var", "running_var")):
            np.testing.assert_allclose(sd[pre + pname].numpy(), np.asarray(stats[jname]),
                                       rtol=1e-5, atol=1e-5, err_msg=pre + pname)


def test_carried_train_state_steps_like_optax(both):
    """A JAX LSTM ``TrainState`` (the vision tower clipped on its own, the
    cell's Adam moments laid out as the cells' weights) one optax step in,
    carried across, then one more step on each side within 1e-6 of each
    tensor's largest magnitude."""
    carried_train_state_steps_like_optax(both, "lstm")


def test_vision_tower_has_its_own_clip(both):
    """At ``grad_clip_vln`` 1e-3 (far below every group's gradient norm) one
    train step's first Adam moment of the vision tower has the norm (1 −
    b1)·clip of its own clipped gradient, and so has the cell's: each group
    is clipped by its own norm (a joint clip over tower and cell would leave
    each below it); the language tower is not clipped."""
    from avdn_tpu_torch.train.loop import train_config_from_args
    from avdn_tpu_torch.train.optim import global_norm
    from avdn_tpu_torch.train.step import create_train_state, make_train_step

    clip = 1e-3
    cfg = dataclasses.replace(train_config_from_args(both["pargs"]), grad_clip_vln=clip)
    models = _port_models(both["pargs"])
    state = create_train_state(cfg, *models)
    parr, pb, _ = both["pside"]
    metrics = make_train_step(cfg, *models)(state, parr, pb, torch.Generator().manual_seed(1))
    assert float(metrics["grad_norm_vln"]) > 100 * clip
    for opt in (state.opt_darknet, state.opt_vln):
        np.testing.assert_allclose(float(global_norm(opt.mu)), 0.1 * clip, rtol=1e-5)
    np.testing.assert_allclose(float(global_norm(state.opt_bert.mu)),
                               0.1 * float(metrics["grad_norm_bert"]), rtol=1e-5)
    assert float(metrics["grad_norm_bert"]) > 100 * clip


def _remat_step(both, bf16, remat, policy="full"):
    from avdn_tpu_torch.train.loop import train_config_from_args

    models = _port_models(both["pargs"], bf16=bf16)
    cfg = dataclasses.replace(train_config_from_args(both["pargs"]), remat=remat,
                              remat_policy=policy)
    loss, gen = _port_loss(both["pargs"], models, both["pside"], cfg, seed=5)
    loss.backward()
    grads = {f"{i}.{n}": p.grad for i, m in enumerate(models) for n, p in m.named_parameters()}
    stats = {n: b.clone() for n, b in models[1].named_buffers()}
    return loss.detach(), grads, stats, gen.get_state()


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_remat_is_exact(both, bf16):
    want_loss, want_grads, want_stats, want_rng = _remat_step(both, bf16, remat=False)
    assert torch.isfinite(want_loss)
    for policy in ("full", "dots"):
        loss, grads, stats, rng = _remat_step(both, bf16, remat=True, policy=policy)
        assert torch.equal(loss, want_loss), policy
        assert set(grads) == set(want_grads)
        for name, g in grads.items():
            w = want_grads[name]
            assert (g is None) == (w is None), name
            if g is not None:
                assert torch.equal(g, w), (policy, name, float((g - w).abs().max()))
        for name, s in stats.items():
            assert torch.equal(s, want_stats[name]), (policy, name)
        assert torch.equal(rng, want_rng), policy


def _forwards(modules, jax_models=None, seed=0):
    """A forward of each module on seeded inputs, as numpy arrays: the
    port's ``modules``, or with ``jax_models`` the JAX variables
    ``modules`` = (bert_vars, dk_vars, vln_vars)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1000, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    img = rng.normal(size=(2, 224, 224, 3)).astype(np.float32)
    deg = rng.uniform(0, 360, (2, 1)).astype(np.float32)
    feat = rng.normal(size=(2, 64, 49)).astype(np.float32)
    cls = rng.normal(size=(2, 49)).astype(np.float32)
    lang = rng.normal(size=(2, 9, 64)).astype(np.float32)
    if jax_models is None:
        from avdn_tpu_torch.models.lstm import DEG_TO_RAD, init_lstm_state
        from avdn_tpu_torch.ops.saliency import saliency_upsample

        bert, dk, vln = modules
        t = torch.from_numpy
        with torch.no_grad():
            out = [bert(t(ids).long(), t(mask).long())[1], dk(t(img))]
            _, a, s = vln(t(deg) * DEG_TO_RAD, t(feat), t(cls), t(lang),
                          init_lstm_state(2, vln.cfg))
            out += [a, saliency_upsample(s)]
        return [o.float().numpy() for o in out]
    from avdn_tpu.models.lstm import init_lstm_state as jinit

    (jb, jd, jv), (bert, dk, vln) = jax_models, modules
    out = [jb.apply(bert, ids, mask)[1], jd.apply(dk, img, train=False)]
    _, a, s = jv.apply(vln, jnp.asarray(deg), feat, cls, lang, jinit(2, jv.cfg))
    return [np.asarray(o) for o in out + [a, s]]


def test_checkpoints_cross_both_ways(both, tmp_path):
    """The port's LSTM-layout checkpoint read by JAX, and JAX's LSTM export
    read by the port: weights (BatchNorm statistics included) equal, and each
    module's forward on both sides within 1e-5."""
    from avdn_tpu.compat.torch_export import export_reference_agent
    from avdn_tpu.train import checkpoints as jax_ckpt
    from avdn_tpu_torch.compat.from_jax import load_agent_weights, load_reference_agent
    from avdn_tpu_torch.train import checkpoints as ckpt
    from avdn_tpu_torch.train.loop import build_models, train_config_from_args
    from avdn_tpu_torch.train.step import create_train_state

    args, pargs = both["args"], both["pargs"]
    blocks = both["models"][1].cfg.block_dicts()
    models = _port_models(pargs, seed=3)
    state = create_train_state(train_config_from_args(pargs), *models)
    path = ckpt.save_checkpoint(str(tmp_path), "latest_dict_1", state)
    blob = torch.load(path, weights_only=False)
    assert sorted(k for k in blob if k != "step") == ["lang_model", "vln_model"]
    vln_keys = blob["vln_model"]["state_dict"]
    assert any(k.startswith("vision_model.module_list.") and k.endswith("running_var")
               for k in vln_keys) and "direct_lstm.weight_hh" in vln_keys
    assert set(blob["vln_model"]["optimizer"]["mu"]) == {
        k for k in vln_keys if not k.endswith(("running_mean", "running_var",
                                               "num_batches_tracked"))}

    # port → JAX
    bert_v, dk_v, vln_v, epoch = jax_ckpt.import_reference_agent(
        path, "lstm", blocks, bert_layers=args.bert_layers)
    assert epoch == 0
    want = _forwards(models)
    for got, w in zip(_forwards((bert_v, dk_v, vln_v), both["models"]), want):
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5)

    # JAX → port (its file loads into valid()'s models and a train state)
    pt = str(tmp_path / "jax_lstm.pt")
    export_reference_agent(pt, "lstm", blocks, bert_v, dk_v, vln_v,
                           bert_layers=args.bert_layers)
    loaded = build_models(pargs, torch.device("cpu"))
    load_agent_weights(loaded, load_reference_agent(pt, "lstm"))
    for a, b in zip(loaded, models):
        sa, sb = a.state_dict(), b.state_dict()
        assert set(sa) == set(sb)
        for k in sa:
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(sa[k], sb[k]), k
    for got, w in zip(_forwards(loaded), want):
        np.testing.assert_allclose(got, w, rtol=0, atol=0)
    fresh = create_train_state(train_config_from_args(pargs), *_port_models(pargs, seed=4))
    assert ckpt.load_checkpoint(pt, fresh, optimizer=False) == 0
    for a, b in zip(fresh.models(), models):
        assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    with pytest.raises(KeyError, match="LSTM layout holds lang_model and vln_model"):
        load_reference_agent(pt, "et")
    with pytest.raises(KeyError, match=r"missing \['vision_model'\]"):
        load_reference_agent(pt, "et")


def test_train_lstm_cli_trains_and_resumes(both, tmp_path):
    """``cli.train_lstm`` at ``run_lstm_haa.sh``'s recipe (student feedback,
    ``--nss_w 0``, AdamW) trains 2 iterations (one step each, a checkpoint and
    a validation after each), then ``--resume_file latest`` trains on from
    step 2 with the optimizer restored; ``valid()`` loads its checkpoint."""
    from avdn_tpu_torch.cli.train_lstm import main

    args = make_args(both["root"], str(tmp_path / "out"), both["cfg_path"], family="lstm",
                     render_twopass=False, batch_size=8, nss_w=0.0)
    argv = port_argv(args) + ["--iters", "2", "--log_every", "1", "--lr", "1e-3"]
    state, history = main(argv, device="cpu")
    assert state.step == 2 and state.family == "lstm" and len(history) == 2
    assert all(np.isfinite(v) for m in history for v in m.values())
    ckpts = sorted(os.listdir(args.ckpt_dir))
    assert ckpts == ["best_val_unseen.pt", "latest_dict_1.pt", "latest_dict_2.pt"]
    state2, history2 = main(argv + ["--iters", "1", "--resume_file", "latest",
                                    "--resume_optimizer", "True"], device="cpu")
    assert state2.step == 3 and len(history2) == 1
    assert [o.count for o in state2.optimizers()] == [3, 3, 3]
    with open(os.path.join(args.log_dir, "train.txt")) as f:
        assert "latest_dict_2.pt, iteration 2" in f.read()
    results, _ = main(argv + ["--inference", "True", "--output_dir", str(tmp_path / "valid"),
                              "--resume_file", os.path.join(args.ckpt_dir, "latest_dict_3.pt")],
                      device="cpu")
    assert {"val_seen", "val_unseen", "val_seen_human_att"} <= set(results)
