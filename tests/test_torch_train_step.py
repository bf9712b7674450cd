"""The port's train step against the JAX package's, on the CPU at tiny width
(BERT 2×128, the tiny Darknet, the trunk at demb 128 with 1 layer, B = 2,
T = 3, ``--feedback student``, the fused teacher, the exact render).

The JAX reference is ``jax.value_and_grad`` of the loss composed from
``avdn_tpu.train.step._encode_language`` and ``_run_family_rollout``
exactly as ``make_train_step.loss_fn`` composes it (a teacher pass with the
NSS weight 0, then a student pass with ``nss_w``), in train mode, compiled
once for the module, with flax's ``Dropout.__call__`` replaced by the
identity while it is traced (the JAX package itself is not edited). The
port runs ``train/step.py:make_loss_fn`` with every dropout rate set to 0
(``zero_dropout``) and its modules in train mode. Both start from the same
weights (the port's random init, with randomised BatchNorm running
statistics, carried to flax by the JAX package's own
``compat/torch_import.py``: no JAX init is compiled) and the same items of
the fixture's train split, and each renders its own views (the exact render
on these items' projective view quads; ``tests/test_torch_sim.py`` holds the
port's source coordinates bit-equal to XLA's).

Tolerances: the loss within 1e-4 relative (the two sides draw the loss's
1e-5 heading jitter from different generators); every gradient leaf of the
three groups within 1e-4 of that leaf's largest magnitude (BERT's attention
key biases, whose gradient is zero in exact arithmetic, below 1e-6 of the
group's largest gradient on both sides); the BatchNorm
running statistics after the two passes (2·T train-mode tower calls)
within 1e-5 (rtol = atol; a batch mean near zero is a sum that cancels).
"""

import json
import os

import flax.linen
import jax
import numpy as np
import pytest
import torch

from test_e2e_loop import make_args
from test_torch_rollout import both_batches, port_args
from torch_shared import fixture_dataset

T_STEPS = 3
N_ITEMS = 2


def zero_dropout(*models):
    """Every dropout rate of the port's modules set to 0 (test helper)."""
    from avdn_tpu_torch.models.layers import Dropout

    for model in models:
        for mod in model.modules():
            if isinstance(mod, Dropout):
                mod.p = 0.0


class _JaxState:
    """The fields of the JAX ``TrainState`` that the loss reads."""

    def __init__(self, bert, darknet, vln):
        self.bert_params = bert["params"]
        self.darknet_params = darknet["params"]
        self.batch_stats = darknet["batch_stats"]
        self.vln_params = vln["params"]


def _both_models(args, pargs, seed=0, bf16=False):
    """The port's models (random init, BatchNorm statistics randomised) and
    the JAX package's flax modules with the same weights, by the JAX
    package's importers; both towers computing in bfloat16 with ``bf16``."""
    from avdn_tpu.compat import torch_import
    from avdn_tpu.train.loop import build_models as jax_build_models
    from avdn_tpu_torch.train.loop import build_models, init_state

    pmodels = build_models(pargs, torch.device("cpu"), bf16=bf16)
    init_state(pmodels, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for m in pmodels[1].modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.from_numpy(
                    rng.normal(0, 0.1, m.num_features).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, m.num_features).astype(np.float32)))
    jmodels = jax_build_models(args, bf16=bf16)
    sds = [{k: v.numpy() for k, v in m.state_dict().items()} for m in pmodels]
    state = _JaxState(
        torch_import.bert_params_from_torch(sds[0], args.bert_layers),
        torch_import.darknet_params_from_torch(sds[1], jmodels[1].cfg.block_dicts()),
        torch_import.et_params_from_torch(sds[2], args.encoder_layers))
    return pmodels, jmodels, state


def _jax_loss_and_grads(args, models, state, jside, dropout_identity=True):
    """``value_and_grad`` of the JAX train loss (``make_train_step.loss_fn``'s
    composition), jitted, dropout the identity (unless
    ``dropout_identity`` is False: then flax's dropout as it stands while
    this traces): (loss, grads, new BN statistics, the student pass's
    trajectory: post-step corners, directions and alive flags, each
    (T, B, ...))."""
    from avdn_tpu.train.loop import train_config_from_args
    from avdn_tpu.train.step import _encode_language, _run_family_rollout

    cfg = train_config_from_args(args)
    bert, dk, vln = models

    def loss_fn(trainable, batch_stats, map_bank, batch, rng):
        r_bert, r_t, r_s = jax.random.split(rng, 3)
        bert_out = _encode_language(bert, trainable["bert"], batch, cfg, train=True,
                                    rng=r_bert)
        out_t, batch_stats = _run_family_rollout(
            cfg, cfg.rollout_cfg(teacher=True, nss_w=0.0), (dk, vln), bert_out,
            trainable, batch_stats, batch, map_bank, r_t)
        out_s, batch_stats = _run_family_rollout(
            cfg, cfg.rollout_cfg(teacher=False, nss_w=cfg.nss_w), (dk, vln), bert_out,
            trainable, batch_stats, batch, map_bank, r_s)
        B = batch.ids_instr.shape[0]
        traj = (out_s.corners, out_s.directions, out_s.alive_post)
        return cfg.ml_weight * (out_t.loss + out_s.loss) / B, (batch_stats, traj)

    trainable = {"bert": state.bert_params, "darknet": state.darknet_params,
                 "vln": state.vln_params}
    jarr, jb, _ = jside
    with pytest.MonkeyPatch.context() as mp:
        if dropout_identity:
            mp.setattr(flax.linen.Dropout, "__call__",
                       lambda self, x, deterministic=None, rng=None: x)
        fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (loss, (new_stats, traj)), grads = fn(trainable, state.batch_stats, jarr, jb,
                                              jax.random.PRNGKey(1))
    traj = tuple(torch.from_numpy(np.array(x)) for x in traj)
    return float(loss), jax.device_get(grads), jax.device_get(new_stats), traj


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    from avdn_tpu.serve import Navigator as JaxNavigator
    from avdn_tpu_torch.train.loop import train_config_from_args
    from avdn_tpu_torch.train.step import make_loss_fn

    root, cfg_path = fixture_dataset(tmp_path_factory)
    out = str(tmp_path_factory.mktemp("train_step"))
    args = make_args(root, out, cfg_path, render_twopass=False, bf16=False,
                     max_action_len=T_STEPS, batch_size=N_ITEMS, demb=128)
    pargs = port_args(args)
    pmodels, models, state = _both_models(args, pargs)
    raw = json.load(open(os.path.join(root, "AVDN", "annotations", "train_data.json")))
    items = [JaxNavigator._normalize_item(it) for it in raw[:N_ITEMS]]
    jside, pside = both_batches(args, pargs, items)
    jloss, jgrads, jstats, _ = _jax_loss_and_grads(args, models, state, jside)

    zero_dropout(*pmodels)
    for m in pmodels:
        m.train()
    parr, pb, _ = pside
    loss_fn = make_loss_fn(train_config_from_args(pargs), *pmodels)
    ploss = loss_fn(pb, parr, torch.Generator().manual_seed(1), N_ITEMS)
    ploss.backward()
    return dict(args=args, pargs=pargs, models=models, state=state, jloss=jloss,
                jgrads=jgrads, jstats=jstats, ploss=float(ploss.detach()),
                pmodels=pmodels)


def test_loss_matches_jax(both):
    assert np.isfinite(both["ploss"])
    np.testing.assert_allclose(both["ploss"], both["jloss"], rtol=1e-4)


def _jax_grads_by_name(both, group):
    from avdn_tpu_torch.compat import from_jax

    args, g = both["args"], both["jgrads"]
    if group == "bert":
        return from_jax.bert_state_dict({"params": g["bert"]}, args.bert_layers)
    if group == "darknet":
        return from_jax.darknet_state_dict(
            {"params": g["darknet"], "batch_stats": both["jstats"]},
            both["models"][1].cfg.block_dicts())
    return from_jax.et_state_dict({"params": g["vln"]}, args.encoder_layers)


@pytest.mark.parametrize("group", ["bert", "darknet", "vln"])
def test_grads_match_jax(both, group):
    model = both["pmodels"][("bert", "darknet", "vln").index(group)]
    want = _jax_grads_by_name(both, group)
    names = [n for n, _ in model.named_parameters()]
    assert set(names) <= set(want), sorted(set(names) - set(want))
    group_max = max(np.abs(np.asarray(want[n])).max() for n in names)
    assert group_max > 0  # the step really trains every group
    bad = []
    for name, p in model.named_parameters():
        w = np.asarray(want[name])
        assert p.grad is not None, name
        got = p.grad.numpy()
        if name.endswith("attention.self.key.bias"):
            # zero in exact arithmetic (softmax is invariant to a shift of a
            # row's logits): rounding noise on both sides
            tol = 1e-6 * group_max
            err = max(np.abs(got).max(), np.abs(w).max())
        else:
            tol = 1e-4 * np.abs(w).max()
            err = np.abs(got - w).max()
        if not err <= tol:
            bad.append((name, float(err), float(tol)))
    assert not bad, bad


def test_bn_running_stats_match_jax(both):
    darknet = both["pmodels"][1]
    sd = darknet.state_dict()
    n = 0
    for name, stats in both["jstats"].items():
        i = int(name.split("_")[1])
        pre = f"module_list.{i}.batch_norm_{i}."
        np.testing.assert_allclose(sd[pre + "running_mean"].numpy(),
                                   np.asarray(stats["mean"]), rtol=1e-5, atol=1e-5,
                                   err_msg=pre + "running_mean")
        np.testing.assert_allclose(sd[pre + "running_var"].numpy(),
                                   np.asarray(stats["var"]), rtol=1e-5, atol=1e-5,
                                   err_msg=pre + "running_var")
        n += 1
    assert n == sum(1 for m in darknet.modules()
                    if isinstance(m, torch.nn.BatchNorm2d)) > 0


def test_carried_train_state_steps_like_optax(both):
    """A JAX ``TrainState`` one optax step in (the JAX gradients above),
    carried across by ``compat/from_jax.py`` (parameters, BatchNorm
    statistics, the three optimizers' moments and counts, the step), then
    one more step of the same gradients on each side: every parameter within
    1e-6 of its tensor's largest magnitude (``test_torch_optim.py``'s bar)."""
    carried_train_state_steps_like_optax(both, "et")


def carried_train_state_steps_like_optax(both, family):
    """The check of :func:`test_carried_train_state_steps_like_optax` for
    ``both`` (a fixture of ``family``'s models, JAX state and gradients)."""
    import optax

    from avdn_tpu.train import step as jax_step
    from avdn_tpu.train.loop import train_config_from_args as jax_train_cfg
    from avdn_tpu_torch.compat import from_jax
    from avdn_tpu_torch.train.loop import build_models, train_config_from_args
    from avdn_tpu_torch.train.step import create_train_state

    args, state, g = both["args"], both["state"], both["jgrads"]
    jcfg = jax_train_cfg(args)
    jstate = jax_step.create_train_state(
        jcfg, {"params": state.bert_params},
        {"params": state.darknet_params, "batch_stats": state.batch_stats},
        {"params": state.vln_params})
    opts = {"bert": jax_step._make_optimizer(jcfg, with_clip=False),
            "darknet": jax_step._make_optimizer(jcfg, with_clip=jcfg.darknet_in_vln),
            "vln": jax_step._make_optimizer(jcfg, with_clip=True)}

    @jax.jit
    def jax_step_once(js):
        new = {}
        for grp in ("bert", "darknet", "vln"):
            upd, ost = opts[grp].update(g[grp], getattr(js, f"opt_{grp}"),
                                        getattr(js, f"{grp}_params"))
            new[f"opt_{grp}"] = ost
            new[f"{grp}_params"] = optax.apply_updates(getattr(js, f"{grp}_params"), upd)
        return js.replace(step=js.step + 1, **new)

    jstate = jax.device_get(jax_step_once(jstate))
    entries = from_jax.train_state_entries(jstate, both["models"][1].cfg.block_dicts(),
                                           args.bert_layers, args.encoder_layers, family)
    models = build_models(both["pargs"], torch.device("cpu"))
    pstate = create_train_state(train_config_from_args(both["pargs"]), *models)
    from_jax.load_train_state(pstate, entries)
    assert pstate.step == 1 and [o.count for o in pstate.optimizers()] == [1, 1, 1]
    assert pstate.family == family

    jstate = jax.device_get(jax_step_once(jstate))
    want = from_jax.train_state_entries(jstate, both["models"][1].cfg.block_dicts(),
                                        args.bert_layers, args.encoder_layers, family)
    for key, grp, opt in zip(("lang_model", "vision_model", "vln_model"),
                             ("bert", "darknet", "vln"), pstate.optimizers()):
        grads_by_name = {
            "bert": lambda: from_jax.bert_state_dict({"params": g["bert"]}, args.bert_layers),
            "darknet": lambda: from_jax.darknet_state_dict(
                {"params": g["darknet"], "batch_stats": both["jstats"]},
                both["models"][1].cfg.block_dicts()),
            "vln": lambda: (from_jax.et_state_dict({"params": g["vln"]}, args.encoder_layers)
                            if family == "et" else
                            from_jax.lstm_state_dict({"params": g["vln"]}))}[grp]()
        opt.step([torch.as_tensor(np.array(grads_by_name[n])) for n in opt.names])
        for n, p in zip(opt.names, opt.params):
            w = np.asarray(want[key]["state_dict"][n])
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                       atol=1e-6 * np.abs(w).max(), err_msg=n)
