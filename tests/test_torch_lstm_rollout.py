"""The port's HAA-LSTM rollouts against the JAX package's, step by step, on
the CPU at tiny width (BERT 2×64, the tiny Darknet, ``HAALSTM`` at ``demb``
64 with its 192/576 cells, T = 5, B = 4), on the fixture's val_seen items.

Both sides get the same weights (the JAX ``init_state`` of ``--family
lstm``, BatchNorm statistics randomised, carried across by
``compat/from_jax.py``) and each side's own bank and batch of the same items
(``test_torch_rollout.both_batches``):

* the student nav eval (``make_eval_rollout(teacher=False)``, stop threshold
  0.25) as shipped, with ``--no_direction`` (the cell sees (sin, cos) =
  (0, 1)) and with ``--language_only`` (zeroed features);
* the vision-only and language-only ablation closures through the engine
  (``tests/test_lstm_variants.py``'s rollouts, with the HA statistics on: the
  language-only cell's zero head gives JAX's zero-map statistics);
* the time-fused teacher rollout against JAX's ``rollout_teacher_fused
  (family="lstm")``, in eval (the HA eval) and in train mode (BatchNorm on
  batch statistics, the −NSS term at ``nss_w`` 0.1, dropout the identity on
  both sides), and against the port's own step loop.

Tolerances of ``tests/test_torch_rollout.py``: stop flags identical;
actions, progress and corners within 1e-4 relative; HA precision, recall
and NSS within 1e-4; the loss within 1e-4 relative. The BatchNorm running
statistics after the train-mode rollout within 1e-5.
"""

import dataclasses
import json
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_e2e_loop import make_args
from test_torch_rollout import assert_rollouts_match, both_batches, jax_models, port_args
from test_torch_train_step import zero_dropout
from torch_shared import fixture_dataset

T_STEPS = 5
N_ITEMS = 4


def lstm_port_weights(state, dk_model, args):
    """A JAX LSTM state as the port's ``{lang_model, vision_model,
    vln_model}`` state dicts."""
    from avdn_tpu_torch.compat import from_jax

    return {
        "lang_model": from_jax.bert_state_dict(
            {"params": state.bert_params}, args.bert_layers),
        "vision_model": from_jax.darknet_state_dict(
            {"params": state.darknet_params, "batch_stats": state.batch_stats},
            dk_model.cfg.block_dicts()),
        "vln_model": from_jax.lstm_state_dict({"params": state.vln_params}),
    }


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from avdn_tpu.serve import Navigator as JaxNavigator
    from avdn_tpu_torch.compat.from_jax import load_agent_weights
    from avdn_tpu_torch.train.loop import build_models

    root, cfg_path = fixture_dataset(tmp_path_factory)
    out = str(tmp_path_factory.mktemp("lstm_roll"))
    args = make_args(root, out, cfg_path, family="lstm", render_twopass=False, bf16=False,
                     fused_teacher=False, max_action_len=T_STEPS)
    pargs = port_args(args)
    cfg, models, state = jax_models(args)
    pmodels = build_models(pargs, torch.device("cpu"))
    load_agent_weights(pmodels, lstm_port_weights(state, models[1], args))
    raw = json.load(open(os.path.join(root, "AVDN", "annotations", "val_seen_data.json")))
    items = [JaxNavigator._normalize_item(it) for it in raw[:N_ITEMS]]
    jside, pside = both_batches(args, pargs, items)
    return dict(args=args, pargs=pargs, cfg=cfg, models=models, state=state,
                pmodels=pmodels, jside=jside, pside=pside)


def _cfgs(setup, **over):
    """The JAX and the port's eval configs with ``over`` applied to both."""
    from avdn_tpu_torch.train.loop import eval_config_from_args

    return (dataclasses.replace(setup["cfg"], **over),
            dataclasses.replace(eval_config_from_args(setup["pargs"]), **over))


def _eval_both(setup, teacher, **over):
    from avdn_tpu.train.step import make_eval_rollout as jax_rollout
    from avdn_tpu_torch.train.step import make_eval_rollout

    jcfg, pcfg = _cfgs(setup, **over)
    assert jcfg.student_stop == pcfg.student_stop == 0.25
    kw = dict(teacher=teacher, collect_ha=teacher)
    jarr, jb, _ = setup["jside"]
    jout = jax.device_get(jax.jit(jax_rollout(jcfg, *setup["models"], **kw))(
        setup["state"], jarr, jb, jax.random.PRNGKey(1)))
    parr, pb, _ = setup["pside"]
    pout = make_eval_rollout(pcfg, *setup["pmodels"], **kw)(
        parr, pb, torch.Generator().manual_seed(1))
    return jout, pout


@pytest.mark.parametrize("ablation", ["shipped", "no_direction", "language_only"])
def test_student_rollout_matches_jax(setup, ablation):
    over = {} if ablation == "shipped" else {ablation: True}
    jout, pout = _eval_both(setup, teacher=False, **over)
    assert pout.actions_wp.shape == (T_STEPS, N_ITEMS, 2)
    assert_rollouts_match(jout, pout)


def _episodes(setup, hidden):
    """Each side's episode batch with the same seeded language inputs."""
    rng = np.random.default_rng(7)
    feat = rng.normal(size=(N_ITEMS, 9, hidden)).astype(np.float32)
    cls = rng.normal(size=(N_ITEMS, 49)).astype(np.float32)
    mask = np.ones((N_ITEMS, 9), bool)
    jep = setup["jside"][1].episode.replace(lang_feat=jnp.asarray(feat),
                                            lang_cls=jnp.asarray(cls),
                                            lang_mask=jnp.asarray(mask))
    pep = dataclasses.replace(setup["pside"][1].episode, lang_feat=torch.from_numpy(feat),
                              lang_cls=torch.from_numpy(cls), lang_mask=torch.from_numpy(mask))
    return jep, pep


@pytest.mark.parametrize("variant", ["vision_only", "lang_only"])
def test_variant_rollout_matches_jax(setup, variant):
    from avdn_tpu.models import lstm as jlstm
    from avdn_tpu.rollout import RolloutConfig as JRolloutConfig
    from avdn_tpu.rollout import engine as jengine
    from avdn_tpu_torch.compat.from_jax import lstm_state_dict
    from avdn_tpu_torch.models import lstm
    from avdn_tpu_torch.rollout import engine

    kw = dict(hidden_size=64, dir_hidden=16, vis_hidden=48) if variant == "vision_only" \
        else dict(hidden_size=64)
    jcfg = jlstm.LSTMConfig(**kw)
    jep, pep = _episodes(setup, jcfg.hidden_size)
    B = N_ITEMS
    if variant == "vision_only":
        jm = jlstm.HAALSTMVisionOnly(jcfg)
        params = jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.zeros((B, 1)),
                                  jnp.zeros((B, 64, 49)), jlstm.init_lstm_state(B, jcfg))
        pm = lstm.HAALSTMVisionOnly(lstm.LSTMConfig(**kw))
    else:
        jm = jlstm.HAALSTMLangOnly(jcfg)
        params = jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.zeros((B, 1)), jep.lang_feat,
                                  (jnp.zeros((B, 64)),) * 2)
        pm = lstm.HAALSTMLangOnly(lstm.LSTMConfig(**kw))
    pm.load_state_dict({k: torch.as_tensor(np.array(v))
                        for k, v in lstm_state_dict(params).items()}, strict=True)
    pm.eval()
    roll = dict(max_action_len=T_STEPS, teacher_forcing=False, stop_threshold=0.25,
                collect_ha_metrics=True)
    jroll, proll = JRolloutConfig(**roll), engine.RolloutConfig(**roll)
    st = setup["state"]
    dk_vars = {"params": st.darknet_params, "batch_stats": st.batch_stats}
    if variant == "vision_only":
        jstep, jinit = jengine.make_lstm_vision_only_step(setup["models"][1], jm, dk_vars,
                                                          params, jep, jroll)
        pstep, pinit = engine.make_lstm_vision_only_step(setup["pmodels"][1], pm, pep, proll)
    else:
        jstep, jinit = jengine.make_lstm_lang_only_step(jm, params, jep, jroll)
        pstep, pinit = engine.make_lstm_lang_only_step(pm, pep, proll)
    jarr, parr = setup["jside"][0], setup["pside"][0]
    jout, _ = jax.jit(lambda bank, r: jengine.rollout(
        map_bank=bank, batch=jep, cfg=jroll, model_step=jstep,
        init_model_state=jinit(), rng=r))(jarr, jax.random.PRNGKey(2))
    with torch.no_grad():
        pout, _ = engine.rollout(map_bank=parr, batch=pep, cfg=proll, model_step=pstep,
                                 init_model_state=pinit(), generator=torch.Generator())
    jout = jax.device_get(jout)
    assert np.isfinite(pout.actions_wp.numpy()).all()
    assert_rollouts_match(jout, pout, ha=variant == "vision_only")
    if variant == "lang_only":
        # a zero map: no item valid, and JAX's statistics of it
        assert not pout.ha_valid.any() and not np.asarray(jout.ha_valid).any()
        for name in ("ha_precision", "ha_recall", "ha_nss"):
            np.testing.assert_array_equal(getattr(pout, name).numpy(),
                                          np.asarray(getattr(jout, name)), err_msg=name)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "step_loop"])
def test_ha_eval_matches_jax(setup, fused):
    """The teacher-forced HA eval, the port's fused path or its step loop,
    against JAX's fused HA eval."""
    from avdn_tpu.train.step import make_eval_rollout as jax_rollout
    from avdn_tpu_torch.train.step import make_eval_rollout

    jcfg, pcfg = _cfgs(setup, fused_teacher=True)
    kw = dict(teacher=True, collect_ha=True)
    jarr, jb, _ = setup["jside"]
    jout = jax.device_get(jax.jit(jax_rollout(jcfg, *setup["models"], **kw))(
        setup["state"], jarr, jb, jax.random.PRNGKey(1)))
    parr, pb, _ = setup["pside"]
    pout = make_eval_rollout(dataclasses.replace(pcfg, fused_teacher=fused),
                             *setup["pmodels"], **kw)(parr, pb, torch.Generator().manual_seed(1))
    assert_rollouts_match(jout, pout, ha=True)


def test_fused_train_rollout_matches_jax_and_step_loop(setup):
    """Train mode (dropout the identity on both sides): the port's fused
    teacher rollout against JAX's ``rollout_teacher_fused(family="lstm")``
    (outputs, loss, BatchNorm running statistics) and against the port's own
    step loop (the same, from the same weights)."""
    import copy

    from avdn_tpu.rollout import RolloutConfig as JRolloutConfig
    from avdn_tpu.rollout.fused import rollout_teacher_fused as jax_fused
    from avdn_tpu_torch.rollout import engine
    from avdn_tpu_torch.rollout.fused import rollout_teacher_fused

    roll = dict(max_action_len=T_STEPS, teacher_forcing=True, stop_threshold=0.25,
                train=True, nss_w=0.1, collect_ha_metrics=True)
    jep, pep = _episodes(setup, 64)
    st = setup["state"]
    jroll = JRolloutConfig(**roll)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        jout, jstate = jax.jit(lambda bank, r: jax_fused(
            map_bank=bank, batch=jep, cfg=jroll, family="lstm",
            darknet_model=setup["models"][1], vln_model=setup["models"][2],
            dk_vars={"params": st.darknet_params, "batch_stats": st.batch_stats},
            vln_vars={"params": st.vln_params}, rng=r))(setup["jside"][0],
                                                        jax.random.PRNGKey(3))
    jout, jstats = jax.device_get((jout, jstate["batch_stats"]))

    outs, stats = {}, {}
    for name in ("fused", "step_loop"):
        _, dk, vln = copy.deepcopy(setup["pmodels"])
        zero_dropout(dk, vln)
        dk.train()
        vln.train()
        proll = engine.RolloutConfig(**roll)
        gen = torch.Generator().manual_seed(3)
        if name == "fused":
            out = rollout_teacher_fused(map_bank=setup["pside"][0], batch=pep, cfg=proll,
                                        family="lstm", darknet_model=dk, vln_model=vln,
                                        generator=gen)
        else:
            step, init = engine.make_lstm_step(dk, vln, pep,
                                               dataclasses.replace(proll, fused_teacher=False),
                                               gen)
            out, _ = engine.rollout(map_bank=setup["pside"][0], batch=pep, cfg=proll,
                                    model_step=step, init_model_state=init(), generator=gen)
        assert out.loss.requires_grad
        outs[name] = dataclasses.replace(out, **{
            f.name: getattr(out, f.name).detach() for f in dataclasses.fields(out)
            if getattr(out, f.name) is not None})
        stats[name] = {n: b.detach().clone() for n, b in dk.named_buffers()}
    assert_rollouts_match(jout, outs["fused"], ha=True)
    assert_rollouts_match(outs["step_loop"], outs["fused"], ha=True)
    n = 0
    for key, s in jstats.items():
        i = int(key.split("_")[1])
        pre = f"module_list.{i}.batch_norm_{i}."
        for jname, pname in (("mean", "running_mean"), ("var", "running_var")):
            for got in stats.values():
                np.testing.assert_allclose(got[pre + pname].numpy(), np.asarray(s[jname]),
                                           rtol=1e-5, atol=1e-5, err_msg=pre + pname)
        n += 1
    assert n > 0
