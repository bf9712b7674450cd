"""One train step of the production recipe (``--preset production``'s
flags: bf16 towers, the two-pass render in both rollouts, ``--remat`` with
the ``dots`` policy) in the port against the JAX package's, on the CPU at
tiny width (BERT 2×128, the tiny Darknet, the trunk at demb 128 with 1
layer, B = 2, T = 3, ``--feedback student``, the fused teacher, crop 256).

As in ``tests/test_torch_train_step.py``: ``jax.value_and_grad`` of the JAX
train loss (one compile; the whole batch on one device, the port's batch
layout), flax's dropout the identity and the port's rates at 0, the same
weights and items on both sides, each rendering its own views. The two-pass
render runs fp32 weights on the CPU in both packages; the towers compute at
flax's bf16 rounding points on both sides (``models/layers.py``), the port
under autograd. One thing is pinned: the port's student pass replays the
JAX student pass's trajectory (its stop decisions and post-step views).
The closed loop turns one bf16 ulp of a predicted waypoint into a
different rounded view corner and so a different view: without the replay
(seed 0) item 1's second view moved by ~1 m and the loss differed by
1.4e-3 relative.

Held:

* the loss within 5e-4 relative;
* every gradient leaf within 0.15 of that leaf's largest magnitude, and the
  mean of those per-leaf errors at most half that of the port's own float32
  step from the same weights against the same JAX bf16 gradients: the
  roundings are the JAX package's, not just any bf16;
* the BatchNorm running statistics after the two passes within 1e-3
  (rtol = atol).

Readings behind the bars (an 8-core Intel Xeon CPU, torch 2.13, jax 0.9,
seed 0): the loss 3.8e-5 relative; the
largest leaf error 9.0e-2 of its leaf's max (the action decoder's first
layer; float32: 1.8e-1), the mean per-leaf error 2.37e-2 against float32's
5.61e-2 (BERT 2.6e-2 / 5.5e-2, Darknet 2.1e-2 / 1.1e-1, trunk 2.1e-2 /
4.5e-2); the BN statistics 1.5e-4. The forward matches flax's roundings op
for op, but autograd's backward formulas (gelu's, the layer norms', the
bias reductions') round at other points than JAX's transposes as XLA
compiles them, so every leaf carries a few bf16 ulps of noise: hence bars
far looser than the float32 step's 1e-4.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_e2e_loop import make_args
from test_torch_rollout import both_batches, port_args
from test_torch_train_step import (_both_models, _jax_grads_by_name,
                                   _jax_loss_and_grads, zero_dropout)
from torch_shared import fixture_dataset

T_STEPS = 3
N_ITEMS = 2
RECIPE = dict(bf16=True, render_twopass=True, remat=True, remat_policy="dots",
              render_crop=256)


def _port_step(pargs, pmodels, pside, traj):
    """The port's train loss and backward, its student pass replaying the
    JAX student pass's trajectory ``traj`` (the simulator's feedback only:
    the stop decisions and post-step views)."""
    import avdn_tpu_torch.rollout.engine as engine
    from avdn_tpu_torch.train.loop import train_config_from_args
    from avdn_tpu_torch.train.step import make_loss_fn

    corners, dirs, alive_post = traj

    def replay(c, d, wp, alt, prog, thresh, t, T, extent):
        return ~alive_post[t], corners[t], dirs[t]

    zero_dropout(*pmodels)
    for m in pmodels:
        m.train()
    parr, pb, _ = pside
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine, "dynamics_update", replay)
        loss = make_loss_fn(train_config_from_args(pargs), *pmodels)(
            pb, parr, torch.Generator().manual_seed(1), N_ITEMS)
    loss.backward()
    return float(loss.detach())


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    from avdn_tpu.serve import Navigator as JaxNavigator

    root, cfg_path = fixture_dataset(tmp_path_factory)
    out = str(tmp_path_factory.mktemp("train_step_production"))
    args = make_args(root, out, cfg_path, max_action_len=T_STEPS, batch_size=N_ITEMS,
                     demb=128, **RECIPE)
    pargs = port_args(args)
    pmodels, models, state = _both_models(args, pargs, bf16=True)
    raw = json.load(open(os.path.join(root, "AVDN", "annotations", "train_data.json")))
    items = [JaxNavigator._normalize_item(it) for it in raw[:N_ITEMS]]
    jside, pside = both_batches(args, pargs, items)
    jloss, jgrads, jstats, traj = _jax_loss_and_grads(args, models, state, jside)
    ploss = _port_step(pargs, pmodels, pside, traj)
    # the same step with float32 towers (same weights): the yardstick
    fargs = port_args(make_args(root, out, cfg_path, max_action_len=T_STEPS,
                                batch_size=N_ITEMS, demb=128, **dict(RECIPE, bf16=False)))
    fmodels, _, _ = _both_models(args, fargs, bf16=False)
    _port_step(fargs, fmodels, pside, traj)
    return dict(args=args, models=models, jloss=jloss, jgrads=jgrads, jstats=jstats,
                ploss=ploss, pmodels=pmodels, fmodels=fmodels)


def test_loss_matches_jax(both):
    assert np.isfinite(both["ploss"])
    rel = abs(both["ploss"] - both["jloss"]) / abs(both["jloss"])
    print(f"loss {both['ploss']} vs {both['jloss']}: {rel:.3e} relative")
    assert rel <= 5e-4


def _leaf_errors(both, key):
    errs = {}
    for gi, group in enumerate(("bert", "darknet", "vln")):
        want = _jax_grads_by_name(both, group)
        for name, p in both[key][gi].named_parameters():
            w = np.asarray(want[name])
            scale = np.abs(w).max()
            if scale == 0 or name.endswith("attention.self.key.bias"):
                continue  # zero in exact arithmetic: rounding noise on both sides
            errs[f"{group}.{name}"] = float(np.abs(p.grad.float().numpy() - w).max() / scale)
    return errs


def test_grads_match_jax(both):
    bf = _leaf_errors(both, "pmodels")
    fp = _leaf_errors(both, "fmodels")
    worst = max(bf, key=bf.get)
    mean_bf, mean_fp = np.mean(list(bf.values())), np.mean(list(fp.values()))
    print(f"worst leaf {worst} {bf[worst]:.3e}; mean bf16 {mean_bf:.3e} fp32 {mean_fp:.3e}")
    assert len(bf) > 20
    assert bf[worst] <= 0.15, worst
    assert mean_bf * 2 <= mean_fp


def test_bn_running_stats_match_jax(both):
    sd = both["pmodels"][1].state_dict()
    worst = 0.0
    for name, stats in both["jstats"].items():
        i = int(name.split("_")[1])
        pre = f"module_list.{i}.batch_norm_{i}."
        for key, ours in (("mean", "running_mean"), ("var", "running_var")):
            got, want = sd[pre + ours].numpy(), np.asarray(stats[key])
            worst = max(worst, float((np.abs(got - want) / (1 + np.abs(want))).max()))
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3,
                                       err_msg=pre + ours)
    print(f"BN statistics: {worst:.3e}")
