"""The port's train step with dropout on against the JAX package's, both
drawing the same masks, on the CPU at ``tests/test_torch_train_step.py``'s
tiny width (BERT 2×128, the tiny Darknet, the trunk at demb 128 with 1
layer, B = 2, T = 3, ``--feedback student``, the fused teacher, the exact
render), with the student pass rematerialised (``--remat`` with the ``dots``
policy), in float32.

The two packages draw their dropout masks from different generators
(``jax.random`` keys, a ``torch.Generator``), so ``test_torch_train_step.py``
compares them with dropout off. Here every dropout of both packages keeps
the elements that a fixed hash of their flat index picks
(``torch_shared.shared_dropout_masks``: the same mask on both sides, kept
with probability ≈ 1 − rate), at the flags' rates. That holds against JAX
what the dropout-off test cannot see: where dropout sits in BERT, the trunk
and the heads, its rates and its 1/keep scaling, and its backward (through
the rematerialised student steps too). Removing one site (the saliency
projection's) fails the loss and every group's gradients. A control step of
the port with every rate at 0 shows that the masks change the loss. That
the port's recompute redraws the forward's masks from its generator is
``tests/test_torch_remat.py``'s to hold.

Bars: those of ``test_torch_train_step.py`` (the loss within 1e-4
relative, every gradient leaf within 1e-4 of that leaf's largest
magnitude, the BatchNorm running statistics within 1e-5).
"""

import json
import os

import pytest
import torch

from test_e2e_loop import make_args
from test_torch_rollout import both_batches, port_args
from test_torch_train_step import N_ITEMS, T_STEPS, _both_models, _jax_loss_and_grads
from test_torch_train_step import test_bn_running_stats_match_jax as _bn_match
from test_torch_train_step import test_grads_match_jax as _grads_match
from test_torch_train_step import test_loss_matches_jax as _loss_match
from test_torch_train_step import zero_dropout
from torch_shared import fixture_dataset, shared_dropout_masks


def _port_loss(pargs, pmodels, pside):
    from avdn_tpu_torch.train.loop import train_config_from_args
    from avdn_tpu_torch.train.step import make_loss_fn

    for m in pmodels:
        m.train()
    parr, pb, _ = pside
    return make_loss_fn(train_config_from_args(pargs), *pmodels)(
        pb, parr, torch.Generator().manual_seed(1), N_ITEMS)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    from avdn_tpu.serve import Navigator as JaxNavigator

    root, cfg_path = fixture_dataset(tmp_path_factory)
    out = str(tmp_path_factory.mktemp("train_step_dropout"))
    args = make_args(root, out, cfg_path, render_twopass=False, bf16=False,
                     max_action_len=T_STEPS, batch_size=N_ITEMS, demb=128,
                     remat=True, remat_policy="dots")
    pargs = port_args(args)
    pmodels, models, state = _both_models(args, pargs)
    raw = json.load(open(os.path.join(root, "AVDN", "annotations", "train_data.json")))
    items = [JaxNavigator._normalize_item(it) for it in raw[:N_ITEMS]]
    jside, pside = both_batches(args, pargs, items)
    with pytest.MonkeyPatch.context() as mp:
        shared_dropout_masks(mp)
        jloss, jgrads, jstats, _ = _jax_loss_and_grads(args, models, state, jside,
                                                       dropout_identity=False)
        ploss = _port_loss(pargs, pmodels, pside)
        ploss.backward()
    control = _both_models(args, pargs)[0]
    zero_dropout(*control)
    with torch.no_grad():
        loss_off = float(_port_loss(pargs, control, pside))
    return dict(args=args, pargs=pargs, models=models, state=state, jloss=jloss,
                jgrads=jgrads, jstats=jstats, ploss=float(ploss.detach()),
                pmodels=pmodels, loss_off=loss_off)


def test_masks_change_the_step(both):
    assert abs(both["ploss"] - both["loss_off"]) > 1e-3 * abs(both["loss_off"]), (
        both["ploss"], both["loss_off"])


def test_loss_matches_jax_with_dropout(both):
    _loss_match(both)


@pytest.mark.parametrize("group", ["bert", "darknet", "vln"])
def test_grads_match_jax_with_dropout(both, group):
    _grads_match(both, group)


def test_bn_running_stats_match_jax_with_dropout(both):
    _bn_match(both)
