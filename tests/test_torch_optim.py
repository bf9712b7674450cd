"""The port's optimizers against optax's, on random parameter trees.

Each of the train state's three optimizers (``train/step.py:
create_train_state``) against the JAX package's ``_make_optimizer`` chain
for the same group: AdamW with the weight decay at its default (0.01) and
set, and Adam; the global-norm clip at 40 on the VLN group, and on the
vision group too under ``darknet_in_vln``, with gradients whose norm is
below and above 40. Five steps from the same parameters and gradients
(numpy, seeded); after each, the parameters and both moments within 1e-6
relative to each tensor's largest magnitude, and the step counts equal.
(The clip's global norm sums in another order, one ulp apart, and a
moment that averages gradients of opposite signs cancels: its elements
near zero then differ by a few ulp of the tensor's scale.) No model is
compiled.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avdn_tpu.train import step as jax_step
from avdn_tpu_torch.train.optim import clip_by_global_norm, global_norm
from avdn_tpu_torch.train.step import TrainConfig, create_train_state

SHAPES = {"w": (6, 5), "b": (6,), "conv": (4, 3, 3, 3), "scale": (4,)}
GROUPS = ("bert", "darknet", "vln")
STEPS = 5


class _Params(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        for name, a in arrays.items():
            self.register_parameter(name, torch.nn.Parameter(torch.from_numpy(a.copy())))


def _trees(seed):
    rng = np.random.default_rng(seed)
    return {g: {k: rng.normal(0, 1, s).astype(np.float32) for k, s in SHAPES.items()}
            for g in GROUPS}


def _grads(rng, grad_norm):
    """One random gradient tree per group, scaled to ``grad_norm``."""
    out = {}
    for g in GROUPS:
        tree = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in SHAPES.items()}
        norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in tree.values()))
        out[g] = {k: (v * (grad_norm / norm)).astype(np.float32) for k, v in tree.items()}
    return out


@pytest.mark.parametrize("grad_norm", [12.0, 95.0], ids=["below_clip", "above_clip"])
@pytest.mark.parametrize("darknet_in_vln", [False, True], ids=["et", "darknet_in_vln"])
@pytest.mark.parametrize("optim,weight_decay", [("adamW", None), ("adamW", 0.1),
                                                ("adam", None)],
                         ids=["adamw_default_wd", "adamw_wd0.1", "adam"])
def test_optimizers_match_optax(optim, weight_decay, darknet_in_vln, grad_norm):
    kw = dict(optim=optim, weight_decay=weight_decay, lr=3e-3,
              darknet_in_vln=darknet_in_vln)
    trees = _trees(0)
    state = create_train_state(TrainConfig(**kw), *(_Params(trees[g]) for g in GROUPS))
    jcfg = jax_step.TrainConfig(**kw)
    with_clip = {"bert": False, "darknet": darknet_in_vln, "vln": True}
    assert [o.clip for o in state.optimizers()] == [
        40.0 if with_clip[g] else None for g in GROUPS]
    jopt = {g: jax_step._make_optimizer(jcfg, with_clip=with_clip[g]) for g in GROUPS}
    jparams = {g: {k: jnp.asarray(v) for k, v in trees[g].items()} for g in GROUPS}
    jstate = {g: jopt[g].init(jparams[g]) for g in GROUPS}

    rng = np.random.default_rng(1)
    for _ in range(STEPS):
        grads = _grads(rng, grad_norm)
        for g, opt in zip(GROUPS, state.optimizers()):
            opt.step([torch.from_numpy(grads[g][n]) for n in opt.names])
            upd, jstate[g] = jopt[g].update({k: jnp.asarray(v) for k, v in grads[g].items()},
                                            jstate[g], jparams[g])
            jparams[g] = optax.apply_updates(jparams[g], upd)
            adam = jax.tree_util.tree_leaves(
                jstate[g], is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
            adam = next(s for s in adam if isinstance(s, optax.ScaleByAdamState))
            assert opt.count == int(adam.count)
            for i, n in enumerate(opt.names):
                for got, want in ((opt.params[i], jparams[g][n]), (opt.mu[i], adam.mu[n]),
                                  (opt.nu[i], adam.nu[n])):
                    want = np.asarray(want)
                    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                               atol=1e-6 * np.abs(want).max(),
                                               err_msg=f"{g} {n}")


@pytest.mark.parametrize("grad_norm", [12.0, 40.0, 95.0])
def test_clip_is_optax_rule(grad_norm):
    """Scaled only at ‖g‖ ≥ 40, by 40/‖g‖ with no epsilon (optax's rule,
    not ``clip_grad_norm_``'s ``‖g‖ + 1e-6``)."""
    rng = np.random.default_rng(2)
    tree = _grads(rng, grad_norm)["vln"]
    got = clip_by_global_norm([torch.from_numpy(v) for v in tree.values()], 40.0)
    want, _ = optax.clip_by_global_norm(40.0).update(
        {k: jnp.asarray(v) for k, v in tree.items()}, optax.EmptyState())
    for g, k in zip(got, tree):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-8)
    norm = float(global_norm(got))
    np.testing.assert_allclose(norm, min(grad_norm, 40.0), rtol=1e-5)
    np.testing.assert_allclose(
        float(global_norm([torch.from_numpy(v) for v in tree.values()])),
        float(optax.global_norm({k: jnp.asarray(v) for k, v in tree.items()})), rtol=1e-6)

