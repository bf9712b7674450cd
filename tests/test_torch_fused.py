"""The port's time-fused teacher rollout against the JAX package's, on the
CPU at tiny width (BERT 2×64, the tiny Darknet, trunk 1 layer, B = 4,
T = 5).

* ``teacher_onepass``: the port's one-pass trunk against
  ``avdn_tpu.models.et_fast.teacher_onepass`` on seeded numpy inputs, with
  items that end at different steps and with all items ended before T;
  within 1e-5.
* The fused HA eval (``make_eval_rollout(teacher=True, collect_ha=True)``
  with ``fused_teacher``) against the JAX one, with ``fast_eval_trunk`` on
  and off, and with ``collect_debug`` (views, pred/GT saliency). Tolerances
  of ``tests/test_torch_rollout.py``: stops identical; actions, progress and
  corners within 1e-4 relative; HA precision, recall and NSS within 1e-4;
  the loss within 1e-4 relative. Views within 1e-3 on the 0–255 scale, GT
  saliency equal, predicted saliency within 1e-4.
* The port's fused rollout against its own step-by-step teacher rollout
  (same tolerances; both draw the loss's jitter from the same generator).
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
from test_torch_rollout import (
    assert_rollouts_match,
    both_batches,
    jax_models,
    port_args,
    port_models,
    port_weights,
)

T_STEPS = 5
N_ITEMS = 4

# cumulative alive counts (T, B) per step: items ending at different steps
# (one alive throughout), and every item ended before T
LENGTHS = {
    "ragged": [[1, 1, 1, 1], [2, 2, 1, 2], [3, 2, 1, 3], [4, 2, 1, 3], [5, 2, 1, 3]],
    "all_end_early": [[1, 1, 1, 1], [2, 2, 1, 2], [3, 2, 1, 3], [3, 2, 1, 3],
                      [3, 2, 1, 3]],
}


@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_teacher_onepass_matches_jax(case):
    import jax.numpy as jnp

    from avdn_tpu.models import et_fast as jax_et_fast
    from avdn_tpu.models.et import ETConfig as JaxETConfig
    from avdn_tpu.models.et import HAATransformer as JaxHAA
    from avdn_tpu_torch.compat.from_jax import et_state_dict
    from avdn_tpu_torch.models.et import ETConfig, HAATransformer
    from avdn_tpu_torch.models.et_fast import teacher_onepass
    from avdn_tpu_torch.ops.saliency import saliency_upsample

    B, T, L, C, D = N_ITEMS, T_STEPS, 7, 8, 64
    rng = np.random.default_rng(0)
    lang = rng.normal(size=(B, L, D)).astype(np.float32)
    lang_cls = rng.normal(size=(B, 49)).astype(np.float32)
    frames = rng.normal(size=(B, T, C, 49)).astype(np.float32)
    dirs = rng.normal(size=(B, T, 2)).astype(np.float32)
    lengths = np.asarray(LENGTHS[case], np.int32)

    jcfg = JaxETConfig(demb=D, encoder_heads=4, encoder_layers=1)
    params = JaxHAA(jcfg).init(jax.random.PRNGKey(0), jnp.asarray(lang),
                               jnp.asarray(lang_cls), jnp.asarray(frames),
                               jnp.asarray(dirs), jnp.asarray(lengths[-1]))
    ja, js = jax_et_fast.teacher_onepass(params, jcfg, lang, lang_cls, frames, dirs,
                                         jnp.asarray(lengths))

    model = HAATransformer(ETConfig(demb=D, encoder_heads=4, encoder_layers=1)).eval()
    model.load_state_dict({k: torch.as_tensor(np.array(v)) for k, v in
                           et_state_dict(params, 1).items()}, strict=True)
    with torch.inference_mode():
        pa, x8 = teacher_onepass(model, *(torch.from_numpy(a) for a in
                                          (lang, lang_cls, frames, dirs)),
                                 torch.from_numpy(lengths.astype(np.int64)))
        assert x8.shape == (T, B, 8, 8)
        ps = saliency_upsample(x8.reshape(T * B, 8, 8)).reshape(T, B, 224, 224)
    assert pa.shape == (T, B, 4) and ps.shape == (T, B, 224, 224)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from avdn_tpu.serve import Navigator as JaxNavigator

    root = write_fixture_dataset(str(tmp_path_factory.mktemp("torch_fused")))
    out = str(tmp_path_factory.mktemp("out"))
    cfg_path = os.path.join(out, "tiny_yolo.cfg")
    with open(cfg_path, "w") as f:
        f.write(TINY_DARKNET_CFG)
    args = make_args(root, out, cfg_path, render_twopass=False, bf16=False,
                     fused_teacher=True, max_action_len=T_STEPS)
    pargs = port_args(args)
    cfg, models, state = jax_models(args)
    pmodels = port_models(pargs, port_weights(state, models[1], args))
    raw = json.load(open(os.path.join(root, "AVDN", "annotations",
                                      "val_seen_data.json")))
    items = [JaxNavigator._normalize_item(it) for it in raw[:N_ITEMS]]
    jside, pside = both_batches(args, pargs, items)
    return dict(args=args, pargs=pargs, cfg=cfg, models=models, state=state,
                pmodels=pmodels, jside=jside, pside=pside)


def _port_cfg(setup, **over):
    from avdn_tpu_torch.train.loop import eval_config_from_args

    return dataclasses.replace(eval_config_from_args(setup["pargs"]), **over)


def run_port(setup, cfg, **kw):
    from avdn_tpu_torch.train.step import make_eval_rollout

    parr, pb, _ = setup["pside"]
    fn = make_eval_rollout(cfg, *setup["pmodels"], teacher=True, collect_ha=True, **kw)
    return fn(parr, pb, torch.Generator().manual_seed(1))


def run_jax(setup, fast, **kw):
    from avdn_tpu.train.step import make_eval_rollout as jax_rollout

    cfg = dataclasses.replace(setup["cfg"], fused_teacher=True, fast_eval_trunk=fast)
    jfn = jax.jit(jax_rollout(cfg, *setup["models"], teacher=True, collect_ha=True,
                              **kw))
    jarr, jb, _ = setup["jside"]
    return jax.device_get(jfn(setup["state"], jarr, jb, jax.random.PRNGKey(1)))


@pytest.mark.parametrize("fast", [True, False], ids=["onepass", "per_step_trunk"])
def test_fused_ha_eval_matches_jax(setup, fast):
    pout = run_port(setup, _port_cfg(setup, fused_teacher=True, fast_eval_trunk=fast))
    jout = run_jax(setup, fast)
    assert pout.actions_wp.shape == (T_STEPS, N_ITEMS, 2)
    assert_rollouts_match(jout, pout, ha=True)


def test_fused_debug_outputs_match_jax(setup):
    pout = run_port(setup, _port_cfg(setup, fused_teacher=True), collect_debug=True)
    jout = run_jax(setup, True, collect_debug=True)
    assert_rollouts_match(jout, pout, ha=True)
    assert pout.views.shape == (T_STEPS, N_ITEMS, 224, 224, 3)
    np.testing.assert_allclose(pout.views.numpy(), np.asarray(jout.views), atol=1e-3)
    np.testing.assert_array_equal(pout.gt_sal.numpy(), np.asarray(jout.gt_sal))
    np.testing.assert_allclose(pout.pred_sal.numpy(), np.asarray(jout.pred_sal),
                               atol=1e-4)


@pytest.mark.parametrize("fast", [True, False], ids=["onepass", "per_step_trunk"])
def test_fused_matches_port_step_loop(setup, fast):
    """Fused against the port's own step loop, debug outputs included."""
    fused = run_port(setup, _port_cfg(setup, fused_teacher=True, fast_eval_trunk=fast),
                     collect_debug=True)
    step = run_port(setup, _port_cfg(setup, fused_teacher=False), collect_debug=True)
    assert_rollouts_match(step, fused, ha=True)
    torch.testing.assert_close(fused.views, step.views, rtol=0, atol=0)
    torch.testing.assert_close(fused.gt_sal, step.gt_sal, rtol=0, atol=0)
    torch.testing.assert_close(fused.pred_sal, step.pred_sal, rtol=0, atol=1e-4)

