"""The port's bf16 towers against the JAX package's bf16 modules, on the CPU.

Each tower (BERT, the BN-folded Darknet, the ET trunk with float32 and with
bfloat16 history frames — the step loop's and the fused path's inputs) runs
with ``dtype=bfloat16`` on both sides from the same float32 weights (carried
across by ``compat/from_jax.py``; the state dicts load unchanged). The port
computes as XLA computes the flax modules in bfloat16 (each op rounded,
except ops whose result is promoted to float32 at once), so:

* every output is within 2e-2 of the JAX bf16 output, relative to the
  output's largest magnitude (a few bfloat16 ulps: float32 sums in another
  order flip a rounding now and then, and a flip propagates);
* on average the port is at least 4× closer to JAX's bf16 output than JAX's
  own float32 output is — the roundings are the JAX package's, not just any
  bf16 roundings.

The whole bf16 nav-eval rollout is held the same way, on the mean over its
closed-loop steps (``test_student_rollout_bf16_follows_jax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avdn_tpu.models.bert import BertConfig as JBertConfig
from avdn_tpu.models.bert import BertLanguageEncoder as JBert
from avdn_tpu.models.darknet import Darknet as JDarknet
from avdn_tpu.models.darknet import DarknetConfig as JDarknetConfig
from avdn_tpu.models.darknet import fold_darknet_params as jfold
from avdn_tpu.models.et import ETConfig as JETConfig
from avdn_tpu.models.et import HAATransformer as JET
from avdn_tpu_torch.compat import from_jax
from avdn_tpu_torch.models.bert import BertConfig, BertLanguageEncoder
from avdn_tpu_torch.models.darknet import Darknet, DarknetConfig, fold_darknet_params
from avdn_tpu_torch.models.et import ETConfig, HAATransformer
from avdn_tpu_torch.ops.saliency import saliency_upsample
from avdn_tpu_torch.rollout.engine import RGB_MEAN, RGB_STD
from test_torch_models import dk_vars

BF = jnp.bfloat16
REL_TOL = 2e-2     # of the output's largest magnitude
CLOSER = 4.0       # port↔JAX-bf16 mean gap × CLOSER ≤ JAX-bf16↔JAX-fp32 gap


def _load(model, sd):
    model.load_state_dict({k: torch.as_tensor(np.array(v)) for k, v in sd.items()},
                          strict=True)
    return model.eval()


def _check(name, got, want16, want32):
    got = got.float().numpy()
    want16 = np.asarray(want16, np.float32)
    want32 = np.asarray(want32, np.float32)
    scale = np.abs(want16).max()
    assert np.abs(got - want16).max() <= REL_TOL * scale, name
    gap = np.abs(got - want16).mean()
    assert gap * CLOSER <= np.abs(want16 - want32).mean(), (name, gap)


def test_bert_bf16_matches_jax():
    cfg = JBertConfig(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
                      intermediate_size=128, max_position=128)
    ids = np.random.default_rng(0).integers(0, 1024, (3, 16)).astype(np.int32)
    mask = np.ones((3, 16), np.int32)
    mask[1, 9:] = 0
    mask[2, 4:] = 0
    v = jax.jit(JBert(cfg).init)(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))
    want16 = jax.jit(JBert(cfg, dtype=BF).apply)(v, jnp.asarray(ids), jnp.asarray(mask))
    want32 = jax.jit(JBert(cfg).apply)(v, jnp.asarray(ids), jnp.asarray(mask))
    pcfg = BertConfig(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
                      intermediate_size=128, max_position=128)
    model = _load(BertLanguageEncoder(pcfg, torch.bfloat16), from_jax.bert_state_dict(v, 2))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    for name, g, w16, w32 in zip(("features", "head49", "pooled"), got, want16, want32):
        assert g.dtype == torch.bfloat16
        _check(name, g, w16, w32)


def test_folded_darknet_bf16_matches_jax():
    jcfg, cfg = JDarknetConfig.tiny(), DarknetConfig.tiny()
    _, v = dk_vars(jcfg, 4)
    jparams = jfold(jcfg, v["params"], v["batch_stats"], input_std=np.asarray(RGB_STD))
    x = (np.random.default_rng(5).uniform(0, 255, (2, 224, 224, 3)).astype(np.float32)
         - np.asarray(RGB_MEAN, np.float32))
    want16 = jax.jit(lambda p, x: JDarknet(jcfg, dtype=BF, folded=True).apply(
        {"params": p}, x))(jparams, jnp.asarray(x))
    want32 = jax.jit(lambda p, x: JDarknet(jcfg, folded=True).apply(
        {"params": p}, x))(jparams, jnp.asarray(x))
    base = _load(Darknet(cfg), from_jax.darknet_state_dict(v, jcfg.block_dicts()))
    model = _load(Darknet(cfg, folded=True, dtype=torch.bfloat16),
                  fold_darknet_params(cfg, base.state_dict(), input_std=RGB_STD))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    _check("darknet", got, want16, want32)


@pytest.mark.parametrize("frames_bf16", [False, True], ids=["step_frames_f32",
                                                            "fused_frames_bf16"])
def test_et_trunk_bf16_matches_jax(frames_bf16):
    """Language inputs are bf16 (BERT's outputs); the history frames are
    float32 in the step loop's buffer and bf16 in the fused path."""
    jcfg = JETConfig(demb=64, encoder_heads=4, encoder_layers=2)
    rng = np.random.default_rng(1)
    B, L, T, C = 4, 10, 5, 16
    inputs = [rng.normal(0, 1, (B, L, 64)).astype(np.float32),
              rng.normal(0, 1, (B, 49)).astype(np.float32),
              rng.normal(0, 1, (B, T, C, 49)).astype(np.float32),
              rng.normal(0, 1, (B, T, 2)).astype(np.float32)]
    lengths = np.array([1, 3, 5, 2], np.int32)
    v = jax.jit(JET(jcfg).init)(jax.random.PRNGKey(2), *map(jnp.asarray, inputs),
                                jnp.asarray(lengths))
    bf_idx = (0, 1, 2) if frames_bf16 else (0, 1)
    jin = [jnp.asarray(a, BF) if i in bf_idx else jnp.asarray(a) for i, a in enumerate(inputs)]

    def run16(v, *a):
        action, sal = JET(jcfg, dtype=BF).apply(v, *a)
        # the rollouts promote both outputs to float32 at once
        return action.astype(jnp.float32), sal.astype(jnp.float32)

    want16 = jax.jit(run16)(v, *jin, jnp.asarray(lengths))
    want32 = jax.jit(JET(jcfg).apply)(v, *(a.astype(jnp.float32) for a in jin),
                                      jnp.asarray(lengths))
    model = _load(HAATransformer(ETConfig(demb=64, encoder_heads=4, encoder_layers=2),
                                 torch.bfloat16), from_jax.et_state_dict(v, 2))
    pin = [torch.from_numpy(np.array(a.astype(jnp.float32))) for a in jin]
    pin = [t.bfloat16() if i in bf_idx else t for i, t in enumerate(pin)]
    with torch.no_grad():
        action, x8 = model(*pin, torch.from_numpy(lengths).long())
        sal = saliency_upsample(x8)
    _check("action", action, want16[0], want32[0])
    _check("saliency", sal, want16[1], want32[1])


def test_student_rollout_bf16_follows_jax(tmp_path):
    """The whole bf16 nav eval (the two-pass render, the folded Darknet,
    BERT, the trunk, the heads and the casts between them) against JAX's at
    the same batch layout: the 16 val_seen fixture items in one batch, T = 5,
    random weights with randomised BatchNorm statistics. Stop steps equal;
    over all steps the port's mean gap to JAX's bf16 waypoints, altitudes
    and progress is at most half of JAX's own float32-to-bf16 gap. Step by
    step the closed loop is chaotic (a flipped bf16 rounding in one step's
    towers moves the next view), so the check is on the mean. A port that
    ran a tower in float32, or rounded at other points, sits about as far
    from JAX's bf16 run as JAX's float32 run does."""
    import json
    import os

    from avdn_tpu.serve import Navigator as JaxNavigator
    from avdn_tpu.train.loop import build_models as jax_build
    from avdn_tpu.train.loop import eval_config_from_args as jax_cfg
    from avdn_tpu.train.loop import resolve_render_crop
    from avdn_tpu.train.step import make_eval_rollout as jax_rollout
    from avdn_tpu_torch.train.loop import build_models, eval_config_from_args
    from avdn_tpu_torch.train.step import make_eval_rollout
    from fixtures import write_fixture_dataset
    from test_e2e_loop import TINY_DARKNET_CFG, make_args
    from test_torch_rollout import both_batches, jax_models, port_args, port_weights

    root = write_fixture_dataset(str(tmp_path / "data"))
    cfg_path = str(tmp_path / "tiny_yolo.cfg")
    with open(cfg_path, "w") as f:
        f.write(TINY_DARKNET_CFG)
    args = resolve_render_crop(make_args(
        root, str(tmp_path / "out"), cfg_path, render_twopass=True, render_crop=0,
        bf16=True, fused_teacher=False, max_action_len=5))
    pargs = port_args(args)
    cfg = jax_cfg(args)
    _, models32, state = jax_models(args)
    pmodels = build_models(pargs, torch.device("cpu"), bf16=True)
    from_jax.load_agent_weights(pmodels, port_weights(state, models32[1], args))
    with open(os.path.join(root, "AVDN", "annotations", "val_seen_data.json")) as f:
        items = [JaxNavigator._normalize_item(it) for it in json.load(f)]
    assert len(items) == 16
    (jarr, jb, _), (parr, pb, _) = both_batches(args, pargs, items)

    def run_jax(models):
        fn = jax.jit(jax_rollout(cfg, *models, teacher=False))
        return jax.device_get(fn(state, jarr, jb, jax.random.PRNGKey(1)))

    j16 = run_jax(jax_build(args, bf16=True))
    j32 = run_jax(models32)
    got = make_eval_rollout(eval_config_from_args(pargs), *pmodels, teacher=False)(
        parr, pb, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(got.alive_post.numpy(), np.asarray(j16.alive_post))
    for name in ("actions_wp", "actions_alt", "pred_progress"):
        want16, want32 = np.asarray(getattr(j16, name)), np.asarray(getattr(j32, name))
        gap = np.abs(getattr(got, name).float().numpy() - want16).mean()
        print(f"{name}: port vs JAX bf16 {gap:.4e}, JAX fp32 vs bf16 "
              f"{np.abs(want32 - want16).mean():.4e}")
        assert gap * 2 <= np.abs(want32 - want16).mean(), (name, gap)
