"""The port's incremental KV decode of the ET trunk (``--et_decode_trunk``)
against the JAX package's, on the CPU.

* A ``decode_step`` chain (language cache once, then one step per history
  position, items ending mid-episode) equals the JAX package's chain and
  the port's own full re-encode (the module at each step's history) within
  1e-5, actions and saliency.
* ``_attend_two`` equals ``_attend`` over the concatenated sources within
  1e-5; a fully masked row gives 0; a +inf logit on a masked position
  (possible in bf16) does not poison the row with NaN.
* In bf16 the decode follows the module within bf16 tolerance (0.02).
* In the eval rollout, the student and the teacher step loops with the
  decode trunk equal the JAX package's decode rollouts (stop flags
  identical, actions within 1e-4 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avdn_tpu.models import et_fast as jet_fast
from avdn_tpu.models.et import ETConfig as JETConfig
from avdn_tpu.models.et import HAATransformer as JET
from avdn_tpu_torch.compat import from_jax
from avdn_tpu_torch.models import et_fast
from avdn_tpu_torch.models.et import ETConfig, HAATransformer
from avdn_tpu_torch.ops.saliency import saliency_upsample

TOL = 1e-5


def _ragged(B=3, T=4, L=7, C=8, D=64, seed=0):
    rng = np.random.default_rng(seed)
    lang = rng.normal(size=(B, L, D)).astype(np.float32)
    lang_cls = rng.normal(size=(B, 49)).astype(np.float32)
    frames = rng.normal(size=(B, T, C, 49)).astype(np.float32)
    dirs = rng.normal(size=(B, T, 2)).astype(np.float32)
    # item 0 alive throughout; item 1 ends after step 1; item 2 after step 0
    alive = np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0], [1, 0, 0]], bool)[:T, :B]
    lengths = np.cumsum(alive, axis=0).astype(np.int32)
    return lang, lang_cls, frames, dirs, lengths


@pytest.fixture(scope="module")
def models():
    jcfg = JETConfig(demb=64, encoder_heads=4, encoder_layers=2)
    lang, lang_cls, frames, dirs, lengths = _ragged()
    v = jax.jit(JET(jcfg).init)(jax.random.PRNGKey(0), *map(jnp.asarray, (
        lang, lang_cls, frames, dirs, lengths[-1])))
    sd = {k: torch.as_tensor(np.array(x)) for k, x in from_jax.et_state_dict(v, 2).items()}

    def port(dtype):
        m = HAATransformer(ETConfig(demb=64, encoder_heads=4, encoder_layers=2), dtype)
        m.load_state_dict(sd, strict=True)
        return m.eval()

    return jcfg, v, port


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_decode_chain_matches_jax_and_full_reencode(models):
    jcfg, v, port = models
    model = port(torch.float32)
    lang, lang_cls, frames, dirs, lengths = _ragged()
    B, T = frames.shape[:2]
    jkv = jet_fast.make_lang_cache(v, jcfg, jnp.asarray(lang))
    jcache = jet_fast.init_cache(jcfg, B, T)
    pkv = et_fast.make_lang_cache(model, torch.from_numpy(lang))
    pcache = et_fast.init_cache(model.cfg, B, T)
    tl, tc, tf, td = _t(lang, lang_cls, frames, dirs)
    with torch.no_grad():
        for t in range(T):
            jcache, ja, js = jet_fast.decode_step(
                v, jcfg, jkv, jcache, jnp.asarray(lang_cls), jnp.asarray(frames[:, t]),
                jnp.asarray(dirs[:, t]), jnp.int32(t), jnp.asarray(lengths[t]))
            pcache, pa, ps = et_fast.decode_step(
                model, pkv, pcache, tc, tf[:, t], td[:, t], t,
                torch.from_numpy(lengths[t]).long())
            keep = torch.arange(T) <= t
            fa, fs = model(tl, tc, torch.where(keep[None, :, None, None], tf, 0.0),
                           torch.where(keep[None, :, None], td, 0.0),
                           torch.from_numpy(lengths[t]).long())
            ps, fs = saliency_upsample(ps), saliency_upsample(fs)
            for got, want, name in ((pa, np.asarray(ja), "action vs JAX"),
                                    (ps, np.asarray(js), "saliency vs JAX"),
                                    (pa, fa.numpy(), "action vs re-encode"),
                                    (ps, fs.numpy(), "saliency vs re-encode")):
                np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL,
                                           err_msg=f"{name}, step {t}")


def test_decode_bf16_follows_the_bf16_module(models):
    _, _, port = models
    model = port(torch.bfloat16)
    lang, lang_cls, frames, dirs, lengths = _ragged()
    B, T = frames.shape[:2]
    tl, tc, tf, td = _t(lang, lang_cls, frames, dirs)
    tl, tc = tl.bfloat16(), tc.bfloat16()
    with torch.no_grad():
        kv = et_fast.make_lang_cache(model, tl, dtype=torch.bfloat16)
        cache = et_fast.init_cache(model.cfg, B, T, dtype=torch.bfloat16)
        for t in range(T):
            cache, a, _ = et_fast.decode_step(model, kv, cache, tc, tf[:, t], td[:, t], t,
                                              torch.from_numpy(lengths[t]).long(),
                                              dtype=torch.bfloat16)
        ref, _ = model(tl, tc, tf, td, torch.from_numpy(lengths[-1]).long())
    np.testing.assert_allclose(a.float().numpy(), ref.float().numpy(), atol=0.02, rtol=0.02)


def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def test_attend_two_matches_concat_attend():
    B, H, Q, K1, K2, hd = 2, 3, 5, 7, 4, 8
    q = _rand((B, H, Q, hd), 0)
    k1, v1 = _rand((B, H, K1, hd), 1), _rand((B, H, K1, hd), 2)
    k2, v2 = _rand((B, H, K2, hd), 3), _rand((B, H, K2, hd), 4)
    bias1 = torch.where(torch.from_numpy(np.random.default_rng(5).random((B, 1, Q, K1)) < 0.3),
                        float("-inf"), 0.0)
    bias2 = torch.zeros((B, 1, Q, K2))
    got = et_fast._attend_two(q, k1, v1, bias1, k2, v2, bias2)
    ref = et_fast._attend(q, torch.cat([k1, k2], 2), torch.cat([v1, v2], 2),
                          torch.cat([bias1.expand(B, 1, Q, K1), bias2], -1))
    want = jet_fast._attend_two(*(jnp.asarray(x.numpy()) for x in (q, k1, v1, bias1, k2, v2, bias2)))
    torch.testing.assert_close(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_attend_two_fully_masked_rows_are_zero():
    B, H, Q, K, hd = 1, 2, 3, 4, 8
    q = _rand((B, H, Q, hd), 0)
    k, v = _rand((B, H, K, hd), 1), _rand((B, H, K, hd), 2)
    neg = torch.full((B, 1, Q, K), float("-inf"))
    assert torch.equal(et_fast._attend_two(q, k, v, neg, k, v, neg), torch.zeros((B, H, Q, hd)))


def test_attend_two_inf_logit_on_masked_position_no_nan():
    B, H, Q, K, hd = 1, 1, 2, 3, 4
    q = torch.full((B, H, Q, hd), 1e38)          # logits overflow to +inf
    k = torch.ones((B, H, K, hd))
    v = _rand((B, H, K, hd), 0)
    bias1 = torch.tensor([[[[float("-inf"), 0.0, 0.0]] * Q]])
    k2 = torch.zeros((B, H, K, hd))
    v2 = _rand((B, H, K, hd), 1)
    out = et_fast._attend_two(q, k, v, bias1, k2, v2, torch.zeros((B, 1, Q, K)))
    assert torch.isfinite(out).all()


@pytest.fixture(scope="module")
def rollout_setup(tmp_path_factory):
    import json
    import os

    from avdn_tpu.serve import Navigator as JaxNavigator
    from fixtures import write_fixture_dataset
    from test_e2e_loop import TINY_DARKNET_CFG, make_args
    from test_torch_rollout import (N_ITEMS, T_STEPS, both_batches, jax_models,
                                    port_args, port_models, port_weights)

    root = write_fixture_dataset(str(tmp_path_factory.mktemp("decode")))
    out = str(tmp_path_factory.mktemp("out"))
    cfg_path = os.path.join(out, "tiny_yolo.cfg")
    with open(cfg_path, "w") as f:
        f.write(TINY_DARKNET_CFG)
    args = make_args(root, out, cfg_path, render_twopass=False, bf16=False,
                     fused_teacher=False, et_decode_trunk=True, max_action_len=T_STEPS)
    pargs = port_args(args)
    cfg, jmodels, state = jax_models(args)
    pmodels = port_models(pargs, port_weights(state, jmodels[1], args))
    raw = json.load(open(os.path.join(root, "AVDN", "annotations", "val_seen_data.json")))
    items = [JaxNavigator._normalize_item(it) for it in raw[:N_ITEMS]]
    return args, pargs, cfg, jmodels, state, pmodels, both_batches(args, pargs, items)


@pytest.mark.parametrize("teacher", [False, True], ids=["student", "teacher"])
def test_decode_rollout_matches_jax(rollout_setup, teacher):
    from avdn_tpu.train.step import make_eval_rollout as jax_rollout
    from avdn_tpu_torch.train.loop import eval_config_from_args
    from avdn_tpu_torch.train.step import make_eval_rollout
    from test_torch_rollout import assert_rollouts_match

    args, pargs, cfg, jmodels, state, pmodels, (jside, pside) = rollout_setup
    assert cfg.et_decode_trunk
    jout = jax.device_get(jax.jit(jax_rollout(cfg, *jmodels, teacher=teacher,
                                              collect_ha=teacher))(
        state, jside[0], jside[1], jax.random.PRNGKey(1)))
    pcfg = eval_config_from_args(pargs)
    assert pcfg.et_decode_trunk and not pcfg.fused_teacher
    pout = make_eval_rollout(pcfg, *pmodels, teacher=teacher, collect_ha=teacher)(
        pside[0], pside[1], torch.Generator().manual_seed(1))
    assert_rollouts_match(jout, pout, ha=teacher)
    # and the port's decode equals its own full re-encode
    full = make_eval_rollout(dataclasses.replace(pcfg, et_decode_trunk=False), *pmodels,
                             teacher=teacher, collect_ha=teacher)(
        pside[0], pside[1], torch.Generator().manual_seed(1))
    assert torch.equal(full.alive_post, pout.alive_post)
    torch.testing.assert_close(full.actions_wp, pout.actions_wp, rtol=1e-4, atol=1e-5)
