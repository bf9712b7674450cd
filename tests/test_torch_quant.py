"""The port's int8 Darknet tower (``--quant int8``) against the JAX
package's, on the CPU.

* ``quantize_darknet_params`` of the same folded weights: the int8 weights
  and the per-channel scales bit-equal, the bias equal.
* ``quant_forward``: within 1e-4 of the JAX tower, relative to the output's
  largest magnitude (the integer values convolve in float32; partial sums
  pass 2²⁴, so the backends' summation orders show).
* Batch invariance: an episode's features do not depend on its batch.
* The eval rollout's wiring: ``--quant int8`` without ``--fold_bn_eval`` and
  an unknown mode raise ``ValueError``; with the fold, the student rollout
  on the two-pass render runs the quantized tower and stays close to the
  float32 tower.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avdn_tpu.models.darknet import DarknetConfig as JDarknetConfig
from avdn_tpu.models.darknet import fold_darknet_params as jfold
from avdn_tpu.models.darknet_quant import quant_forward as jquant_forward
from avdn_tpu.models.darknet_quant import quantize_darknet_params as jquantize
from avdn_tpu_torch.models.darknet import DarknetConfig
from avdn_tpu_torch.models.darknet_quant import (QuantDarknet, quant_forward,
                                                 quantize_darknet_params)
from avdn_tpu_torch.rollout.engine import RGB_MEAN, RGB_STD
from test_e2e_loop import TINY_DARKNET_CFG
from test_torch_models import dk_vars

REL_TOL = 1e-4


def _port_folded(jparams):
    """The JAX package's folded params as a ``Darknet(folded=True)`` state
    dict (HWIO → OIHW)."""
    sd = {}
    for name, p in jparams.items():
        i = int(name.split("_")[1])
        sd[f"module_list.{i}.conv_{i}.weight"] = torch.from_numpy(
            np.array(p["kernel"])).permute(3, 2, 0, 1).contiguous()
        sd[f"module_list.{i}.conv_{i}.bias"] = torch.from_numpy(np.array(p["bias"]))
    return sd


@pytest.fixture(scope="module", params=["tiny", "e2e_tiny"])
def towers(request):
    text = TINY_DARKNET_CFG if request.param == "e2e_tiny" else None
    jcfg = JDarknetConfig.from_text(text) if text else JDarknetConfig.tiny()
    cfg = DarknetConfig.from_text(text) if text else DarknetConfig.tiny()
    _, v = dk_vars(jcfg, 7)
    jparams = jfold(jcfg, v["params"], v["batch_stats"], input_std=np.asarray(RGB_STD))
    return jcfg, cfg, jparams


def test_quantized_weights_bit_equal(towers):
    jcfg, cfg, jparams = towers
    want = jquantize(jcfg, jparams)
    got = quantize_darknet_params(cfg, _port_folded(jparams))
    assert sorted(got) == sorted(int(n.split("_")[1]) for n in want)
    for i, p in got.items():
        w = want[f"conv_{i}"]
        assert p["weight_q"].dtype == torch.int8
        np.testing.assert_array_equal(p["weight_q"].numpy(),
                                      np.asarray(w["kernel_q"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(p["scale"].numpy(), np.asarray(w["scale"]))
        np.testing.assert_array_equal(p["bias"].numpy(), np.asarray(w["bias"]))


def test_quant_forward_matches_jax(towers):
    jcfg, cfg, jparams = towers
    x = (np.random.default_rng(8).uniform(0, 255, (3, 224, 224, 3)).astype(np.float32)
         - np.asarray(RGB_MEAN, np.float32))
    want = np.asarray(jax.jit(lambda q, x: jquant_forward(jcfg, q, x))(
        jquantize(jcfg, jparams), jnp.asarray(x)))
    tower = QuantDarknet(cfg).eval()
    tower.qparams = quantize_darknet_params(cfg, _port_folded(jparams))
    with torch.no_grad():
        got = tower(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=REL_TOL * np.abs(want).max())


def test_quant_forward_is_batch_invariant(towers):
    _, cfg, jparams = towers
    q = quantize_darknet_params(cfg, _port_folded(jparams))
    g = torch.Generator().manual_seed(3)
    x1 = torch.randn((1, 224, 224, 3), generator=g)
    hot = 100.0 * torch.randn((1, 224, 224, 3), generator=g)
    solo = quant_forward(cfg, q, x1)
    batched = quant_forward(cfg, q, torch.cat([x1, hot]))[:1]
    torch.testing.assert_close(batched, solo, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant,fold,match", [("int8", False, "fold_bn_eval"),
                                              ("fp4", True, "fp4")])
def test_bad_quant_config_raises(quant, fold, match):
    from avdn_tpu_torch.models.darknet import Darknet
    from avdn_tpu_torch.train.step import TrainConfig, make_eval_rollout

    cfg = TrainConfig(quant=quant, fold_bn_eval=fold)
    with pytest.raises(ValueError, match=match):
        make_eval_rollout(cfg, None, Darknet(DarknetConfig.tiny()), None, teacher=False)


def test_int8_rollout_runs_the_quantized_tower(tmp_path):
    """The student rollout with ``--quant int8`` on the two-pass render: its
    tower is a ``QuantDarknet`` fed the folded weights, its outputs finite
    and its actions within 0.15 of the float32 tower's (the JAX package's
    bound, tests/test_quant.py)."""
    from test_torch_rollout import N_ITEMS, both_batches, jax_models, port_args
    from test_torch_rollout import port_models, port_weights
    import json
    import os

    from avdn_tpu.serve import Navigator as JaxNavigator
    from avdn_tpu_torch.train.loop import eval_config_from_args
    from avdn_tpu_torch.train.step import make_eval_rollout
    from fixtures import write_fixture_dataset
    from test_e2e_loop import make_args

    root = write_fixture_dataset(str(tmp_path / "data"))
    cfg_path = str(tmp_path / "tiny.cfg")
    with open(cfg_path, "w") as f:
        f.write(TINY_DARKNET_CFG)
    args = make_args(root, str(tmp_path / "out"), cfg_path, render_twopass=True,
                     render_crop=256, bf16=False, max_action_len=3)
    pargs = port_args(args)
    _, models, state = jax_models(args)
    pmodels = port_models(pargs, port_weights(state, models[1], args))
    raw = json.load(open(os.path.join(root, "AVDN", "annotations", "val_seen_data.json")))
    items = [JaxNavigator._normalize_item(it) for it in raw[:N_ITEMS]]
    _, (parr, pb, _) = both_batches(args, pargs, items)
    outs = {}
    for quant in ("none", "int8"):
        cfg = dataclasses.replace(eval_config_from_args(pargs), quant=quant)
        fn = make_eval_rollout(cfg, *pmodels, teacher=False)
        outs[quant] = fn(parr, pb, torch.Generator().manual_seed(0))
    assert torch.isfinite(outs["int8"].actions_wp).all()
    assert (outs["int8"].actions_wp - outs["none"].actions_wp).abs().max() < 0.15
    assert not torch.equal(outs["int8"].actions_wp, outs["none"].actions_wp)
