"""The port's saliency statistics and losses against the JAX package's, on
the CPU.

The CUDA kernel cannot run here: on CPU tensors the wrapper takes its plain
version, which is what these tests hold against ``saliency_stats_xla`` and
the Pallas kernel in interpret mode (inputs of tests/test_saliency_pallas.py
plus a constant-prediction item). Tolerances: the stats at rtol 2e-5 /
atol 1e-2 (fp32 reduction order over 50,176 values, the bar of
tests/test_saliency_pallas.py), the reductions and losses within 1e-4. The
kernel itself is held against the plain version on the card (the ``cuda``
test below, and chip_smoke.py phase 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avdn_tpu.ops import losses as jax_losses
from avdn_tpu.ops.saliency_pallas import (
    saliency_reductions as jax_reductions,
    saliency_stats_pallas,
    saliency_stats_xla,
)
from avdn_tpu_torch.ops import losses
from avdn_tpu_torch.ops.saliency import (
    saliency_reductions,
    saliency_stats,
    saliency_stats_plain,
)


@pytest.fixture(scope="module")
def maps():
    rng = np.random.default_rng(0)
    B = 4
    pred = rng.normal(0.3, 0.4, (B, 224, 224)).astype(np.float32)
    gt = (rng.uniform(0, 1, (B, 224, 224)) > 0.85).astype(np.float32)
    gt[2] = 0.0  # empty fixation item
    pred[1] = 0.25  # constant prediction: zero std
    return pred, gt


@pytest.mark.parametrize("ref", ["xla", "pallas_interpret"])
def test_plain_stats_match_jax(maps, ref):
    pred, gt = maps
    if ref == "xla":
        want = saliency_stats_xla(jnp.asarray(pred), jnp.asarray(gt))
    else:
        want = saliency_stats_pallas(jnp.asarray(pred), jnp.asarray(gt),
                                     interpret=True)
    got = saliency_stats_plain(torch.from_numpy(pred), torch.from_numpy(gt))
    assert got.shape == (4, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-2)


@pytest.mark.parametrize("nss_r", [0, 1, -1])
def test_reductions_match_jax(maps, nss_r):
    pred, gt = maps
    want = [np.asarray(x) for x in jax_reductions(
        jnp.asarray(pred), jnp.asarray(gt), nss_r=nss_r, use_pallas=False)]
    got = [x.numpy() for x in saliency_reductions(
        torch.from_numpy(pred), torch.from_numpy(gt), nss_r=nss_r)]
    np.testing.assert_array_equal(got[1], want[1])
    assert not got[1][1] and not got[1][2]  # constant prediction, empty GT
    m = want[1]
    np.testing.assert_allclose(got[0][m], want[0][m], atol=1e-4)
    np.testing.assert_allclose(got[2], want[2], atol=1e-4)
    np.testing.assert_allclose(got[3], want[3], atol=1e-4)


def test_wrapper_takes_plain_path_on_cpu(maps):
    pred, gt = (torch.from_numpy(x) for x in maps)
    before = saliency_stats.launches
    got = saliency_stats(pred, gt)
    assert saliency_stats.launches == before
    torch.testing.assert_close(got, saliency_stats_plain(pred, gt), rtol=0, atol=0)


def test_wrapper_rejects_mixed_devices(maps):
    pred = torch.from_numpy(maps[0])
    with pytest.raises(ValueError, match="CUDA"):
        saliency_stats(pred, torch.empty(pred.shape, device="meta"))


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    pred = rng.normal(0.2, 0.5, (3, 224, 224)).astype(np.float32)
    gt = (rng.uniform(0, 1, (3, 224, 224)) > 0.9).astype(np.float32)
    gt[1] = 0.0
    for nss_r in (0, 1, -1):
        want, want_valid = jax_losses.nss_loss(jnp.asarray(pred), jnp.asarray(gt), nss_r)
        got, valid = losses.nss_loss(torch.from_numpy(pred), torch.from_numpy(gt), nss_r)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
        m = np.asarray(want_valid)
        np.testing.assert_allclose(got.numpy()[m], np.asarray(want)[m], atol=1e-4)
    wp, gwp = (rng.normal(0, 0.7, (6, 2)).astype(np.float32) for _ in range(2))
    gwp[0] = 0.0  # stop target
    alt, galt, prog, gprog = (rng.uniform(0, 1, 6).astype(np.float32) for _ in range(4))
    eps = (1e-5 * rng.uniform(0, 1, 6)).astype(np.float32)
    np.testing.assert_allclose(
        losses.heading_of(torch.from_numpy(wp), torch.from_numpy(eps)).numpy(),
        np.asarray(jax_losses.heading_of(jnp.asarray(wp), jnp.asarray(eps))),
        atol=1e-5)
    args = [wp, alt, prog, gwp, galt, gprog, eps]
    want = jax_losses.step_losses(*(jnp.asarray(a) for a in args))
    got = losses.step_losses(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(maps):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    pred, gt = (torch.from_numpy(x).cuda() for x in maps)
    before = saliency_stats.launches
    got = saliency_stats(pred, gt)
    torch.cuda.synchronize()
    assert saliency_stats.launches == before + 1
    torch.testing.assert_close(got, saliency_stats_plain(pred, gt), rtol=2e-5, atol=1e-2)
