"""The port's saliency statistics, reductions and losses against the JAX
package's, on the CPU.

The CUDA kernel cannot run here: on CPU tensors the wrappers take their
plain versions, which is what these tests hold against ``saliency_stats_xla``
/ ``saliency_reductions`` and the Pallas kernel in interpret mode (inputs of
tests/test_saliency_pallas.py plus a constant-prediction item). Tolerances:
the stats at rtol 2e-5 / atol 1e-2 (fp32 reduction order over 50,176
values, the bar of tests/test_saliency_pallas.py), valid flags equal, the
reductions and losses within 1e-4. The kernel's slice bounds and cluster
size are plain Python and are checked here; the kernel itself is held
against the plain version on the card (the ``cuda`` tests below, and
chip_smoke.py phase 3).

The gradient of −NSS: autograd through ``saliency_reductions`` (its plain
version on the CPU) against ``jax.grad`` of the JAX reductions with
``use_pallas=False`` (the JAX package's train path), through the loss's
``where(valid, −NSS, 0)`` with random item weights, for every ``nss_r``:
within 1e-5 of the largest gradient. An item with Σg = 0 gets 0 on both
sides; an item with a constant prediction (std = 0) gets NaN from XLA's
autodiff (0·∞ through the square root's derivative) and exactly 0 from the
port. The gradient down to the saliency head, and its kernel
(``csrc/saliency_head_grad.cu``), are held in ``test_torch_saliency_head.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avdn_tpu.ops.saliency_pallas as jax_saliency
from avdn_tpu.ops import losses as jax_losses
from avdn_tpu.ops.saliency_pallas import (
    saliency_reductions as jax_reductions,
    saliency_stats_pallas,
    saliency_stats_xla,
)
from avdn_tpu_torch.ops import losses
from avdn_tpu_torch.ops.saliency import (
    MAX_CLUSTER,
    RESIDENT_BLOCKS_PER_SM,
    cluster_size,
    saliency_fused,
    saliency_nss_grad_plain,
    saliency_reductions,
    saliency_reductions_plain,
    saliency_stats,
    saliency_stats_plain,
)

H100_SMS = 132


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


def _assert_reductions_equal(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    m = want[1]
    np.testing.assert_allclose(got[0][m], want[0][m], atol=1e-4)
    np.testing.assert_allclose(got[2], want[2], atol=1e-4)
    np.testing.assert_allclose(got[3], want[3], atol=1e-4)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("nss_r", [0, 1, -1])
@pytest.mark.parametrize("ref", ["xla", "pallas_interpret"])
def test_plain_reductions_match_jax(maps, ref, nss_r, B, monkeypatch):
    """B = 4 holds the constant-prediction (item 1) and empty-GT (item 2)
    items; B = 1 an ordinary one."""
    pred, gt = maps[0][:B], maps[1][:B]
    if ref == "xla":
        out = jax_reductions(jnp.asarray(pred), jnp.asarray(gt), nss_r=nss_r,
                             use_pallas=False)
    else:  # the JAX formulas over the Pallas kernel's stats, eagerly
        monkeypatch.setattr(jax_saliency, "saliency_stats_pallas", functools.partial(
            saliency_stats_pallas, interpret=True))
        out = jax_reductions.__wrapped__(jnp.asarray(pred), jnp.asarray(gt),
                                         nss_r=nss_r, use_pallas=True)
    want = [np.asarray(x) for x in out]
    got = [x.numpy() for x in saliency_reductions_plain(
        torch.from_numpy(pred), torch.from_numpy(gt), nss_r=nss_r)]
    _assert_reductions_equal(got, want)
    if B == 4:
        assert want[1][0] and not want[1][1] and not want[1][2]


def cluster_slices(n4, cluster):
    """Mirror of the kernel's slice bounds (csrc/saliency_stats.cu): rank r
    reduces the float4s [r·n4/C, (r+1)·n4/C) of its item."""
    return [(r * n4 // cluster, (r + 1) * n4 // cluster) for r in range(cluster)]


@pytest.mark.parametrize("n4", [12544, 3136, 784, 13, 1])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_cluster_slices_cover_every_float4_once(cluster, n4):
    slices = cluster_slices(n4, cluster)
    assert len(slices) == cluster
    assert slices[0][0] == 0 and slices[-1][1] == n4
    for (_, hi), (lo, _) in zip(slices, slices[1:]):
        assert hi == lo
    covered = np.concatenate([np.arange(lo, hi) for lo, hi in slices])
    np.testing.assert_array_equal(covered, np.arange(n4))
    sizes = [hi - lo for lo, hi in slices]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("B", [1, 3, 8, 16, 80, 132, 240, 264, 600])
def test_cluster_size_fills_the_sms(B):
    c = cluster_size(B, H100_SMS)
    wave = RESIDENT_BLOCKS_PER_SM * H100_SMS
    assert c & (c - 1) == 0 and 1 <= c <= MAX_CLUSTER
    if c == MAX_CLUSTER:
        # the largest clusters only while their grid covers at most half the SMs
        assert B * c <= H100_SMS // 2
    else:
        # else the largest C below it whose grid fits one wave of resident
        # blocks, or 1
        assert B * c <= wave or c == 1
        assert c == MAX_CLUSTER // 2 or B * 2 * c > wave
    # the fastest C measured on the H100 at B = 8, 16, 80, 240 (PERF.md)
    want = {1: 8, 3: 8, 8: 8, 16: 4, 80: 4, 132: 4, 240: 2, 264: 2, 600: 1}[B]
    assert c == want


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


@pytest.mark.parametrize("nss_r", [0, 1, -1])
def test_plain_grad_matches_jax(maps, nss_r):
    """Item 1 has a constant prediction (std = 0), item 2 no fixation
    (Σg = 0); items 0 and 3 are ordinary."""
    import jax

    pred, gt = maps
    w = np.random.default_rng(4).uniform(0.5, 1.5, pred.shape[0]).astype(np.float32)

    def jax_loss(p):
        neg, valid, _, _ = jax_reductions(p, jnp.asarray(gt), nss_r=nss_r,
                                          use_pallas=False)
        return jnp.sum(jnp.asarray(w) * jnp.where(valid, neg, 0.0))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(pred)))
    p = torch.from_numpy(pred).requires_grad_(True)
    neg, valid, prec, rec = saliency_reductions(p, torch.from_numpy(gt), nss_r)
    assert not (prec.requires_grad or rec.requires_grad or valid.requires_grad)
    (torch.from_numpy(w) * torch.where(valid, neg, 0.0)).sum().backward()
    got = p.grad.numpy()
    assert np.isnan(want[1]).all() and (got[1] == 0).all()  # std = 0
    assert (want[2] == 0).all() and (got[2] == 0).all()  # Σg = 0
    ok = [0, 3]
    np.testing.assert_allclose(got[ok], want[ok], rtol=0,
                               atol=1e-5 * np.abs(want[ok]).max())
    # the per-pixel part of the plain head gradient is that same gradient
    up = torch.from_numpy(w) * valid
    torch.testing.assert_close(
        saliency_nss_grad_plain(torch.from_numpy(pred), torch.from_numpy(gt), up, nss_r),
        p.grad, rtol=0, atol=0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _card_maps(B, hw, seed):
    rng = np.random.default_rng(seed)
    pred = rng.normal(0.3, 0.4, (B, hw, hw)).astype(np.float32)
    gt = (rng.uniform(0, 1, (B, hw, hw)) > 0.85).astype(np.float32)
    if B > 1:
        pred[1] = 0.25  # constant prediction: zero std
    if B > 2:
        gt[2] = 0.0  # empty fixation item
    return torch.from_numpy(pred).cuda(), torch.from_numpy(gt).cuda()


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(maps):
    _card()
    pred, gt = (torch.from_numpy(x).cuda() for x in maps)
    before = saliency_stats.launches
    got = saliency_stats(pred, gt)
    torch.cuda.synchronize()
    assert saliency_stats.launches == before + 1
    torch.testing.assert_close(got, saliency_stats_plain(pred, gt), rtol=2e-5, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("nss_r", [0, 1, -1])
@pytest.mark.parametrize("hw", [224, 56])
@pytest.mark.parametrize("B", [1, 3, 8, 80, 240])
def test_fused_kernel_matches_plain_on_card(B, hw, nss_r):
    _card()
    pred, gt = _card_maps(B, hw, seed=B * 1000 + hw)
    before = saliency_stats.launches
    first = saliency_fused(pred, gt, nss_r)
    second = saliency_fused(pred, gt, nss_r)
    torch.cuda.synchronize()
    assert saliency_stats.launches == before + 2
    for a, b in zip(first, second):  # deterministic: no atomics
        assert torch.equal(a, b)
    torch.testing.assert_close(first[0], saliency_stats_plain(pred, gt),
                               rtol=2e-5, atol=1e-2)
    got = [x.cpu().numpy() for x in first[1:]]
    want = [x.cpu().numpy() for x in saliency_reductions_plain(pred, gt, nss_r)]
    _assert_reductions_equal(got, want)
    red = saliency_reductions(pred, gt, nss_r)
    for a, b in zip(red, first[1:]):
        assert torch.equal(a, b)
