"""The port's fast render modes against the JAX package's, on the CPU.

* ``render_batch_twopass`` (float32 weights; the CPU runs bf16 as float32 in
  both packages) vs ``avdn_tpu.sim.warp2pass.render_batch_twopass`` over the
  full heading circle (the 90°/270° axis swap included), quads hanging over
  every map border and corner, and crops below, at and above the bank's size
  (the clamp): views within 1e-3 on the 0–255 scale, saliency equal.
* ``auto_render_crop`` equal to the JAX formula.
* ``render_batch(subsample=2)`` vs the JAX subsample mode: views and the
  upscaled {0, 1} saliency within 1e-3, borders included.
* The bf16 two-pass semantics the card runs (weights and pass A's result
  rounded to bfloat16, contracted in float32), run here through the same
  code: within the bounds the JAX package holds its bf16 warp to (its CPU
  runtime has no bf16 × bf16 → float32 product to run it here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avdn_tpu.sim import render as jrender
from avdn_tpu.sim import warp2pass as jwarp
from avdn_tpu_torch.sim import warp2pass
from avdn_tpu_torch.sim.render import render_batch

VIEW_TOL = 1e-3  # 0–255 scale


def _quads(rng, W, H, n_heading=24, n_border=16):
    """Quads at every heading (exactly 90° and 270° included) and quads
    hanging over each border and corner of a W×H map."""
    out = []
    for k in range(n_heading):
        th = k * 2 * np.pi / n_heading
        cx, cy = rng.uniform(0.3, 0.7) * W, rng.uniform(0.3, 0.7) * H
        r = rng.uniform(30, 120)
        ang = th + np.array([0, .5, 1, 1.5]) * np.pi
        out.append(np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], -1))
    for k in range(n_border):
        cx = [-40.0, W / 2, W + 40.0, -20.0, W + 20.0][k % 5] + rng.uniform(-10, 10)
        cy = [H / 2, -40.0, H + 40.0, -20.0, H + 20.0][(k // 2) % 5] + rng.uniform(-10, 10)
        r = rng.uniform(40, 150)
        th = rng.uniform(0, 2 * np.pi)
        ang = th + np.array([0, .5, 1, 1.5]) * np.pi + rng.uniform(-.1, .1, 4)
        out.append(np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], -1))
    return np.asarray(out, np.float32)


def _inputs(seed, M=2, H=512, W=512):
    rng = np.random.default_rng(seed)
    bank = rng.integers(0, 256, (M, H, W, 3), np.uint8)
    quads = _quads(rng, W, H)
    B = len(quads)
    idx = rng.integers(0, M, B).astype(np.int32)
    circles = np.concatenate([rng.uniform(0, W, (B, 3, 2)),
                              rng.uniform(5, 90, (B, 3, 1))], -1).astype(np.float32)
    n_circ = rng.integers(0, 4, B).astype(np.int32)
    return bank, idx, quads, circles, n_circ


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("crop", [256, 320, 1024], ids=["crop256", "crop320", "crop_clamped"])
def test_twopass_matches_jax(crop):
    """crop 320 rounds up to 384; 1024 exceeds the 512 px maps and clamps."""
    bank, idx, quads, circ, nc = _inputs(0)
    want_v, want_s = jwarp.render_batch_twopass(
        *(jnp.asarray(a) for a in (bank, idx, quads, circ, nc)), crop_hw=crop, bf16=False)
    got_v, got_s = warp2pass.render_batch_twopass(*_torch(bank, idx, quads, circ, nc),
                                                  crop_hw=crop, bf16=False)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0, atol=VIEW_TOL)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # the bf16 flag is float32 on the CPU, in both packages
    bf_v, _ = warp2pass.render_batch_twopass(*_torch(bank, idx, quads, circ, nc),
                                             crop_hw=crop, bf16=True)
    assert torch.equal(bf_v, got_v)


def test_twopass_bf16_within_the_jax_bounds():
    """The card's bf16 path (weights and pass A rounded to bfloat16, run
    here on the CPU through ``_warp_group``) on smooth imagery: against the
    JAX package's exact render within the bounds ``tests/test_warp2pass.py``
    holds its bf16 warp to (mean < 1.0, p99 < 6.0 on 0–255), and no closer
    to it than the float32 weights are."""
    import cv2

    rng = np.random.default_rng(2)
    small = rng.integers(0, 256, (64, 64, 3), np.uint8)
    bank = cv2.resize(small, (512, 512), interpolation=cv2.INTER_CUBIC)[None]
    quads = _quads(rng, 512, 512, n_border=0)
    idx = np.zeros(len(quads), np.int32)
    z3, zi = np.zeros((len(quads), 1, 3), np.float32), np.zeros(len(quads), np.int32)
    exact, _ = jrender.render_batch(*(jnp.asarray(a) for a in (bank, idx, quads, z3, zi)))
    exact = np.asarray(exact)
    rounded = torch.round(torch.from_numpy(quads))
    views = {dt: warp2pass._warp_group(torch.from_numpy(bank), torch.from_numpy(idx).long(),
                                       rounded, 256, 224, dt).numpy()
             for dt in (torch.float32, torch.bfloat16)}
    d16 = np.abs(views[torch.bfloat16] - exact)
    d32 = np.abs(views[torch.float32] - exact)
    assert d16.mean() < 1.0 and np.percentile(d16, 99) < 6.0, (d16.mean(), np.percentile(d16, 99))
    assert d32.mean() <= d16.mean() + 1e-3
    dd = np.abs(views[torch.bfloat16] - views[torch.float32])
    assert dd.mean() < 1.0 and np.percentile(dd, 99) < 6.0


@pytest.mark.parametrize("lat_ratio", [5e-6, 1e-5, 2e-5, 2.4e-5, 1e-4])
def test_auto_render_crop_matches_jax(lat_ratio):
    assert warp2pass.auto_render_crop(lat_ratio) == jwarp.auto_render_crop(lat_ratio)


def test_subsample_render_matches_jax():
    bank, idx, quads, circ, nc = _inputs(2)
    want_v, want_s = jrender.render_batch(
        *(jnp.asarray(a) for a in (bank, idx, quads, circ, nc)), subsample=2)
    got_v, got_s = render_batch(*_torch(bank, idx, quads, circ, nc), subsample=2)
    assert got_v.shape == (len(quads), 224, 224, 3)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0, atol=VIEW_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=VIEW_TOL)


def test_band_mode_raises():
    bank, idx, quads, circ, nc = _inputs(3)
    with pytest.raises(NotImplementedError, match="no contraction to band"):
        warp2pass.render_batch_twopass(*_torch(bank, idx, quads, circ, nc), band=True)
