"""The port's geometry, dynamics, oracle and exact render against the JAX
package's, on the CPU, with seeded fuzzed inputs at the scale of the
rollout (GPS offsets of a few 1e-3 degrees).

Tolerances: booleans equal; floats within 1e-5 (coordinates: relative
1e-5); views within 1e-3 per pixel on the 0–255 scale and saliency
identical (the port evaluates the source coordinates with XLA's roundings,
sim/render.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avdn_tpu.geometry import quad as jquad
from avdn_tpu.geometry import transforms as jtransforms
from avdn_tpu.sim import dynamics as jdyn
from avdn_tpu.sim import oracle as joracle
from avdn_tpu.sim import render as jrender
from avdn_tpu_torch.geometry import quad
from avdn_tpu_torch.geometry.transforms import get_direction
from avdn_tpu_torch.sim.dynamics import move_view_corners_batch
from avdn_tpu_torch.sim.oracle import teacher_action_batch
from avdn_tpu_torch.sim.render import render_batch

DEG_TO_M = 11.13e4


def views(rng, n, center_lo=0.002, center_hi=0.008, edge_m=(40, 400)):
    """n square views (n, 4, 2) at random centers, edges and headings, in
    the reference corner order."""
    c = rng.uniform(center_lo, center_hi, (n, 2))
    h = rng.uniform(*edge_m, n) / DEG_TO_M / 2
    th = rng.uniform(0, 2 * np.pi, n)
    base = np.array([[1, -1], [1, 1], [-1, 1], [-1, -1]], np.float64)
    rot = np.stack([np.stack([np.cos(th), np.sin(th)], -1),
                    np.stack([-np.sin(th), np.cos(th)], -1)], -2)
    q = np.einsum("vk,njk->nvj", base, rot) * h[:, None, None] + c[:, None, :]
    return q.astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def quads():
    rng = np.random.default_rng(0)
    n = 64
    a = views(rng, n)
    b = views(rng, n)
    b[:16] = a[:16] + rng.normal(0, 2e-4, (16, 4, 2)).astype(np.float32)  # overlaps
    b[16:20] = a[16:20]  # identical
    b[20:24] = a[20:24, ::-1]  # clockwise copy
    b[24:26] = a[24:26, [0, 0, 0, 0]]  # degenerate (a point)
    return a, b


def test_quad_iou(quads):
    a, b = quads
    want = np.asarray(jquad.quad_iou_batch(jnp.asarray(a), jnp.asarray(b)))
    got = quad.quad_iou(t(a), t(b)).numpy()
    assert (want > 0).sum() >= 20
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_point_in_convex_quad(quads):
    a, b = quads
    rng = np.random.default_rng(1)
    pts = (a.mean(1) + rng.normal(0, 1e-3, (a.shape[0], 2))).astype(np.float32)
    want = np.asarray(jax.vmap(jquad.point_in_convex_quad)(jnp.asarray(pts), jnp.asarray(a)))
    got = quad.point_in_convex_quad(t(pts), t(a)).numpy()
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(got, want)


def test_clip_segment_to_quad(quads):
    a, b = quads
    p0 = a.mean(1)
    p1 = b.mean(1)
    p1[30:34] = p0[30:34]  # zero-length segments
    want = jax.vmap(jquad.clip_segment_to_quad)(jnp.asarray(p0), jnp.asarray(p1),
                                                 jnp.asarray(b))
    got = quad.clip_segment_to_quad(t(p0), t(p1), t(b))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    m = np.asarray(want[2])
    assert 0 < m.sum() < len(m)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy()[m], np.asarray(w)[m], rtol=1e-5, atol=1e-9)


def test_get_direction():
    rng = np.random.default_rng(2)
    s, e = rng.normal(0, 1e-3, (2, 32, 2)).astype(np.float32)
    e[:4, 1] = s[:4, 1]  # vertical vectors (the v1 == 0 ties)
    want = np.asarray(jtransforms.get_direction(jnp.asarray(s), jnp.asarray(e)))
    # degrees in [0, 360): 1e-5 relative is a few float32 ulps
    np.testing.assert_allclose(get_direction(t(s), t(e)).numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_move_view_corners_batch():
    rng = np.random.default_rng(3)
    n = 64
    corners = views(rng, n, 0.001, 0.009)
    angle = rng.integers(0, 360, n).astype(np.float32)
    dist = (rng.uniform(0, 1, n) * 2e-3).astype(np.float32)
    alt = (np.round(rng.uniform(0, 1, n) * 360) + 40).astype(np.float32)
    extent = np.full((n, 2), 0.01, np.float32)
    cur_dir = rng.integers(0, 360, n).astype(np.float32)
    args = (corners, angle, dist, alt, extent, cur_dir)
    wc, wd = jdyn.move_view_corners_batch(*(jnp.asarray(x) for x in args))
    gc, gd = move_view_corners_batch(*(t(x) for x in args))
    moved = ~np.all(np.asarray(wc) == corners, axis=(1, 2))
    assert 0 < moved.sum() < n  # some moves abort at the map border
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=1e-5)


@pytest.mark.parametrize("teacher_forcing", [True, False])
def test_teacher_action_batch(teacher_forcing):
    rng = np.random.default_rng(4)
    B, Tg = 32, 6
    gt = np.zeros((B, Tg, 4, 2), np.float32)
    gt_len = rng.integers(1, Tg + 1, B)
    for i in range(B):
        start = views(rng, 1)[0]
        step = rng.normal(0, 6e-4, 2).astype(np.float32)
        for j in range(Tg):
            gt[i, j] = start + j * step
    corners = gt[:, 0] + rng.normal(0, 3e-4, (B, 1, 2)).astype(np.float32)
    corners[:4] = gt[np.arange(4), gt_len[:4] - 1]  # at the goal
    ended = rng.uniform(0, 1, B) < 0.2
    want = joracle.teacher_action_batch(jnp.asarray(corners), jnp.asarray(ended),
                                        jnp.asarray(gt), jnp.asarray(gt_len),
                                        teacher_forcing)
    got = teacher_action_batch(t(corners), t(ended), t(gt), t(gt_len), teacher_forcing)
    for k in ("waypoint_ratio", "altitude", "progress"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5,
                                   err_msg=k)
    assert (np.asarray(want["progress"]) > 0.5).any()
    assert np.abs(np.asarray(want["waypoint_ratio"])).max() > 0.1


def test_render_batch_straddling_border():
    rng = np.random.default_rng(5)
    N, Hm, B, C = 2, 300, 6, 4
    bank = rng.integers(0, 256, (N, Hm, Hm, 3), np.uint8)
    c = rng.uniform(-20, 320, (B, 2))
    e = rng.uniform(20, 200, B)
    th = rng.uniform(0, 2 * np.pi, B)
    base = np.array([[1, -1], [1, 1], [-1, 1], [-1, -1]], np.float64) / 2
    rot = np.stack([np.stack([np.cos(th), np.sin(th)], -1),
                    np.stack([-np.sin(th), np.cos(th)], -1)], -2)
    quads = (np.einsum("vk,njk->nvj", base, rot) * e[:, None, None]
             + c[:, None, :]).astype(np.float32)
    circles = np.zeros((B, C, 3), np.float32)
    circles[..., :2] = rng.uniform(0, 300, (B, C, 2))
    circles[..., 2] = rng.integers(5, 60, (B, C))
    n_circles = rng.integers(0, C + 1, B).astype(np.int32)
    map_idx = rng.integers(0, N, B).astype(np.int32)
    args = (bank, map_idx, quads, circles, n_circles)
    wv, ws = jrender.render_batch(*(jnp.asarray(x) for x in args))
    gv, gs = render_batch(*(t(x) for x in args))
    wv = np.asarray(wv)
    assert (wv == 0).all(-1).any() and (wv > 0).any()  # straddles the border
    np.testing.assert_allclose(gv.numpy(), wv, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    assert 0 < gs.numpy().mean() < 1


def _projective_quads(rng, n, Hm):
    """n integer-cornered view quads whose opposite sides differ (the
    homography's last row is not (0, 0, 1)), in map pixel (x, y)."""
    c = rng.uniform(0.3 * Hm, 0.7 * Hm, (n, 2))
    base = np.array([[1, -1], [1, 1], [-1, 1], [-1, -1]], np.float64)
    q = (c[:, None, :] + base * rng.uniform(30, 90, (n, 1, 1))
         + rng.uniform(-15, 15, (n, 4, 2)))
    return np.round(q).astype(np.float32)


@pytest.mark.parametrize("B", [1, 2, 5])
def test_render_projective_quads(B):
    """Projective quads at one, two and five items per call (XLA's CPU dot
    for ``pts @ H.T`` leaves some columns without an FMA at one and two;
    sim/render.py ``_XLA_UNFUSED``): the source coordinates equal JAX's bit
    for bit, the views within 1e-3 on the 0–255 scale, the saliency equal,
    and the two-pass render's iso-row coefficients equal JAX's and its
    float32 views within 1e-3 (for a lone item XLA folds the positions'
    1/223 into the homography's scalars, ``warp2pass._iso_row_coeffs``)."""
    from avdn_tpu.sim import warp2pass as jwarp
    from avdn_tpu_torch.sim import warp2pass
    from avdn_tpu_torch.sim.render import square_to_quad_homography, view_to_map_coords

    rng = np.random.default_rng(11 + B)
    N, Hm, C = 2, 400, 3
    bank = rng.integers(0, 256, (N, Hm, Hm, 3), np.uint8)
    quads = _projective_quads(rng, B, Hm)
    H = square_to_quad_homography(t(quads)).numpy()
    assert (np.abs(H[:, 2, :2]) > 1e-6).all()  # g, h ≠ 0: projective
    want = np.asarray(jax.jit(jax.vmap(lambda q: jrender.view_to_map_coords(q, 224)))(
        jnp.asarray(quads)))
    np.testing.assert_array_equal(view_to_map_coords(t(quads)).numpy(), want)

    circles = np.zeros((B, C, 3), np.float32)
    circles[..., :2] = rng.uniform(0.3 * Hm, 0.7 * Hm, (B, C, 2))
    circles[..., 2] = rng.integers(10, 60, (B, C))
    n_circles = np.full(B, C, np.int32)
    map_idx = rng.integers(0, N, B).astype(np.int32)
    args = (bank, map_idx, quads, circles, n_circles)
    wv, ws = jrender.render_batch(*(jnp.asarray(x) for x in args))
    gv, gs = render_batch(*(t(x) for x in args))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))

    Hj = jnp.asarray(H)
    ja, jb = (np.asarray(x) for x in jax.jit(jax.vmap(
        lambda h: jwarp._iso_row_coeffs(h, 224)))(Hj))
    pa, pb = (x.numpy() for x in warp2pass._iso_row_coeffs(t(H), 224))
    for got, ref in ((pa, ja), (pb, jb)):
        ulps = np.abs(got.view(np.int32).astype(np.int64) - ref.view(np.int32))
        assert ulps.max() == 0, ulps.max()
    wv2, ws2 = jwarp.render_batch_twopass(*(jnp.asarray(x) for x in args),
                                          crop_hw=256, bf16=False)
    gv2, gs2 = warp2pass.render_batch_twopass(*(t(x) for x in args), crop_hw=256,
                                              bf16=False)
    np.testing.assert_allclose(gv2.numpy(), np.asarray(wv2), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(gs2.numpy(), np.asarray(ws2))
