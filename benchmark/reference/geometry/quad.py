# Frozen copy of avdn_tpu_torch/geometry/quad.py at commit d6443de, its imports pointed
# at the reference package.
"""Batched convex quad geometry (torch counterpart of
``avdn_tpu/geometry/quad.py``).

Replacement for the Shapely/GEOS polygon operations the reference leans on
(reference: src/env.py:14-46 ``compute_iou``; src/env.py:354-364 containment
tests; src/xview_et/agent.py:428-463 line-polygon intersection). The JAX
package writes each function for one quad and ``vmap``s it; here the batch
dimension is written out and the fixed-trip loops (Jarvis march,
Sutherland–Hodgman) are Python loops over tensor ops, so every item runs the
same branch-free arithmetic.

Conventions
-----------
* A "quad" is a ``(..., 4, 2)`` float tensor of vertices in any winding
  order; :func:`convex_hull` and :func:`orient_ccw` normalise winding.
* Padded polygons are ``(B, N, 2)`` tensors plus an integer ``count`` (B,);
  slots at ``index >= count`` are ignored (the first vertex is duplicated
  into them before area computations so the shoelace formula is unaffected).
"""

from __future__ import annotations

import torch

from reference.geometry.transforms import fma

# Max vertices of (convex quad) ∩ (convex quad) is 8; buffer at 8.
_CLIP_NV = 8
_EPS = 1e-12


def _rows(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], device=x.device)


def _signed_area(verts: torch.Tensor) -> torch.Tensor:
    """Shoelace sum as the JAX package's compiled code rounds it: XLA
    contracts each term ``x·y2 − x2·y`` into ``fma(x, y2, −(x2·y))`` and
    adds the terms in index order. The areas of small intersections cancel
    heavily, so plain torch arithmetic put the IoU up to 1.2e-6 off."""
    x = verts[..., 0]
    y = verts[..., 1]
    x2 = torch.roll(x, -1, dims=-1)
    y2 = torch.roll(y, -1, dims=-1)
    terms = fma(x, y2, -(x2 * y))
    total = terms[..., 0]
    for k in range(1, terms.shape[-1]):
        total = total + terms[..., k]
    return 0.5 * total


def _dup_pad(verts: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(verts.shape[-2], device=verts.device)
    keep = (idx < count[..., None])[..., None]
    return torch.where(keep, verts, verts[..., 0:1, :])


def polygon_area(verts: torch.Tensor, count=None) -> torch.Tensor:
    """Unsigned shoelace area of padded polygons ``verts`` (..., N, 2); with
    ``count``, slots >= count are replaced by the first vertex."""
    if count is not None:
        verts = _dup_pad(verts, count)
    return torch.abs(_signed_area(verts))


def orient_ccw(quad: torch.Tensor) -> torch.Tensor:
    """Flip vertex order of (..., 4, 2) quads so the signed area is >= 0."""
    cw = (_signed_area(quad) < 0.0)[..., None, None]
    return torch.where(cw, quad.flip(-2), quad)


def convex_hull(pts: torch.Tensor):
    """Convex hull of ``pts`` (B, N, 2) via Jarvis march (N is 4 or 8).

    Returns ``(hull (B, N, 2), count (B,))``, the hull padded by repeating
    its first vertex."""
    B, n = pts.shape[0], pts.shape[1]
    rows = _rows(pts)
    # start at the lexicographically smallest point (min y, then min x)
    miny = pts[..., 1].min(dim=-1, keepdim=True).values
    xs = torch.where(pts[..., 1] <= miny, pts[..., 0],
                     torch.full_like(pts[..., 0], float("inf")))
    start = xs.argmin(dim=-1)

    def next_point(cur):
        rel = pts - pts[rows, cur][:, None, :]
        d2 = torch.sum(rel * rel, dim=-1)
        best0 = d2.argmax(dim=-1)  # init with the farthest point
        best = best0
        for r in range(n):
            rb = rel[rows, best]
            cr = rb[:, 0] * rel[:, r, 1] - rb[:, 1] * rel[:, r, 0]
            take = (cr < -_EPS) | ((cr.abs() <= _EPS) & (d2[:, r] > d2[rows, best]))
            best = torch.where(take, r, best)
        # degenerate: all points coincide with the current one
        return torch.where(d2[rows, best0] <= _EPS, start, best)

    cur = start
    done = torch.zeros(B, dtype=torch.bool, device=pts.device)
    count = torch.zeros(B, dtype=torch.long, device=pts.device)
    emitted = []
    for _ in range(n):
        nxt = next_point(cur)
        emitted.append(torch.where(done, -1, cur))
        count = count + (~done).long()
        done = done | (nxt == start)
        cur = nxt
    emitted = torch.stack(emitted, dim=1)
    gathered = pts[rows[:, None], emitted.clamp(0, n - 1)]
    hull = torch.where((emitted >= 0)[..., None], gathered,
                       pts[rows, start][:, None, :])
    return hull, count


def clip_convex(subject, subj_count, clip_poly, clip_count):
    """Sutherland–Hodgman: clip padded ``subject`` (B, _CLIP_NV, 2) by the
    convex CCW duplicate-padded ``clip_poly`` (B, K, 2). Returns
    ``(verts (B, _CLIP_NV, 2), count (B,))``."""
    nv = subject.shape[1]
    rows = _rows(subject)
    verts, count = subject, subj_count
    for k in range(clip_poly.shape[1]):
        a = clip_poly[:, k]
        b = clip_poly[rows, torch.where(k + 1 < clip_count, k + 1, 0)]
        edge = b - a
        degenerate = torch.sum(edge * edge, dim=-1) <= _EPS  # padded edge: no-op

        def side(v):
            return edge[:, 0] * (v[:, 1] - a[:, 1]) - edge[:, 1] * (v[:, 0] - a[:, 0])

        out = torch.zeros_like(verts)
        cnt = torch.zeros_like(count)
        for i in range(nv):
            valid = i < count
            cur = verts[:, i]
            nxt = verts[rows, torch.where(i + 1 < count, i + 1, 0)]
            dcur = side(cur)
            dnxt = side(nxt)
            cur_in = dcur >= 0.0
            nxt_in = dnxt >= 0.0
            # intersection of cur->nxt with the clip line
            denom = dcur - dnxt
            ok = denom.abs() > _EPS
            t = torch.where(ok, dcur / torch.where(ok, denom, 1.0), 0.0)
            inter = cur + t[:, None] * (nxt - cur)
            for emit, point in ((valid & cur_in, cur),
                                (valid & (cur_in != nxt_in), inter)):
                slot = cnt % nv
                out[rows, slot] = torch.where(emit[:, None], point, out[rows, slot])
                cnt = cnt + emit.long()
        skip = degenerate | (k >= clip_count)
        verts = torch.where(skip[:, None, None], verts, out)
        count = torch.where(skip, count, cnt)
    return verts, count


def _order_ccw_padded(verts, count):
    """Reverse the first ``count`` vertices if the polygon winds clockwise,
    then duplicate-pad. Keeps valid vertices in slots [0, count)."""
    n = verts.shape[1]
    cw = _signed_area(_dup_pad(verts, count)) < 0.0
    idx = torch.arange(n, device=verts.device)[None, :]
    rev_idx = torch.where(idx < count[:, None], count[:, None] - 1 - idx, 0)
    reversed_verts = verts[_rows(verts)[:, None], rev_idx.clamp(0, n - 1)]
    out = torch.where(cw[:, None, None], reversed_verts, verts)
    return _dup_pad(out, count)


def quad_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of quads ``a``, ``b`` (B, 4, 2) with the reference's hull-union
    convention (src/env.py:14-46): the numerator is the intersection area of
    the two convex hulls; the denominator is the area of the convex hull of
    all 8 points (NOT the standard union). 0 when the quads do not intersect
    or the union hull is degenerate. Returns (B,)."""
    a = a.float()
    b = b.float()
    hull_a, cnt_a = convex_hull(a)
    hull_b, cnt_b = convex_hull(b)
    hull_b_ccw = _order_ccw_padded(hull_b, cnt_b)

    subject = a.new_zeros((a.shape[0], _CLIP_NV, 2))
    subject[:, : hull_a.shape[1]] = hull_a
    inter_verts, inter_cnt = clip_convex(subject, cnt_a, hull_b_ccw, cnt_b)
    inter_area = polygon_area(inter_verts, inter_cnt)
    inter_area = torch.where(inter_cnt >= 3, inter_area, 0.0)

    union_hull, union_cnt = convex_hull(torch.cat([a, b], dim=1))
    union_area = polygon_area(union_hull, union_cnt)

    iou = torch.where(union_area > 0.0,
                      inter_area / torch.clamp(union_area, min=_EPS), 0.0)
    return torch.clamp(iou, 0.0, 1.0)


def point_in_convex_quad(point: torch.Tensor, quad: torch.Tensor) -> torch.Tensor:
    """Strict interior test (Shapely ``Polygon.contains`` semantics: boundary
    points are NOT contained — reference src/env.py:354-364). point (..., 2),
    quad (..., 4, 2) → (...) bool."""
    q = orient_ccw(quad)
    b = torch.roll(q, -1, dims=-2)
    p = point[..., None, :]
    cr = (b[..., 0] - q[..., 0]) * (p[..., 1] - q[..., 1]) - (
        b[..., 1] - q[..., 1]) * (p[..., 0] - q[..., 0])
    return torch.all(cr > 0.0, dim=-1)


def clip_segment_to_quad(p0: torch.Tensor, p1: torch.Tensor, quad: torch.Tensor):
    """Clip segments p0→p1 (..., 2) against convex quads (..., 4, 2)
    (Liang–Barsky over half-planes; leading dimensions broadcast).

    Replacement for Shapely ``polygon.intersection(LineString)`` (reference
    src/xview_et/agent.py:428-451). Returns ``(q0, q1, valid)``: the clipped
    sub-segment endpoints and whether an intersection exists.
    """
    q = orient_ccw(quad)
    edge = torch.roll(q, -1, dims=-2) - q
    # inward normal for a CCW polygon is left of the edge: (-ey, ex)
    n = torch.stack([-edge[..., 1], edge[..., 0]], dim=-1)
    d = p1 - p0
    num = torch.sum(n * (p0[..., None, :] - q), dim=-1)  # f(0) per edge
    den = torch.sum(n * d[..., None, :], dim=-1)
    pos = den > _EPS
    neg = den < -_EPS
    inf = torch.full_like(num, float("inf"))
    lo_cand = torch.where(pos, -num / torch.where(pos, den, 1.0), -inf)
    hi_cand = torch.where(neg, -num / torch.where(neg, den, 1.0), inf)
    infeasible = (den.abs() <= _EPS) & (num < 0.0)
    t0 = torch.clamp(lo_cand.max(dim=-1).values, min=0.0)
    t1 = torch.clamp(hi_cand.min(dim=-1).values, max=1.0)
    valid = (t0 <= t1) & ~infeasible.any(dim=-1)
    q0 = p0 + t0[..., None] * d
    q1 = p0 + t1[..., None] * d
    return q0, q1, valid
