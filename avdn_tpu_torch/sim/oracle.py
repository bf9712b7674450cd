"""Teacher oracle — ground-truth action supervision (torch counterpart of
``avdn_tpu/sim/oracle.py``).

Replaces the Shapely-based ``teacher_action`` duplicated in both reference
agents (src/xview_et/agent.py:386-507 ≡ src/xview_lstm/agent.py:375-513)
with a fixed-shape batched formulation:

* progress     = hull-union IoU of the current view vs the final GT view
* altitude     = edge length of the *closest* GT step, normalised to [0, 1]
                 via ``(m − 40) / 360``
* waypoint     = the point where the GT path polyline (teacher forcing) or
                 the straight line to the goal (student mode) crosses the
                 current view quad, choosing the intersection point closest
                 to the goal center; expressed as a ratio against the view's
                 half-axes and clamped to the ∞-ball.

GT paths are padded to a static ``max_gt_len`` with a ``gt_len`` count.
Coordinates are GPS offsets from the map bottom-left (see sim.dynamics).

For tensors on the card, :func:`teacher_action_batch` launches one
hand-written CUDA kernel a call (``csrc/teacher_oracle.cu``), which gives
the same bits as the plain version there; ``teacher_action_batch.launches``
counts its launches. Tensors on the CPU take
:func:`teacher_action_batch_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from avdn_tpu_torch.geometry.quad import clip_segment_to_quad, quad_iou
from avdn_tpu_torch.geometry.transforms import DEG_TO_M
from avdn_tpu_torch.ops import build
from avdn_tpu_torch.utils.logging import span


def _closest_gt_step(gt_centers, gt_len, current_pos):
    """Index (B,) of the GT step whose center is closest to ``current_pos``,
    scanning from the last step backwards with the reference's 1e-5
    strict-improvement epsilon (src/xview_et/agent.py:410-416): ties keep the
    later (higher-index) step."""
    B, max_t = gt_centers.shape[0], gt_centers.shape[1]
    min_dis = gt_centers.new_full((B,), 1000.0)
    best = torch.zeros(B, dtype=torch.long, device=gt_centers.device)
    for j in range(max_t - 1, -1, -1):  # descending
        d = torch.linalg.vector_norm(gt_centers[:, j] - current_pos, dim=-1)
        take = (j < gt_len) & (d + 1e-5 < min_dis)
        min_dis = torch.where(take, d, min_dis)
        best = torch.where(take, j, best)
    return best


def teacher_action_batch_plain(corners, ended, gt_corners, gt_len,
                               teacher_forcing: bool):
    """Batched oracle in torch ops (the CPU path and the kernel's reference).

    Args:
      corners: (B, 4, 2) current view corners (GPS offsets).
      ended: (B,) bool — episode already finished.
      gt_corners: (B, max_gt_len, 4, 2) padded GT path corners.
      gt_len: (B,) number of valid GT steps.
      teacher_forcing: follow the GT polyline (True) or aim straight at the
        goal (False; reference "student" branch, agent.py:430-434).

    Returns dict with ``waypoint_ratio`` (B, 2), ``altitude`` (B,),
    ``progress`` (B,).
    """
    corners = corners.float()
    B, max_t = gt_corners.shape[0], gt_corners.shape[1]
    rows = torch.arange(B, device=corners.device)
    current_pos = corners.mean(dim=1)
    goal_quad = gt_corners[rows, torch.clamp(gt_len - 1, min=0)]
    goal_center = goal_quad.mean(dim=1)

    # -------- progress (IoU vs final GT view) --------
    progress = quad_iou(corners, goal_quad)

    # -------- teacher altitude --------
    gt_centers = gt_corners.mean(dim=2)  # (B, max_t, 2)
    closest = _closest_gt_step(gt_centers, gt_len, current_pos)
    closest_quad = gt_corners[rows, closest]
    closest_edge_m = torch.linalg.vector_norm(
        closest_quad[:, 0] - closest_quad[:, 1], dim=-1) * DEG_TO_M
    altitude = (closest_edge_m - 40.0) / (400.0 - 40.0)

    # -------- waypoint --------
    # the goal line (student) — also the teacher's fallback
    q0, q1, v = clip_segment_to_quad(current_pos, goal_center, corners)
    line_pts = torch.stack([q0, q1], dim=1)  # (B, 2, 2)
    line_valid = torch.stack([v, v], dim=1)
    if teacher_forcing:
        # candidates from clipping the GT polyline's segments
        q0, q1, v = clip_segment_to_quad(
            gt_centers[:, : max_t - 1], gt_centers[:, 1:max_t],
            corners[:, None])
        seg = torch.arange(max_t - 1, device=corners.device)[None, :]
        v = v & (seg < (gt_len[:, None] - 1))
        poly_pts = torch.cat([q0, q1], dim=1)  # (B, 2*(max_t-1), 2)
        poly_valid = torch.cat([v, v], dim=1)
        n = poly_pts.shape[1]
        any_poly = poly_valid.any(dim=1)
        # fallback to the goal line when the polyline misses the view
        # (reference src/xview_et/agent.py:446-451); the line's two points
        # are tiled to the polyline's width and only the first two count
        reps = -(-n // 2)
        tiled_pts = line_pts.repeat(1, reps, 1)[:, :n]
        tiled_valid = line_valid.repeat(1, reps)[:, :n] & (
            torch.arange(n, device=corners.device)[None, :] < 2)
        pts = torch.where(any_poly[:, None, None], poly_pts, tiled_pts)
        valid = torch.where(any_poly[:, None], poly_valid, tiled_valid)
    else:
        pts, valid = line_pts, line_valid

    # closest-to-goal selection with min_distance init 1 (agent.py:457-463)
    dist = torch.linalg.vector_norm(pts - goal_center[:, None, :], dim=-1)
    dist = torch.where(valid, dist, torch.full_like(dist, float("inf")))
    best = dist.argmin(dim=1)
    waypoint = torch.where((dist[rows, best] < 1.0)[:, None], pts[rows, best],
                           torch.zeros_like(current_pos))

    # -------- waypoint → view-frame ratio (agent.py:484-503) --------
    net_next = 1e5 * (waypoint - current_pos)
    # the reference int-rounds the axis vectors (agent.py:485-486)
    net_y = torch.round(1e5 * ((corners[:, 0] + corners[:, 1]) / 2.0 - current_pos))
    net_x = torch.round(1e5 * ((corners[:, 1] + corners[:, 2]) / 2.0 - current_pos))
    # solve [[x0, y0], [x1, y1]] @ r = net_next
    det = net_x[:, 0] * net_y[:, 1] - net_y[:, 0] * net_x[:, 1]
    safe_det = torch.where(det.abs() > 1e-12, det, 1.0)
    r0 = (net_next[:, 0] * net_y[:, 1] - net_y[:, 0] * net_next[:, 1]) / safe_det
    r1 = (net_x[:, 0] * net_next[:, 1] - net_next[:, 0] * net_x[:, 1]) / safe_det
    ratio = torch.stack([r0, r1], dim=1)
    ratio = ratio / torch.clamp(ratio.abs().max(dim=1, keepdim=True).values, min=1.0)

    # stop target: zero waypoint when ended or close enough (agent.py:420-422)
    stop = ended | (progress > 0.5)
    ratio = torch.where(stop[:, None], torch.zeros_like(ratio), ratio)

    return {
        "waypoint_ratio": ratio.float(),
        "altitude": altitude.float(),
        "progress": progress.float(),
    }


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load("teacher_oracle")
    fn = lib.teacher_oracle_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(corners, ended, gt_corners, gt_len, teacher_forcing):
    dev = corners.device
    B = corners.shape[0] if corners.dim() else 0
    max_t = gt_corners.shape[1] if gt_corners.dim() > 1 else 0
    if dev.type != "cuda":
        raise ValueError(f"oracle kernel: corners on {dev}, expected every input on "
                         "one CUDA device")
    for name, t, dtype, shape in (("corners", corners, torch.float32, (B, 4, 2)),
                                  ("ended", ended, torch.bool, (B,)),
                                  ("gt_corners", gt_corners, torch.float32, (B, max_t, 4, 2)),
                                  ("gt_len", gt_len, torch.int64, (B,))):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"oracle kernel: {name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} (contiguous: {t.is_contiguous()}), expected "
                             f"contiguous {dtype} {shape} on {dev}")
    # the plain version's argmin has no candidate at max_gt_len 1 under
    # teacher forcing, and raises there too
    if not (1 <= B < 2**31 and (2 if teacher_forcing else 1) <= max_t < 2**31):
        raise ValueError(f"oracle kernel: {B} items of max_gt_len {max_t}, expected at "
                         f"least 1 item and max_gt_len >= {2 if teacher_forcing else 1}")


def teacher_action_batch(corners, ended, gt_corners, gt_len, teacher_forcing: bool):
    """Batched oracle: :func:`teacher_action_batch_plain`'s arguments and
    results. On the card one launch of the oracle kernel computes all three
    outputs, counted in ``teacher_action_batch.launches``: corners and
    gt_corners contiguous float32, ended bool and gt_len int64, all on one
    device (anything else raises; nothing is copied or synchronised). The
    results are views of one allocation. CPU tensors take the plain
    version."""
    with span("sim.oracle"):
        if all(t.device.type == "cpu" for t in (corners, ended, gt_corners, gt_len)):
            return teacher_action_batch_plain(corners, ended, gt_corners, gt_len,
                                              teacher_forcing)
        _check_kernel_inputs(corners, ended, gt_corners, gt_len, teacher_forcing)
        B, max_t = gt_corners.shape[0], gt_corners.shape[1]
        dev = corners.device
        out = torch.empty(4 * B, dtype=torch.float32, device=dev)
        err = _kernel()(corners.data_ptr(), ended.data_ptr(), gt_corners.data_ptr(),
                        gt_len.data_ptr(), out.data_ptr(), B, max_t, int(teacher_forcing),
                        torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"oracle kernel launch failed (B={B}, max_gt_len "
                               f"{max_t}): CUDA error {err}")
        teacher_action_batch.launches += 1
        ratio, altitude, progress = out.split((2 * B, B, B))
        return {"waypoint_ratio": ratio.view(B, 2), "altitude": altitude,
                "progress": progress}


teacher_action_batch.launches = 0
