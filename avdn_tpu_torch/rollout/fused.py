"""Time-fused teacher-forced rollout (torch counterpart of the eval half of
``avdn_tpu/rollout/fused.py``).

Under teacher forcing the trajectory does not depend on the model: the
executed action is the oracle target and the stop decision is the GT
progress (src/xview_et/agent.py:724-744 with feedback='teacher'). The model
is consulted every step, for the losses and the HA metrics, but never
steers. So:

1. a geometry-only loop unrolls the whole trajectory first (oracle, stop,
   dynamics; no render, no model);
2. all T·B views render in ONE call;
3. the vision tower runs once over the flat T·B batch in eval (running
   statistics make that identical to T per-step calls); in train mode it
   runs T train-mode calls over the (B, …) views of each step, so BatchNorm
   normalises with each step's statistics over (B, H, W) and the running
   statistics chain step after step, as in the step loop (the JAX package
   rebuilds that chain from a ``vmap``, ``_bn_stats_chain``);
4. the ET trunk runs once over the full history (``models/et_fast.py``,
   eval), or as the T step-masked calls of the step loop (train mode, with
   each call's own dropout masks, and ``--fast_eval_trunk False``); the
   LSTM cell runs its T sequential steps over the precomputed features;
5. the T·B saliency heads are upsampled and the saliency kernel runs once
   over their maps (and in train mode the head-gradient kernel once, when
   the loss holds the −NSS term).

The result is the same ``RolloutOutputs`` as ``engine.rollout`` with a
teacher-forcing config.
"""

from __future__ import annotations

import dataclasses

import torch

from avdn_tpu_torch.config import check_family
from avdn_tpu_torch.models.et_fast import teacher_onepass
from avdn_tpu_torch.models.lstm import heading_radians, init_lstm_state
from avdn_tpu_torch.ops.losses import step_losses
from avdn_tpu_torch.ops.saliency import saliency_head_reductions, saliency_upsample
from avdn_tpu_torch.parallel.batch import batch_all, batch_rand
from avdn_tpu_torch.rollout.engine import (
    _PI_REF,
    RGB_MEAN,
    RGB_STD,
    STOP_THRESHOLD,
    EpisodeBatch,
    RolloutConfig,
    RolloutOutputs,
    decode_action,
    dynamics_update,
    render_views,
)
from avdn_tpu_torch.sim.oracle import teacher_action_batch
from avdn_tpu_torch.utils.logging import span


def teacher_geometry(batch: EpisodeBatch, cfg: RolloutConfig,
                     generator: torch.Generator):
    """Unroll the model-independent teacher trajectory with the step loop's
    carry. The loss's heading jitter is drawn per step from ``generator`` in
    the step loop's order, so both paths draw the same numbers.

    Returns a dict of per-step (T leading) tensors: ``corners_pre`` /
    ``dirs_pre`` (the state each step renders from), ``ended_pre``,
    ``any_alive``, the oracle targets ``gt_wp`` / ``gt_alt`` / ``gt_prog``,
    ``heading_eps`` (only with losses) and the post-step ``corners_post`` /
    ``dirs_post`` / ``ended_post``."""
    B = batch.start_corners.shape[0]
    T = cfg.max_action_len
    dev = batch.start_corners.device
    corners = batch.start_corners.float()
    directions = batch.start_dir.float()
    ended = torch.zeros((B,), dtype=torch.bool, device=dev)
    ys = []
    for t in range(T):
        y = dict(corners_pre=corners, dirs_pre=directions, ended_pre=ended,
                 any_alive=~batch_all(ended))
        if cfg.compute_losses:
            oracle = teacher_action_batch(corners, ended, batch.gt_corners,
                                          batch.gt_len, True)
            gt_wp, gt_alt, gt_prog = (oracle["waypoint_ratio"], oracle["altitude"],
                                      oracle["progress"])
            y["heading_eps"] = 1e-5 * batch_rand((B,), generator, dev)
        else:
            # without losses there are no oracle targets: only t == T-1 stops
            gt_wp = torch.zeros((B, 2), dtype=torch.float32, device=dev)
            gt_alt = gt_prog = torch.zeros((B,), dtype=torch.float32, device=dev)
        stop_now, corners, directions = dynamics_update(
            corners, directions, gt_wp, gt_alt, gt_prog, STOP_THRESHOLD, t, T,
            batch.extent)
        ended = ended | stop_now
        y.update(gt_wp=gt_wp, gt_alt=gt_alt, gt_prog=gt_prog, corners_post=corners,
                 dirs_post=directions, ended_post=ended)
        ys.append(y)
    return {k: torch.stack([y[k] for y in ys]) for k in ys[0]}


def _render_all(map_bank, batch: EpisodeBatch, corners_tb, cfg: RolloutConfig):
    """Render all T·B views in one call, in ``cfg``'s render mode.
    ``corners_tb``: (T, B, 4, 2). Returns (views (T, B, H, W, 3), gt_sal
    (T, B, H, W))."""
    T, B = corners_tb.shape[:2]
    tiled = dataclasses.replace(
        batch,
        map_idx=batch.map_idx.repeat(T),
        extent=batch.extent.repeat(T, 1),
        lat_ratio=batch.lat_ratio.repeat(T),
        circles=batch.circles.repeat(T, 1, 1),
        n_circles=batch.n_circles.repeat(T),
    )
    views, gt_sal = render_views(map_bank, tiled, corners_tb.reshape(T * B, 4, 2), cfg)
    return views.reshape(T, B, *views.shape[1:]), gt_sal.reshape(T, B, *gt_sal.shape[1:])


def _tower_features(darknet_model, x_tb, cfg: RolloutConfig):
    """The vision tower over the T·B views ``x_tb`` (T, B, H, W, 3),
    normalised. Eval: one call over the flat batch (running statistics make
    it equal to T per-step calls). Train: T calls in step order, each
    normalising with its own batch statistics and updating the running ones
    after the last. Returns feats (T, B, C, S)."""
    T, B = x_tb.shape[:2]
    if cfg.train:
        return torch.stack([darknet_model(x_tb[t]) for t in range(T)])
    feats = darknet_model(x_tb.reshape(T * B, *x_tb.shape[2:]))
    return feats.reshape(T, B, *feats.shape[1:])


def _et_actions(et_model, batch: EpisodeBatch, cfg: RolloutConfig, feats,
                dir_feat, ended_pre, generator=None):
    """All T step outputs of the ET trunk: ``(actions (T, B, 4), saliency
    heads (T, B, 8, 8))``.

    The step loop's history buffer at step t holds the features of
    positions ≤ t and zeros beyond, and its lengths are the cumulative
    alive counts; masking the full buffer reproduces it. In eval with
    ``fast_eval_trunk`` one pass over the full history gives all T outputs
    (``teacher_onepass``); otherwise (always in train mode, where each
    step's pass draws its own dropout masks from ``generator``) the trunk
    runs once per step."""
    T = feats.shape[0]
    frames = feats.transpose(0, 1)        # (B, T, C, S)
    dirs = dir_feat.transpose(0, 1)       # (B, T, 2)
    lengths_t = torch.cumsum((~ended_pre).long(), dim=0)  # (T, B)
    if cfg.fast_eval_trunk and not cfg.train:
        return teacher_onepass(et_model, batch.lang_feat, batch.lang_cls, frames,
                               dirs, lengths_t)
    actions, sal = [], []
    for t in range(T):
        keep = torch.arange(T, device=frames.device) <= t
        a, s = et_model(batch.lang_feat, batch.lang_cls,
                        torch.where(keep[None, :, None, None], frames, 0.0),
                        torch.where(keep[None, :, None], dirs, 0.0), lengths_t[t],
                        generator)
        actions.append(a)
        sal.append(s)
    return torch.stack(actions), torch.stack(sal)


def _lstm_actions(lstm_model, batch: EpisodeBatch, feats, dir_feat, generator=None):
    """All T step outputs of the LSTM cell over the precomputed features:
    ``(actions (T, B, 4), saliency heads (T, B, 8, 8))``. The recurrent state
    genuinely chains, so the cell runs T sequential steps, each drawing its
    dropout masks from ``generator`` (train mode); it is a few small matrix
    products a step, so the loop is not the episode's critical path."""
    state = init_lstm_state(feats.shape[1], lstm_model.cfg, device=feats.device)
    actions, sal = [], []
    for t in range(feats.shape[0]):
        state, a, s = lstm_model(heading_radians(dir_feat[t]), feats[t], batch.lang_cls,
                                 batch.lang_feat, state, generator)
        actions.append(a)
        sal.append(s)
    return torch.stack(actions), torch.stack(sal)


def rollout_teacher_fused(*, map_bank, batch: EpisodeBatch, cfg: RolloutConfig,
                          family: str, darknet_model, vln_model,
                          generator: torch.Generator) -> RolloutOutputs:
    """Teacher-forced rollout with the render, towers and saliency
    statistics batched over time; equal to ``engine.rollout`` with the same
    teacher-forcing config and generator. With ``cfg.train`` the loss carries
    the autograd graph of the model's outputs and ``generator`` also draws
    the dropout masks."""
    with span("rollout"):
        if not cfg.teacher_forcing:
            raise ValueError("the fused rollout is teacher forcing only")
        check_family(family)
        B = batch.start_corners.shape[0]
        T = cfg.max_action_len
        dev = batch.start_corners.device

        with torch.no_grad():  # the simulator is outside autograd
            geo = teacher_geometry(batch, cfg, generator)
            # ---- one render of every (t, b) view ----
            views, gt_sal = _render_all(map_bank, batch, geo["corners_pre"], cfg)
        mean = torch.tensor(RGB_MEAN, dtype=torch.float32, device=dev)
        std = torch.tensor(RGB_STD, dtype=torch.float32, device=dev)
        x = views - mean if cfg.fused_input_norm else (views - mean) / std

        rad = geo["dirs_pre"] / 180.0 * _PI_REF
        dir_feat = torch.stack([torch.sin(rad), torch.cos(rad)], dim=-1)  # (T, B, 2)
        if cfg.no_direction:
            dir_feat = torch.zeros_like(dir_feat)

        # ---- towers, time-batched ----
        feats = _tower_features(darknet_model, x, cfg)
        if cfg.language_only:
            feats = torch.zeros_like(feats)
        if family == "et":
            actions, sal_head = _et_actions(vln_model, batch, cfg, feats, dir_feat,
                                            geo["ended_pre"], generator)
        else:
            actions, sal_head = _lstm_actions(vln_model, batch, feats, dir_feat, generator)
        actions = actions.float()
        sal_head = sal_head.reshape(T * B, *sal_head.shape[2:])
        gt_flat = gt_sal.reshape(T * B, *gt_sal.shape[2:])
        wp_norm, alt_clip, _ = decode_action(actions.reshape(T * B, 4))

        # ---- HA statistics: one saliency-kernel launch over the T·B maps (and
        # under autograd one launch of the head's gradient) ----
        pred_sal = None
        if cfg.compute_losses or cfg.collect_ha_metrics:
            pred_sal, *red = saliency_head_reductions(sal_head, gt_flat, nss_r=cfg.nss_r)
            neg_nss, nss_valid, ha_prec, ha_rec = (r.reshape(T, B) for r in red)
        else:
            neg_nss = ha_prec = ha_rec = torch.zeros((T, B), dtype=torch.float32,
                                                     device=dev)
            nss_valid = torch.zeros((T, B), dtype=torch.bool, device=dev)
        if cfg.collect_saliency:
            if pred_sal is None:
                pred_sal = saliency_upsample(sal_head.detach(), gt_flat.shape[-1]).float()
            pred_sal = pred_sal.reshape(T, B, *pred_sal.shape[1:])

        # ---- losses, summed over the steps in the step loop's order ----
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        if cfg.compute_losses:
            nss_term = (torch.where(nss_valid, neg_nss, 0.0).sum(dim=1) if cfg.nss_w
                        else None)
            for t in range(T):
                ml = step_losses(actions[t, :, 0:2], actions[t, :, 2], actions[t, :, 3],
                                 geo["gt_wp"][t], geo["gt_alt"][t], geo["gt_prog"][t],
                                 geo["heading_eps"][t])
                if nss_term is not None:
                    ml = ml + cfg.nss_w * nss_term[t]
                loss = loss + torch.where(geo["any_alive"][t], ml, 0.0)

        return RolloutOutputs(
            alive_pre=~geo["ended_pre"],
            alive_post=~geo["ended_post"],
            actions_wp=wp_norm.reshape(T, B, 2),
            actions_alt=alt_clip.reshape(T, B),
            pred_progress=actions[..., 3],
            gt_wp=geo["gt_wp"],
            gt_alt=geo["gt_alt"],
            gt_progress=geo["gt_prog"],
            corners=geo["corners_post"],
            directions=geo["dirs_post"],
            ha_precision=ha_prec,
            ha_recall=ha_rec,
            ha_nss=neg_nss,
            ha_valid=nss_valid & geo["any_alive"][:, None] & cfg.collect_ha_metrics,
            loss=loss,
            views=views if cfg.collect_views else None,
            pred_sal=pred_sal if cfg.collect_saliency else None,
            gt_sal=gt_sal if cfg.collect_saliency else None,
        )
