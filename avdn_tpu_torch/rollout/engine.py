"""The episode engine — render → encode → act → step (torch counterpart of
``avdn_tpu/rollout/engine.py``).

The JAX package runs the whole episode under one ``lax.scan``; here the
scan is a Python loop over all T steps whose state stays on the device: the
map bank, the renderer, dynamics and oracle (``avdn_tpu_torch.sim``) and the
model with fixed-shape padded history. Nothing in the loop reads a value
back to the host.

Semantics preserved from the reference (each deliberate):
* losses accumulate over ALL batch items every step, ended or not
  (agent.py:663-669 has no ended guard);
* movement is gated on the CURRENT stop decision only — previously-ended
  items still zoom/move invisibly (agent.py:733-757); their trajectory is
  simply no longer logged;
* the stop threshold is 0.5 teacher-forced (``STOP_THRESHOLD``) and
  ``cfg.stop_threshold`` student (0.5 for ET);
* a step where every item is already ended contributes no loss (the
  reference breaks out of the loop, agent.py:771);
* in train mode the simulator feedback is detached (the reference steps
  its env on host numpy, agent.py:724-755): render, oracle and dynamics run
  outside autograd, and a step's loss reaches the model only through that
  step's outputs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch

from avdn_tpu_torch.models import et_fast
from avdn_tpu_torch.models.darknet import frozen_running_stats, rematerialising
from avdn_tpu_torch.models.lstm import heading_radians, init_lstm_state
from avdn_tpu_torch.ops.losses import step_losses
from avdn_tpu_torch.ops.saliency import saliency_head_reductions, saliency_upsample
from avdn_tpu_torch.parallel.batch import batch_all, batch_rand
from avdn_tpu_torch.sim.dynamics import move_view_corners_batch
from avdn_tpu_torch.sim.oracle import teacher_action_batch
from avdn_tpu_torch.sim.render import render_batch
from avdn_tpu_torch.sim.warp2pass import render_batch_twopass
from avdn_tpu_torch.utils.logging import span

_PI_REF = 3.14159

#: the stop decision's progress threshold, teacher-forced and student (ET)
STOP_THRESHOLD = 0.5

#: RGB normalisation stats (the reference's xView constants,
#: src/xview_et/agent.py:115-116, applied after the BGR→RGB flip — the map
#: bank is RGB from the start so they apply directly).
RGB_MEAN = (60.134, 49.697, 40.746)
RGB_STD = (29.99, 24.498, 22.046)


@dataclasses.dataclass
class EpisodeBatch:
    """Device-resident episode batch. All coordinates are GPS *offsets* from
    each map's bottom-left corner (float32-safe, see sim.dynamics)."""

    map_idx: torch.Tensor        # (B,) int — index into the map bank
    start_corners: torch.Tensor  # (B, 4, 2)
    start_dir: torch.Tensor      # (B,) degrees
    extent: torch.Tensor         # (B, 2) map extent in degrees
    lat_ratio: torch.Tensor      # (B,) degrees per pixel
    gt_corners: torch.Tensor     # (B, Tg, 4, 2) padded GT path
    gt_len: torch.Tensor         # (B,)
    circles: torch.Tensor        # (B, C, 3) attention circles in img coords
    n_circles: torch.Tensor      # (B,)
    lang_feat: torch.Tensor      # (B, L, D) BERT token features (pass 1)
    lang_cls: torch.Tensor       # (B, 49) BERT head output (pass 2)
    lang_mask: torch.Tensor      # (B, L) bool — valid language tokens


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    """The rollout's settings (the JAX config's, field for field)."""

    max_action_len: int = 10
    teacher_forcing: bool = True       # feedback mode
    stop_threshold: float = 0.5        # student stop (ET 0.5)
    compute_losses: bool = True        # False for serving / test_unseen
    train: bool = False                # dropout + BN batch statistics
    nss_w: float = 0.0                 # weight of the −NSS loss term
    nss_r: int = 0
    language_only: bool = False        # zero out visual features (ablation)
    no_direction: bool = False         # zero out heading features (ablation)
    collect_ha_metrics: bool = False   # per-step HA precision/recall + NSS
    collect_views: bool = False        # debug: return rendered views
    collect_saliency: bool = False     # debug: return pred/GT saliency maps
    render_subsample: int = 1          # >1: low-res gather + upscale (opt-in)
    render_twopass: bool = False       # full-res two-pass warp (sim/warp2pass.py)
    render_crop: int = 512             # two-pass source window (>= max view px)
    render_bf16: bool = True           # bf16 two-pass weights on the card
    fused_input_norm: bool = False     # (x−mean)/std folded into conv 1
    fused_teacher: bool = True         # teacher forcing: time-fused rollout
    # (rollout/fused.py) — the trajectory is model-independent, so render
    # and towers run once over all T·B views; student mode always steps
    fast_eval_trunk: bool = True       # fused teacher eval: ONE trunk pass
    # (models/et_fast.py) instead of T step-masked re-encodes
    et_decode_trunk: bool = False      # step loop: incremental KV decode of
    # the trunk (models/et_fast.py) instead of the full re-encode; exact up
    # to reassociation, opt-in (it flips a borderline fixture episode)
    remat: bool = False                # train step loop: recompute each
    # step's model in the backward pass (torch.utils.checkpoint); the render,
    # oracle and dynamics stay outside (gradient-free), so the views are
    # saved, as the JAX "dots" policy saves the tagged render outputs. The
    # fused teacher rollout is never rematerialised (JAX: the same)
    remat_policy: str = "full"         # "full": save the step's inputs only;
    # "dots": also the outputs of its matrix products and convolutions


@dataclasses.dataclass
class RolloutOutputs:
    """Per-step (leading axis T) trajectory records for host-side metrics."""

    alive_pre: torch.Tensor      # (T, B) item alive at model-call time
    alive_post: torch.Tensor     # (T, B) alive after the stop update
    actions_wp: torch.Tensor     # (T, B, 2) normalised predicted waypoint
    actions_alt: torch.Tensor    # (T, B) clipped predicted altitude
    pred_progress: torch.Tensor  # (T, B) raw predicted progress
    gt_wp: torch.Tensor          # (T, B, 2)
    gt_alt: torch.Tensor         # (T, B)
    gt_progress: torch.Tensor    # (T, B)
    corners: torch.Tensor        # (T, B, 4, 2) post-step corners
    directions: torch.Tensor     # (T, B)
    ha_precision: torch.Tensor   # (T, B)
    ha_recall: torch.Tensor      # (T, B)
    ha_nss: torch.Tensor         # (T, B)
    ha_valid: torch.Tensor       # (T, B)
    loss: torch.Tensor           # () summed ml loss (pre ml_weight scaling)
    views: Optional[torch.Tensor] = None     # (T, B, 224, 224, 3) debug dumps
    pred_sal: Optional[torch.Tensor] = None  # (T, B, 224, 224)
    gt_sal: Optional[torch.Tensor] = None    # (T, B, 224, 224)

    def cpu(self) -> "RolloutOutputs":
        return RolloutOutputs(**{
            f.name: None if getattr(self, f.name) is None else getattr(self, f.name).cpu()
            for f in dataclasses.fields(self)})


def _corners_to_img(corners, extent, lat_ratio):
    """GPS offsets (lat, lng) → map image (x, y) (src/env.py:189-196)."""
    x = corners[..., 1] / lat_ratio[:, None]
    y = (extent[:, 0:1] - corners[..., 0]) / lat_ratio[:, None]
    return torch.stack([x, y], dim=-1)


def render_views(map_bank, batch: EpisodeBatch, corners, cfg: RolloutConfig):
    """Render the batch's current views + GT saliency in ``cfg``'s render
    mode: the two-pass warp, or the exact gather (subsampled with
    ``render_subsample`` > 1). Shared by the step loop and the fused
    teacher path."""
    with span("sim.render"):
        quad_img = _corners_to_img(corners, batch.extent, batch.lat_ratio)
        if cfg.render_twopass:
            return render_batch_twopass(map_bank, batch.map_idx, quad_img,
                                        batch.circles, batch.n_circles,
                                        crop_hw=cfg.render_crop, bf16=cfg.render_bf16)
        return render_batch(map_bank, batch.map_idx, quad_img, batch.circles,
                            batch.n_circles, subsample=cfg.render_subsample)


def decode_action(action):
    """Raw model action (B, 4) → (wp_norm, alt_clip, prog_clip) exactly as
    the reference decodes (agent.py:640-653): ∞-ball clamp + [0,1] clips."""
    action = action.float()
    pred_wp = action[:, 0:2]
    denom = torch.clamp(pred_wp.abs().max(dim=-1, keepdim=True).values, min=1.0)
    return pred_wp / denom, action[:, 2].clamp(0.0, 1.0), action[:, 3].clamp(0.0, 1.0)


def dynamics_update(corners, directions, act_wp, act_alt, prog_stop, thresh,
                    t, T, extent):
    """One simulator transition (agent.py:733-757): the stop decision gates
    the move; items that stop keep their corners.
    Returns (stop_now, new_corners, new_dirs)."""
    with span("sim.dynamics"):
        stop_now = (prog_stop > thresh) | (t == T - 1)
        a_dir = torch.remainder(
            (torch.atan2(act_wp[:, 0], act_wp[:, 1]) / _PI_REF + 2.0) / 2.0, 1.0)
        half_edge = torch.linalg.vector_norm(corners[:, 0] - corners[:, 1], dim=-1) / 2.0
        a_dist = torch.linalg.vector_norm(act_wp, dim=-1) * half_edge
        a_alt_m = torch.round(act_alt * 360.0) + 40.0
        moved, moved_dir = move_view_corners_batch(
            corners, torch.round(a_dir * 360.0), a_dist, a_alt_m, extent, directions)
        do_move = ~stop_now
        new_corners = torch.where(do_move[:, None, None], moved, corners)
        new_dirs = torch.where(do_move, moved_dir, directions)
        return stop_now, new_corners, new_dirs


def rollout(*, map_bank, batch: EpisodeBatch, cfg: RolloutConfig,
            model_step: Callable, init_model_state: Any,
            generator: torch.Generator):
    """Run one full episode batch: T steps, all on the batch's device.

    ``model_step(model_state, images, dir_feat, step_index, ended)`` →
    ``(new_model_state, action (B, 4), saliency head (B, 8, 8))``; ``images`` are
    the normalised (B, 224, 224, 3) views. ``generator`` draws the
    reference's heading jitter of the loss (on the batch's device).
    Returns ``(RolloutOutputs, final model_state)``; with ``cfg.train`` the
    loss carries the autograd graph of the model's outputs.
    """
    with span("rollout"):
        B = batch.start_corners.shape[0]
        T = cfg.max_action_len
        dev = batch.start_corners.device
        mean = torch.tensor(RGB_MEAN, dtype=torch.float32, device=dev)
        std = torch.tensor(RGB_STD, dtype=torch.float32, device=dev)
        zeros = torch.zeros((B,), dtype=torch.float32, device=dev)

        corners = batch.start_corners.float()
        directions = batch.start_dir.float()
        ended = torch.zeros((B,), dtype=torch.bool, device=dev)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        model_state = init_model_state
        ys = []
        for t in range(T):
            any_alive = ~batch_all(ended)

            # ---- render current views on device ----
            with torch.no_grad():
                views, gt_sal = render_views(map_bank, batch, corners, cfg)
            # input normalisation — the /std is folded into the first conv when
            # the eval tower is BN-folded (fold_darknet_params); the mean
            # subtraction stays here (the conv zero-pads the NORMALISED tensor)
            x = views - mean if cfg.fused_input_norm else (views - mean) / std

            rad = directions / 180.0 * _PI_REF
            dir_feat = torch.stack([torch.sin(rad), torch.cos(rad)], dim=-1)
            if cfg.no_direction:
                dir_feat = torch.zeros_like(dir_feat)

            # ---- model ----
            model_state, action, sal_head = model_step(model_state, x, dir_feat, t, ended)
            action = action.float()
            # losses see the RAW head outputs (agent.py:663-669); the decode
            # only feeds the trajectory records and student feedback
            pred_wp, pred_alt, pred_prog = action[:, 0:2], action[:, 2], action[:, 3]
            wp_norm, alt_clip, prog_clip = decode_action(action)

            # ---- the saliency maps and their statistics (the CUDA kernels on
            # the card: the fused forward, and under autograd the head's
            # gradient) ----
            if cfg.compute_losses or cfg.collect_ha_metrics:
                pred_sal, neg_nss, nss_valid, ha_prec, ha_rec = saliency_head_reductions(
                    sal_head, gt_sal, nss_r=cfg.nss_r)
            else:
                neg_nss, ha_prec, ha_rec = zeros, zeros, zeros
                nss_valid = torch.zeros((B,), dtype=torch.bool, device=dev)
                if cfg.collect_saliency:
                    pred_sal = saliency_upsample(sal_head.detach(),
                                                 gt_sal.shape[-1]).float()

            # ---- oracle + losses ----
            if cfg.compute_losses:
                with torch.no_grad():
                    oracle = teacher_action_batch(corners, ended, batch.gt_corners,
                                                  batch.gt_len, cfg.teacher_forcing)
                gt_wp = oracle["waypoint_ratio"]
                gt_alt = oracle["altitude"]
                gt_prog = oracle["progress"]
                heading_eps = 1e-5 * batch_rand((B,), generator, dev)
                ml = step_losses(pred_wp, pred_alt, pred_prog, gt_wp, gt_alt,
                                 gt_prog, heading_eps)
                if cfg.nss_w:
                    ml = ml + cfg.nss_w * torch.where(nss_valid, neg_nss, 0.0).sum()
                loss = loss + torch.where(any_alive, ml, 0.0)
            else:
                gt_wp = torch.zeros((B, 2), dtype=torch.float32, device=dev)
                gt_alt, gt_prog = zeros, zeros

            # ---- feedback + stop decision (detached: the simulator is not part
            # of the reference's autodiff graph, agent.py:724-755) ----
            if cfg.teacher_forcing:
                act_wp, act_alt, prog_stop = gt_wp, gt_alt, gt_prog
                thresh = STOP_THRESHOLD
            else:
                act_wp, act_alt, prog_stop = wp_norm, alt_clip, prog_clip
                thresh = cfg.stop_threshold
            with torch.no_grad():
                stop_now, new_corners, new_dirs = dynamics_update(
                    corners, directions, act_wp.detach(), act_alt.detach(),
                    prog_stop.detach(), thresh, t, T, batch.extent)
            ended_next = ended | stop_now

            y = dict(
                alive_pre=~ended,
                alive_post=~ended_next,
                actions_wp=wp_norm,
                actions_alt=alt_clip,
                pred_progress=pred_prog,
                gt_wp=gt_wp,
                gt_alt=gt_alt,
                gt_progress=gt_prog,
                corners=new_corners,
                directions=new_dirs,
                ha_precision=ha_prec,
                ha_recall=ha_rec,
                ha_nss=neg_nss,
                # the reference records HA metrics for every item while the
                # episode loop is still running, ended or not (agent.py:673-691)
                ha_valid=nss_valid & any_alive & cfg.collect_ha_metrics,
            )
            if cfg.collect_views:
                y["views"] = views
            if cfg.collect_saliency:
                # per-step attention debug dumps (agent.py:694-706)
                y["pred_sal"] = pred_sal
                y["gt_sal"] = gt_sal
            ys.append(y)
            corners, directions, ended = new_corners, new_dirs, ended_next

        stacked = {k: torch.stack([y[k] for y in ys]) for k in ys[0]}
        return RolloutOutputs(loss=loss, **stacked), model_state


def make_et_step(darknet_model, et_model, batch: EpisodeBatch, cfg: RolloutConfig,
                 generator: Optional[torch.Generator] = None):
    """ET closure: pads history to T and re-encodes the full episode each
    step (the reference's O(T²) semantics, agent.py:605-630, kept for model
    parity — the transformer *is* history-conditioned). In eval the history
    buffers are updated in place; with ``cfg.train`` they are rebuilt out of
    place from the per-step features each step (autograd needs every step's
    buffer as it was), and the models' dropout draws from ``generator``. With
    ``cfg.et_decode_trunk`` (eval only) the re-encode is replaced by the
    incremental KV decode (``_make_et_decode_step``)."""
    if cfg.et_decode_trunk and not cfg.train:
        return _make_et_decode_step(darknet_model, et_model, batch, cfg)
    B = batch.lang_feat.shape[0]
    T = cfg.max_action_len
    dev = batch.lang_feat.device

    def init_state(feat_channels: int, spatial: int):
        return {
            "frames": torch.zeros((B, T, feat_channels, spatial), device=dev),
            "dirs": torch.zeros((B, T, 2), device=dev),
            "lengths": torch.zeros((B,), dtype=torch.long, device=dev),
        }

    def model(x, pad, dirs, lengths, *prev_feats):
        """The step's differentiable part (train mode): the vision tower on
        the step's views, the history rebuilt out of place from the
        per-step features (autograd needs every step's buffer as it was),
        and the trunk."""
        feats = darknet_model(x)
        if cfg.language_only:
            feats = torch.zeros_like(feats)
        frames = torch.cat([torch.stack([*prev_feats, feats], 1), pad], 1)
        action, sal = et_model(batch.lang_feat, batch.lang_cls, frames, dirs,
                               lengths, generator)
        return feats, action, sal

    if cfg.train and cfg.remat:
        model = rematerialised(model, cfg.remat_policy, generator)

    def step(state, x, dir_feat, t, ended):
        state["lengths"] = state["lengths"] + (~ended).long()
        if cfg.train:
            state["dirs"] = torch.cat([state["dirs"][:, :t], dir_feat[:, None],
                                       state["dirs"][:, t + 1:]], 1)
            prev = state.get("feats", [])
            feats, action, sal = model(x, state["frames"][:, len(prev) + 1:],
                                       state["dirs"], state["lengths"], *prev)
            state["feats"] = prev + [feats]
            return state, action, sal
        feats = darknet_model(x)
        if cfg.language_only:
            feats = torch.zeros_like(feats)
        state["frames"][:, t] = feats
        state["dirs"][:, t] = dir_feat
        action, sal = et_model(batch.lang_feat, batch.lang_cls, state["frames"],
                               state["dirs"], state["lengths"], generator)
        return state, action, sal

    return step, init_state


def make_lstm_step(darknet_model, lstm_model, batch: EpisodeBatch, cfg: RolloutConfig,
                   generator: Optional[torch.Generator] = None):
    """HAA-LSTM closure (the reference's recurrent variant,
    src/xview_lstm/agent.py:592-602): the vision tower on the step's views
    (BatchNorm on batch statistics in train mode), then one ``HAALSTM`` step
    from the carried state ``(h_dir, c_dir, h_vis, c_vis)``, the heading
    taken from the engine's (sin, cos) features (``heading_radians``). Its
    dropout draws from ``generator``; with ``cfg.train`` and ``cfg.remat``
    the tower and the cell are rematerialised together."""
    B = batch.lang_feat.shape[0]
    dev = batch.lang_feat.device

    def init_state(*_):
        return {"lstm": init_lstm_state(B, lstm_model.cfg, device=dev)}

    def model(x, dir_feat, *state):
        feats = darknet_model(x)
        if cfg.language_only:
            feats = torch.zeros_like(feats)
        new, action, sal = lstm_model(heading_radians(dir_feat), feats, batch.lang_cls,
                                      batch.lang_feat, state, generator)
        return (*new, action, sal)

    return _recurrent_step(model, cfg, generator), init_state


def make_lstm_vision_only_step(darknet_model, lstm_model, batch: EpisodeBatch,
                               cfg: RolloutConfig,
                               generator: Optional[torch.Generator] = None):
    """HAA-LSTM vision-only ablation closure (src/models/vln_model.py:255-343):
    no language inputs at all."""
    B = batch.start_corners.shape[0]
    dev = batch.start_corners.device

    def init_state(*_):
        return {"lstm": init_lstm_state(B, lstm_model.cfg, device=dev)}

    def model(x, dir_feat, *state):
        new, action, sal = lstm_model(heading_radians(dir_feat), darknet_model(x), state,
                                      generator)
        return (*new, action, sal)

    return _recurrent_step(model, cfg, generator), init_state


def make_lstm_lang_only_step(lstm_model, batch: EpisodeBatch, cfg: RolloutConfig,
                             generator: Optional[torch.Generator] = None):
    """HAA-LSTM language-only ablation closure (src/models/vln_model.py:
    349-412): no vision tower. The variant has no saliency head; its head is
    zero (the JAX closure's zero map, upsampled), and the rollout's
    statistics of it are those of JAX's zero map."""
    B = batch.start_corners.shape[0]
    dev = batch.start_corners.device
    hid = lstm_model.cfg.hidden_size

    def init_state(*_):
        return {"lstm": tuple(torch.zeros((B, hid), device=dev) for _ in range(2))}

    def model(x, dir_feat, *state):
        new, action = lstm_model(heading_radians(dir_feat), batch.lang_feat, state,
                                 generator)
        return (*new, action, torch.zeros((x.shape[0], 8, 8), device=x.device))

    return _recurrent_step(model, cfg, generator), init_state


def _recurrent_step(model, cfg: RolloutConfig, generator):
    """The engine's ``model_step`` over a recurrent ``model(x, dir_feat,
    *state) -> (*new_state, action, saliency head)``, rematerialised under
    ``cfg.train`` and ``cfg.remat``."""
    if cfg.train and cfg.remat:
        model = rematerialised(model, cfg.remat_policy, generator)

    def step(state, x, dir_feat, t, ended):
        *new, action, sal = model(x, dir_feat, *state["lstm"])
        return {"lstm": tuple(new)}, action, sal

    return step


#: the ops whose outputs ``--remat_policy dots`` saves: the matrix products
#: and the convolutions (JAX's ``dots_with_no_batch_dims_saveable`` saves
#: only the products without batch dimensions; a different choice of what to
#: keep, the same values either way)
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.convolution.default}


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def rematerialised(fn: Callable, policy: str, generator: torch.Generator):
    """``fn`` under ``torch.utils.checkpoint``: its forward keeps only its
    inputs (``policy`` "full") or also the outputs of its matrix products and
    convolutions ("dots"), and the backward pass recomputes the rest. The
    recompute is the forward again, exactly: it draws its dropout masks from
    ``generator`` restored to the state the forward started from (and
    leaves ``generator`` as it found it), and it does not update the
    BatchNorm running statistics a second time (``frozen_running_stats``).
    Darknet calls inside run eager (``rematerialising``): a replayed graph
    would keep the activations the recompute is there to drop.
    Nothing in ``fn`` may sync with the host or draw other random numbers."""
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    if policy not in ("full", "dots"):
        raise ValueError(f"remat policy {policy!r}: choose 'full' or 'dots'")
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _dots_policy)

    def call(*args):
        start = generator.get_state()
        forward_done = []

        def run(*inputs):
            if not forward_done:
                forward_done.append(True)
                return fn(*inputs)
            outer = generator.get_state()
            generator.set_state(start)
            try:
                with frozen_running_stats():
                    return fn(*inputs)
            finally:
                generator.set_state(outer)

        with rematerialising():
            return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False,
                              **kw)

    return call


def _make_et_decode_step(darknet_model, et_model, batch: EpisodeBatch,
                         cfg: RolloutConfig):
    """Incremental-decode ET closure (eval only): each step runs only the
    two new tokens through the trunk against the cached language and
    history keys/values (``models/et_fast.py``). Exact up to float
    reassociation; opt-in (``--et_decode_trunk``)."""
    B = batch.lang_feat.shape[0]
    T = cfg.max_action_len
    dev = batch.lang_feat.device
    dtype = et_model.dtype
    # episode constants: per-layer language K/V, computed once
    lang_kv = et_fast.make_lang_cache(et_model, batch.lang_feat, dtype=dtype)

    def init_state(feat_channels: int, spatial: int):
        return {"cache": et_fast.init_cache(et_model.cfg, B, T, dtype=dtype, device=dev),
                "lengths": torch.zeros((B,), dtype=torch.long, device=dev)}

    def step(state, x, dir_feat, t, ended):
        feats = darknet_model(x)
        if cfg.language_only:
            feats = torch.zeros_like(feats)
        state["lengths"] = state["lengths"] + (~ended).long()
        _, action, sal = et_fast.decode_step(
            et_model, lang_kv, state["cache"], batch.lang_cls, feats, dir_feat, t,
            state["lengths"], dtype=dtype)
        return state, action, sal

    return step, init_state
