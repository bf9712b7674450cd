"""The train step and the eval rollouts (torch counterpart of
``avdn_tpu/train/step.py``).

Reference semantics (src/xview_et/agent.py:208-252 and 512-894): the
two-pass BERT encode (token features from the instructions, the 49-d query
from dialog + instructions), then a student-forced nav rollout through
``rollout.engine`` or a teacher-forced rollout, time-fused through
``rollout.fused`` by default (``--fused_teacher``).

Training (``make_train_step``):
* ``--feedback student`` runs a teacher-forced pass with the NSS weight 0
  and a student-forced pass with ``nss_w``, one backward over
  ``ml_weight·(L_t + L_s)/B`` (agent.py:226-235); ``--feedback teacher``
  one teacher pass, ``teacher_weight·L/B``;
* three optimizers (language tower, vision tower, VLN model), all Adam or
  AdamW at the same lr with torch's defaults (``train/optim.py``, optax's
  update order); the global-norm clip at 40 on the VLN group only
  (agent.py:247), and under ``darknet_in_vln`` (the LSTM family) a clip of
  its own on the vision tower, as the JAX package clips it;
* dropout from the step's ``torch.Generator`` and BatchNorm on batch
  statistics, the simulator feedback detached (``rollout/engine.py``);
* ``--grad_accum K``: K micro-batches, each loss divided by the full B,
  gradients summed, the BatchNorm running statistics chained;
* with a process group (k processes), each rank's batch is its slice of a
  global batch: the batch reductions inside the loss span the ranks
  (``parallel/batch.py``) and the gradients are averaged before the clip.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from avdn_tpu_torch.config import check_family
from avdn_tpu_torch.device import use_fp32_numerics
from avdn_tpu_torch.models.darknet import Darknet, fold_darknet_params, output_channels
from avdn_tpu_torch.models.darknet_quant import QuantDarknet, quantize_darknet_params
from avdn_tpu_torch.parallel.batch import global_batch
from avdn_tpu_torch.rollout.engine import (
    RGB_STD,
    EpisodeBatch,
    RolloutConfig,
    make_et_step,
    make_lstm_step,
    rollout,
)
from avdn_tpu_torch.rollout.fused import rollout_teacher_fused
from avdn_tpu_torch.train.optim import Adam, global_norm


@dataclasses.dataclass
class TrainBatch:
    episode: EpisodeBatch          # lang_* fields are placeholders
    ids_instr: torch.Tensor        # (B, L1) pass-1 tokens (instructions only)
    mask_instr: torch.Tensor       # (B, L1)
    ids_dialog: torch.Tensor       # (B, L2) pass-2 tokens (dialog + instr)
    mask_dialog: torch.Tensor      # (B, L2)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's ``TrainConfig`` (``avdn_tpu/train/step.py:53-108``),
    field for field."""

    family: str = "et"             # "et" | "lstm"
    feedback: str = "student"      # "student" (double rollout) | "teacher"
    lr: float = 1e-5
    optim: str = "adamW"           # "adam" | "adamW"
    weight_decay: Optional[float] = None  # None → torch default per optim
    ml_weight: float = 0.2
    teacher_weight: float = 1.0
    nss_w: float = 0.1
    nss_r: int = 0
    max_action_len: int = 10
    student_stop: float = 0.5      # 0.25 for the LSTM family
    grad_clip_vln: float = 40.0
    darknet_in_vln: bool = False   # True for LSTM (clip + step with vln group)
    single_bert_pass: bool = False  # --train_val_on_full mode skips pass 2
    grad_accum: int = 1            # micro-batch count for large global batches
    language_only: bool = False
    vision_only: bool = False
    no_direction: bool = False
    render_subsample: int = 1      # >1: low-res gather + upscale (opt-in)
    render_twopass: bool = False   # full-res two-pass warp
    render_crop: int = 512         # two-pass source window, px
    render_bf16: bool = True       # bf16 two-pass weights (fp32 on the CPU)
    fold_bn_eval: bool = True      # fold BN + input norm into eval conv weights
    remat: bool = False            # rematerialise the train step loop's steps
    remat_policy: str = "full"     # "full" | "dots"
    fused_teacher: bool = True
    fast_eval_trunk: bool = True
    et_decode_trunk: bool = False  # incremental eval-loop trunk decode (opt-in)
    quant: str = "none"            # "none" | "int8" eval/serving tower (opt-in)

    def rollout_cfg(self, teacher: bool, nss_w: float = 0.0, train: bool = False,
                    **kw) -> RolloutConfig:
        return RolloutConfig(
            max_action_len=self.max_action_len,
            teacher_forcing=teacher,
            stop_threshold=self.student_stop,
            train=train,
            nss_w=nss_w,
            nss_r=self.nss_r,
            language_only=self.language_only,
            no_direction=self.no_direction,
            render_subsample=self.render_subsample,
            render_twopass=self.render_twopass,
            render_crop=self.render_crop,
            render_bf16=self.render_bf16,
            fused_teacher=self.fused_teacher,
            fast_eval_trunk=self.fast_eval_trunk,
            et_decode_trunk=self.et_decode_trunk,
            remat=self.remat and train,
            remat_policy=self.remat_policy,
            **kw,
        )


def _encode_language(bert_model, batch: TrainBatch, cfg: TrainConfig,
                     generator: Optional[torch.Generator] = None):
    """The reference's two-pass BERT quirk (agent.py:521-538): token features
    from the instructions-only pass; the 49-d head query from the
    full-dialog pass. ``generator`` draws the dropout masks in train mode."""
    lang_feat, lang_cls, _ = bert_model(batch.ids_instr, batch.mask_instr, generator)
    if not cfg.single_bert_pass:
        _, lang_cls, _ = bert_model(batch.ids_dialog, batch.mask_dialog, generator)
    return lang_feat, lang_cls


def _run_family_rollout(cfg: TrainConfig, roll_cfg: RolloutConfig, models,
                        bert_out, batch: TrainBatch, map_bank, generator):
    """The family's rollout: teacher forcing with ``fused_teacher`` takes
    the time-fused path, everything else the engine's step loop with the
    family's closure (the branch of the JAX driver)."""
    darknet_model, vln_model = models
    lang_feat, lang_cls = bert_out
    ep = dataclasses.replace(batch.episode, lang_feat=lang_feat, lang_cls=lang_cls,
                             lang_mask=batch.mask_instr.bool())
    if roll_cfg.teacher_forcing and roll_cfg.fused_teacher:
        return rollout_teacher_fused(map_bank=map_bank, batch=ep, cfg=roll_cfg,
                                     family=cfg.family, darknet_model=darknet_model,
                                     vln_model=vln_model, generator=generator)
    make_step = make_et_step if cfg.family == "et" else make_lstm_step
    step, init_state = make_step(darknet_model, vln_model, ep, roll_cfg, generator)
    init = init_state(output_channels(darknet_model.cfg)[-1], 49)
    out, _ = rollout(map_bank=map_bank, batch=ep, cfg=roll_cfg, model_step=step,
                     init_model_state=init, generator=generator)
    return out


def check_rollout_supported(cfg: TrainConfig) -> None:
    """Raise ``ValueError`` for a family that does not exist."""
    check_family(cfg.family)


def check_train_supported(cfg: TrainConfig) -> None:
    """Raise ``ValueError`` for a malformed train config."""
    check_rollout_supported(cfg)
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"--remat_policy {cfg.remat_policy!r}: choose 'full' or 'dots'")
    if cfg.feedback not in ("student", "teacher"):
        raise ValueError(f"--feedback {cfg.feedback!r}: choose 'student' or 'teacher'")
    if cfg.grad_accum < 1:
        raise ValueError(f"--grad_accum {cfg.grad_accum} must be at least 1")


# ------------------------------------------------------------- training --


@dataclasses.dataclass
class TrainState:
    """The three modules (parameters and BatchNorm running statistics), their
    three optimizers, the step count and the model family (which sets the
    checkpoint layout, ``train/checkpoints.py``)."""

    bert: torch.nn.Module
    darknet: torch.nn.Module
    vln: torch.nn.Module
    opt_bert: Adam
    opt_darknet: Adam
    opt_vln: Adam
    step: int = 0
    family: str = "et"

    def models(self):
        return self.bert, self.darknet, self.vln

    def optimizers(self):
        return self.opt_bert, self.opt_darknet, self.opt_vln


def _make_optimizer(cfg: TrainConfig, module: torch.nn.Module, with_clip: bool) -> Adam:
    """Adam or AdamW at ``cfg.lr`` (b1 0.9, b2 0.999, eps 1e-8, AdamW's
    weight decay 0.01 unless set), after a global-norm clip at
    ``cfg.grad_clip_vln`` with ``with_clip``."""
    if cfg.optim == "adamW":
        wd = 0.01 if cfg.weight_decay is None else cfg.weight_decay
    elif cfg.optim == "adam":
        wd = 0.0
    else:
        raise ValueError(cfg.optim)
    return Adam(module.named_parameters(), cfg.lr, b1=0.9, b2=0.999, eps=1e-8,
                weight_decay=wd, clip=cfg.grad_clip_vln if with_clip else None)


def create_train_state(cfg: TrainConfig, bert, darknet, vln) -> TrainState:
    """A fresh train state over the modules' current weights."""
    return TrainState(bert=bert, darknet=darknet, vln=vln,
                      opt_bert=_make_optimizer(cfg, bert, with_clip=False),
                      opt_darknet=_make_optimizer(cfg, darknet,
                                                  with_clip=cfg.darknet_in_vln),
                      opt_vln=_make_optimizer(cfg, vln, with_clip=True),
                      family=cfg.family)


def _micro_batch(batch: TrainBatch, k: int, K: int) -> TrainBatch:
    """Micro-batch ``k`` of ``K``: every per-item tensor's k-th slice of the
    episode dimension."""
    def cut(x):
        m = x.shape[0] // K
        return x[k * m:(k + 1) * m]

    ep = dataclasses.replace(batch.episode, **{
        f.name: cut(getattr(batch.episode, f.name))
        for f in dataclasses.fields(batch.episode)})
    return TrainBatch(episode=ep, ids_instr=cut(batch.ids_instr),
                      mask_instr=cut(batch.mask_instr),
                      ids_dialog=cut(batch.ids_dialog),
                      mask_dialog=cut(batch.mask_dialog))


def make_loss_fn(cfg: TrainConfig, bert_model, darknet_model, vln_model) -> Callable:
    """``loss_fn(batch, map_bank, generator, loss_norm) -> loss``: the train
    loss of ``batch`` under autograd (the JAX ``make_train_step.loss_fn``),
    divided by ``loss_norm`` (the full batch size)."""
    models = (darknet_model, vln_model)

    def loss_fn(batch: TrainBatch, map_bank, generator, loss_norm: int):
        bert_out = _encode_language(bert_model, batch, cfg, generator)
        if cfg.feedback == "teacher":
            roll = cfg.rollout_cfg(teacher=True, nss_w=cfg.nss_w, train=True)
            out = _run_family_rollout(cfg, roll, models, bert_out, batch, map_bank,
                                      generator)
            return cfg.teacher_weight * out.loss / loss_norm
        # teacher-forced pass with nss off, then student-forced with nss
        # (agent.py:231-235)
        out_t = _run_family_rollout(
            cfg, cfg.rollout_cfg(teacher=True, nss_w=0.0, train=True), models,
            bert_out, batch, map_bank, generator)
        out_s = _run_family_rollout(
            cfg, cfg.rollout_cfg(teacher=False, nss_w=cfg.nss_w, train=True), models,
            bert_out, batch, map_bank, generator)
        return cfg.ml_weight * (out_t.loss + out_s.loss) / loss_norm

    return loss_fn


def _mean_over_ranks(tensors, group, bucket_numel: int = 1 << 25) -> None:
    """Average ``tensors`` in place over the ranks of ``group``: all-reduce
    SUM of flat float32 buckets of at most ``bucket_numel`` elements, then
    divide by the world size (every rank gets the same bytes)."""
    world = dist.get_world_size(group)
    start = 0
    while start < len(tensors):
        stop, n = start, 0
        while stop < len(tensors) and (
                stop == start or n + tensors[stop].numel() <= bucket_numel):
            n += tensors[stop].numel()
            stop += 1
        bucket = tensors[start:stop]
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat /= world
        torch._foreach_copy_(bucket, [piece.view_as(t) for piece, t in zip(
            flat.split([t.numel() for t in bucket]), bucket)])
        start = stop


def make_train_step(cfg: TrainConfig, bert_model, darknet_model, vln_model,
                    group=None) -> Callable:
    """Build ``train_step(state, map_bank, batch, generator) -> metrics``:
    one optimizer step of ``state`` (in place; ``state.step`` += 1) on
    ``batch``. ``generator`` (on the batch's device) draws the dropout masks
    and the loss's heading jitter. Returns ``{"loss", "grad_norm_vln",
    "grad_norm_bert"}`` as 0-d tensors on the device (no host sync); the
    grad norms are taken before the clip.

    With ``group`` (a ``torch.distributed`` process group) each rank's
    ``batch`` is its slice of the global batch, as in the JAX package's
    multi-process step: the batch reductions inside the loss are global
    (``parallel.batch.global_batch``), each rank's loss is divided by its
    own B, and the gradients and the loss are then averaged over the ranks,
    before the clip and the optimizers. Given the same generator state on
    every rank, the ranks stay bit-identical and equal one process at the
    global batch. Without it the step issues no collective."""
    check_train_supported(cfg)
    use_fp32_numerics()
    loss_fn = make_loss_fn(cfg, bert_model, darknet_model, vln_model)

    def train_step(state: TrainState, map_bank, batch: TrainBatch,
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        for m in state.models():
            m.train()
            m.zero_grad(set_to_none=True)
        K = cfg.grad_accum
        full_B = batch.ids_instr.shape[0]
        if full_B % K != 0:
            raise ValueError(f"--grad_accum {K} must evenly divide batch_size {full_B}")
        loss = torch.zeros((), device=batch.ids_instr.device)
        with global_batch(group) if group is not None else contextlib.nullcontext():
            for k in range(K):
                # each micro loss over the FULL batch size: the summed grads
                # are the full batch's; BatchNorm's running statistics chain
                # in order
                mb = batch if K == 1 else _micro_batch(batch, k, K)
                micro = loss_fn(mb, map_bank, generator, full_B)
                micro.backward()
                loss = loss + micro.detach()
        grads = [[torch.zeros_like(p) if p.grad is None else p.grad
                  for p in opt.params] for opt in state.optimizers()]
        if group is not None:  # the mean gradient (and loss) over the ranks
            _mean_over_ranks([g for gs in grads for g in gs] + [loss.reshape(1)], group)
        norms = [global_norm(g) for g in grads]
        for opt, g, norm in zip(state.optimizers(), grads, norms):
            opt.step(g, norm)
        for m in state.models():
            m.zero_grad(set_to_none=True)
        state.step += 1
        return {"loss": loss, "grad_norm_vln": norms[2], "grad_norm_bert": norms[0]}

    return train_step


def make_eval_rollout(cfg: TrainConfig, bert_model, darknet_model, vln_model,
                      teacher: bool, collect_ha: bool = False,
                      compute_losses: bool = True,
                      collect_debug: bool = False) -> Callable:
    """Build the eval rollout ``eval_fn(map_bank, batch, generator) ->
    RolloutOutputs`` over the models' current weights.

    ``teacher=False`` is the nav eval (student-forced closed loop; with
    ``compute_losses=False`` the serving rollout); ``teacher=True`` with
    ``collect_ha`` is the human-attention eval (src/xview_et/main.py:188-239).
    ``collect_debug`` also returns the per-step views and pred/GT saliency
    maps for the inference-mode debug images (agent.py:694-706).

    ``cfg.fold_bn_eval`` (default): the vision tower runs as its folded
    inference variant — eval-mode BatchNorm and the input ``/std`` are folded
    into the conv weights at each call (``fold_darknet_params``), in the
    tower's compute dtype. ``cfg.quant == "int8"`` (which needs the fold)
    runs the folded tower quantized (``models/darknet_quant.py``), its int8
    weights derived from the folded ones at each call. Every call runs under
    ``torch.inference_mode`` with the models in eval mode. Whatever the
    towers' dtype, float32 work stays float32: building the rollout sets
    ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` to False.
    """
    check_rollout_supported(cfg)
    quant = cfg.quant == "int8"
    if cfg.quant not in ("none", "int8"):
        raise ValueError(f"unknown quant mode {cfg.quant!r} (choose 'none' or 'int8')")
    if quant and not cfg.fold_bn_eval:
        raise ValueError("--quant int8 requires --fold_bn_eval (the quantizer "
                         "consumes the bias-carrying folded conv form)")
    use_fp32_numerics()
    if cfg.fold_bn_eval:
        dev = next(darknet_model.parameters()).device
        folded = (QuantDarknet(darknet_model.cfg) if quant else
                  Darknet(darknet_model.cfg, folded=True, dtype=darknet_model.dtype))
        folded = folded.to(dev).eval()
    roll = cfg.rollout_cfg(teacher, collect_ha_metrics=collect_ha,
                           compute_losses=compute_losses,
                           collect_views=collect_debug,
                           collect_saliency=collect_debug,
                           fused_input_norm=cfg.fold_bn_eval)

    @torch.inference_mode()
    def eval_fn(map_bank, batch: TrainBatch, generator: torch.Generator):
        for m in (bert_model, darknet_model, vln_model):
            m.eval()
        bert_out = _encode_language(bert_model, batch, cfg)
        dk = darknet_model
        if cfg.fold_bn_eval:
            params = fold_darknet_params(darknet_model.cfg, darknet_model.state_dict(),
                                         input_std=RGB_STD)
            if quant:
                folded.qparams = quantize_darknet_params(darknet_model.cfg, params)
            else:
                folded.load_state_dict(params)
            dk = folded
        return _run_family_rollout(cfg, roll, (dk, vln_model), bert_out, batch,
                                   map_bank, generator)

    return eval_fn
