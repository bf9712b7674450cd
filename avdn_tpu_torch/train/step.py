"""Eval rollouts (torch counterpart of the eval half of
``avdn_tpu/train/step.py``; the train step is not ported yet, ROADMAP.md
queue 1 item 10).

Reference semantics (src/xview_et/agent.py:512-894): the two-pass BERT
encode (token features from the instructions, the 49-d query from dialog +
instructions), then a student-forced nav rollout through ``rollout.engine``
or a teacher-forced human-attention rollout, time-fused through
``rollout.fused`` by default (``--fused_teacher``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from avdn_tpu_torch.device import use_fp32_numerics
from avdn_tpu_torch.models.darknet import Darknet, fold_darknet_params, output_channels
from avdn_tpu_torch.models.darknet_quant import QuantDarknet, quantize_darknet_params
from avdn_tpu_torch.rollout.engine import (
    RGB_STD,
    EpisodeBatch,
    RolloutConfig,
    make_et_step,
    rollout,
)
from avdn_tpu_torch.rollout.fused import rollout_teacher_fused


@dataclasses.dataclass
class TrainBatch:
    episode: EpisodeBatch          # lang_* fields are placeholders
    ids_instr: torch.Tensor        # (B, L1) pass-1 tokens (instructions only)
    mask_instr: torch.Tensor       # (B, L1)
    ids_dialog: torch.Tensor       # (B, L2) pass-2 tokens (dialog + instr)
    mask_dialog: torch.Tensor      # (B, L2)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The eval-side fields of the JAX ``TrainConfig``: what the eval
    rollouts read (the optimizer, loss-weight and remat fields come with
    training, ROADMAP.md queue 1 item 10)."""

    family: str = "et"
    nss_r: int = 0
    max_action_len: int = 10
    single_bert_pass: bool = False  # --train_val_on_full mode skips pass 2
    language_only: bool = False
    no_direction: bool = False
    render_subsample: int = 1      # >1: low-res gather + upscale (opt-in)
    render_twopass: bool = False   # full-res two-pass warp
    render_crop: int = 512         # two-pass source window, px
    render_bf16: bool = True       # bf16 two-pass weights (fp32 on the CPU)
    fold_bn_eval: bool = True      # fold BN + input norm into eval conv weights
    fused_teacher: bool = True
    fast_eval_trunk: bool = True
    et_decode_trunk: bool = False  # incremental eval-loop trunk decode (opt-in)
    quant: str = "none"            # "none" | "int8" eval/serving tower (opt-in)

    def rollout_cfg(self, teacher: bool, **kw) -> RolloutConfig:
        return RolloutConfig(
            max_action_len=self.max_action_len,
            teacher_forcing=teacher,
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
            **kw,
        )


def _encode_language(bert_model, batch: TrainBatch, cfg: TrainConfig):
    """The reference's two-pass BERT quirk (agent.py:521-538): token features
    from the instructions-only pass; the 49-d head query from the
    full-dialog pass."""
    lang_feat, lang_cls, _ = bert_model(batch.ids_instr, batch.mask_instr)
    if not cfg.single_bert_pass:
        _, lang_cls, _ = bert_model(batch.ids_dialog, batch.mask_dialog)
    return lang_feat, lang_cls


def _run_family_rollout(cfg: TrainConfig, roll_cfg: RolloutConfig, models,
                        bert_out, batch: TrainBatch, map_bank, generator):
    """ET rollout: teacher forcing with ``fused_teacher`` takes the
    time-fused path, everything else the engine's step loop (the branch of
    the JAX driver)."""
    darknet_model, vln_model = models
    lang_feat, lang_cls = bert_out
    ep = dataclasses.replace(batch.episode, lang_feat=lang_feat, lang_cls=lang_cls,
                             lang_mask=batch.mask_instr.bool())
    if roll_cfg.teacher_forcing and roll_cfg.fused_teacher:
        return rollout_teacher_fused(map_bank=map_bank, batch=ep, cfg=roll_cfg,
                                     family=cfg.family, darknet_model=darknet_model,
                                     vln_model=vln_model, generator=generator)
    step, init_state = make_et_step(darknet_model, vln_model, ep, roll_cfg)
    init = init_state(output_channels(darknet_model.cfg)[-1], 49)
    out, _ = rollout(map_bank=map_bank, batch=ep, cfg=roll_cfg, model_step=step,
                     init_model_state=init, generator=generator)
    return out


def check_rollout_supported(cfg: TrainConfig) -> None:
    """Raise ``NotImplementedError`` for what the port cannot run yet."""
    if cfg.family != "et":
        raise NotImplementedError(
            f"--family {cfg.family}: the LSTM family is ROADMAP.md queue 1 item 11")


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
