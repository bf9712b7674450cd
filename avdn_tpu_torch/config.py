"""Typed run configuration + reference-compatible CLI.

The port's own copy of ``avdn_tpu/config.py``: the same flags, defaults and
presets, so both packages accept identical command lines. What the port
cannot run yet is rejected where the flags are consumed
(``train/loop.py:check_supported``), never silently swapped.

The reference uses a flat ~45-flag argparse namespace with derived paths
(src/xview_et/parser.py, src/xview_lstm/parser.py). Public flag names are
preserved here (so run_et_haa.sh-style invocations translate 1:1) on top of
a typed dataclass; unknown flags are ignored like the reference's
``parse_known_args`` (parser.py:102).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class Args:
    # recipe preset: named bundle of measured-best flag values (PERF.md),
    # applied as *defaults* — any flag passed explicitly still wins
    preset: str = "reference"
    # paths
    root_dir: str = "./datasets"
    output_dir: str = "default"
    seed: int = 0
    # distributed: 0 = auto (all visible chips that divide batch_size);
    # >0 = exactly that many data-parallel workers (single process: local
    # chips; multi process: must equal the jax process count)
    world_size: int = 0
    # schedule
    iters: int = 300000
    log_every: int = 1000
    eval_first: bool = False
    inference: bool = False
    # data
    max_instr_len: int = 80
    max_action_len: int = 15
    batch_size: int = 8
    # resume
    resume_file: Optional[str] = None
    resume_optimizer: bool = False
    ckpt_keep: int = 0  # keep newest N latest_dict_* ckpts (0 = keep all)
    # xview
    nss_w: float = 1.0
    nss_r: int = 0
    darknet_model_file: Optional[str] = None
    darknet_weight_file: Optional[str] = None
    bert_weight_file: Optional[str] = None
    bert_vocab_file: Optional[str] = None
    # ET
    demb: int = 768
    encoder_heads: int = 12
    encoder_layers: int = 2
    bert_layers: int = 12  # framework-native (reduce for small experiments)
    dropout_transformer_encoder: float = 0.1
    dropout_emb: float = 0.0
    # loss
    ml_weight: float = 0.2
    teacher_weight: float = 1.0
    # ablations
    no_direction: bool = False
    language_only: bool = False
    vision_only: bool = False
    train_val_on_full: bool = False
    # eval.ai submission
    submit: bool = False
    # optimisation. Default deviates from the reference parser's "rms"
    # (parser.py:81) because the reference itself hard-asserts
    # ``optim in ("adam", "adamW")`` (agent.py:152) — its default is
    # unusable; every shipped script passes adamW (run_et_haa.sh). We keep
    # the assert (the JAX package's train_config_from_args) and make the
    # default runnable.
    optim: str = "adamW"
    lr: float = 1e-5
    feedback: str = "student"
    # family (framework-native)
    family: str = "et"
    # Tristate: None (default) = bfloat16 tower compute for EVAL/SERVING on
    # the card (fp32 on the CPU — same auto-fallback rule as render_bf16),
    # fp32 for TRAIN (the shipped configuration — metric equivalence of the
    # bf16 eval towers is golden-gated alongside the render modes,
    # tests/test_render_mode_goldens.py 'twopass_bf16'); True/False forces
    # both paths. Params/optimizer always stay fp32.
    bf16: Optional[bool] = None
    render_subsample: int = 1  # >1: fast non-parity warp (PERF.md)
    # Tristate: None (default) = two-pass warp for EVAL/SERVING, exact
    # gather for TRAIN (the shipped configuration — metric equivalence is
    # golden-gated, tests/test_render_mode_goldens.py); True/False forces
    # both paths. --render_twopass False restores strict cv2 eval parity.
    render_twopass: Optional[bool] = None
    render_crop: int = 0  # 2-pass source window px; 0 = auto from dataset
    render_bf16: bool = True  # bf16 two-pass warp einsums (fp32 for parity)
    fold_bn_eval: bool = True  # fold BN + input norm into eval conv weights
    quant: str = "none"  # "int8": dynamic-int8 eval/serving vision tower
    profile_dir: Optional[str] = None  # capture a torch.profiler trace here
    grad_accum: int = 1  # micro-batch count (batch_size must divide evenly)
    remat: bool = False  # rematerialise rollout steps (fit bigger train batches)
    remat_policy: str = "full"  # "full" | "dots" (save matmul outputs)
    fused_teacher: bool = True  # time-fused teacher rollouts (same math, 1 wide call)
    fast_eval_trunk: bool = True  # one-pass teacher-eval ET trunk (same math)
    et_decode_trunk: bool = False  # incremental eval-scan trunk decode (opt-in)
    async_ckpt: bool = True  # background orbax writes
    prefetch: bool = True  # overlap host batch assembly with device steps
    preempt_save: bool = True  # SIGTERM: checkpoint + clean exit (preemption)
    # derived
    train_dataset_dir: str = ""
    val_dataset_dir: str = ""
    train_anno_dir: str = ""
    val_anno_dir: str = ""
    ckpt_dir: str = ""
    log_dir: str = ""
    pred_dir: str = ""
    # device batch topology
    map_bank_slots: int = 8
    map_bank_px: int = 4096
    max_gt_len: int = 12
    max_circles: int = 16
    dialog_pad: int = 320


# Named recipes. Values are applied on top of the dataclass defaults but
# UNDER explicit CLI flags (so `--preset production --batch_size 32` gets the
# production recipe at batch 32). Measurements behind each choice: PERF.md.
_PRESETS = {
    # the reference's shipped configuration semantics — no overrides
    "reference": {},
    # the JAX package's measured-best recipe: bf16 tower compute, two-pass
    # render in train too (eval/serving already default to it), batch 16
    # with dots-policy remat. The port trains it (train/loop.py:train);
    # what it costs on the card is in PERF.md.
    "production": dict(
        batch_size=16,
        bf16=True,
        render_twopass=True,
        remat=True,
        remat_policy="dots",
    ),
}


_BOOL_FLAGS = {
    "eval_first", "inference", "resume_optimizer", "no_direction",
    "language_only", "vision_only", "train_val_on_full", "submit", "bf16",
    "render_twopass", "render_bf16", "fold_bn_eval", "async_ckpt",
    "prefetch", "remat", "preempt_save", "fused_teacher", "fast_eval_trunk",
    "et_decode_trunk",
}

_HELP = {
    "preset": "named flag recipe applied as defaults (explicit flags win): "
              "'reference' (shipped reference config, no overrides) or "
              "'production' (batch 16, bf16 towers, two-pass render in "
              "train too, dots remat)",
    "root_dir": "dataset root (expects AVDN/{annotations,train_images})",
    "output_dir": "run directory (ckpts/, logs/, preds/ are created inside)",
    "world_size": "data-parallel workers: 0 = auto (all chips that divide "
                  "batch_size); >0 exact (multi-process: the process count)",
    "iters": "total training iterations",
    "log_every": "epochs per interval (checkpoint + full validation)",
    "eval_first": "run a full validation pass before training",
    "inference": "evaluation-only mode (writes valid.txt + debug images)",
    "max_instr_len": "instruction token pad (static shape)",
    "max_action_len": "episode horizon (reference: 10 train / 5 eval)",
    "resume_file": "checkpoint dir (ours), released torch .pt, or 'latest' "
                   "to auto-resume from the newest latest_dict_* in ckpt_dir",
    "resume_optimizer": "also restore optimizer state on resume",
    "ckpt_keep": "retain only the newest N latest_dict_* checkpoints "
                 "(0 = keep all, like the reference; best_val_unseen kept)",
    "nss_w": "saliency NSS loss weight (student phase)",
    "darknet_model_file": "darknet .cfg (default: generated darknet-53 tower)",
    "darknet_weight_file": "YOLO pretrain best.pt to import",
    "bert_weight_file": "raw HF bert-base-uncased checkpoint "
                        "(pytorch_model.bin or a bare BertModel state dict) "
                        "to initialise the language tower for from-scratch "
                        "training (reference vln_model.py:131); the 64/49 "
                        "head stays at its fresh random init",
    "bert_vocab_file": "bert-base-uncased vocab.txt for exact token parity",
    "feedback": "'student' (teacher+student double rollout) or 'teacher'",
    "train_val_on_full": "full-trajectory mode: stitch dialog rounds into one episode",
    "submit": "add test_unseen and dump the Eval.ai output_test_result.npy",
    "family": "'et' (HAA-Transformer) or 'lstm' (HAA-LSTM)",
    "bf16": "bfloat16 tower compute (fp32 params). Default (unset): bf16 "
            "for eval/serving on the card, fp32 for train and on the CPU; "
            "pass True/False to force both paths (False = fp32 everywhere)",
    "render_subsample": ">1: low-res warp + upscale (fastest render)",
    "render_twopass": "full-res 2-pass warp. "
                      "Default (unset): two-pass for eval/serving, exact "
                      "for train; pass True/False to force both paths "
                      "(False = strict cv2 parity everywhere)",
    "render_crop": "2-pass source window in px; 0 (default) = auto-size "
                   "from the dataset annotations",
    "render_bf16": "two-pass warp in bfloat16 (default); False = tighter fp32",
    "fold_bn_eval": "fold eval-mode BatchNorm + input normalisation into the "
                    "conv weights (inference transform; same math)",
    "quant": "'int8': eval/serving vision tower in dynamic symmetric int8 "
             "(per-channel weights, per-example activations, the integer "
             "values convolved in fp32). Opt-in approximation — error "
             "bounds in tests/test_quant.py; eval-only (training is "
             "unaffected)",
    "profile_dir": "capture a torch.profiler trace into this directory",
    "grad_accum": "micro-batch count; must divide batch_size. NOT numerically "
                  "identical to the full batch: episode-alive loss gating, BN "
                  "stats, and dropout draws are per-micro-batch (PERF.md)",
    "remat": "recompute rollout activations under AD (fit bigger batches)",
    "remat_policy": "'full' (recompute all) or 'dots' (save matmul/conv "
                    "outputs, recompute elementwise only)",
    "fused_teacher": "time-fused teacher-forced rollouts (one wide "
                     "render/tower call instead of T scan steps; same math, "
                     "same rng streams; under --remat only the student "
                     "rollout is rematerialised — disable if the O(T*B) "
                     "teacher tower footprint doesn't fit)",
    "fast_eval_trunk": "teacher-forced eval: ONE causal ET trunk pass "
                       "instead of T step-masked re-encodes (same math, "
                       "deterministic mode only; models/et_fast.py). Train "
                       "always uses the full re-encode (dropout)",
    "et_decode_trunk": "eval scans: incremental KV-decode of the ET trunk "
                       "(same math; two-softmax language/history merge). "
                       "Its 1e-5 reassociation flips one borderline "
                       "fixture episode across render modes, so the "
                       "shipped default stays the full re-encode (PERF.md "
                       "'The JAX package on TPU v5e')",
    "async_ckpt": "background orbax checkpoint writes",
    "prefetch": "overlap host batch assembly with device steps",
    "preempt_save": "on SIGTERM save latest_dict_{step} and exit cleanly "
                    "(resume with --resume_file latest); default on",
    "map_bank_slots": "HBM map slots (>= distinct maps per batch)",
    "map_bank_px": "map slot edge in px (auto-grows for larger tiles)",
    "dialog_pad": "dialog-history token pad for BERT pass 2",
}


#: the model families (``--family``)
FAMILIES = ("et", "lstm")


def check_family(family: str) -> None:
    """Raise ``ValueError`` for a ``--family`` that is not in :data:`FAMILIES`."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family: {family} (choose 'et' or 'lstm')")


def parse_args(argv=None, family: str = "et") -> Args:
    # allow_abbrev=False: _apply_preset detects explicitly-passed flags by
    # scanning argv for the full field name; prefix abbreviations would
    # evade that scan and get silently clobbered by the preset
    parser = argparse.ArgumentParser(description="avdn_tpu",
                                     allow_abbrev=False)
    defaults = Args(family=family)
    for f in dataclasses.fields(Args):
        if f.name in ("train_dataset_dir", "val_dataset_dir", "train_anno_dir",
                      "val_anno_dir", "ckpt_dir", "log_dir", "pred_dir"):
            continue
        name = "--" + f.name
        help_text = _HELP.get(f.name)
        if f.name in _BOOL_FLAGS:
            # accept both `--flag` and `--flag True` (the shipped scripts
            # pass values, run_et_haa.sh:33)
            parser.add_argument(name, nargs="?", const=True, default=getattr(defaults, f.name),
                                type=lambda v: str(v).lower() in ("1", "true", "yes"),
                                help=help_text)
        else:
            typ = type(getattr(defaults, f.name)) if getattr(defaults, f.name) is not None else str
            parser.add_argument(name, type=typ, default=getattr(defaults, f.name),
                                help=help_text)
    ns, _unknown = parser.parse_known_args(argv)
    args = Args(**{f.name: getattr(ns, f.name, getattr(defaults, f.name))
                   for f in dataclasses.fields(Args)})
    args = _apply_preset(args, argv)
    return postprocess_args(args)


def _apply_preset(args: Args, argv) -> Args:
    """Overlay the named preset's values for every flag NOT explicitly
    passed on the command line (explicit flags always win)."""
    if args.preset not in _PRESETS:
        raise ValueError(
            f"unknown --preset {args.preset!r}; choose from "
            f"{sorted(_PRESETS)}"
        )
    overrides = _PRESETS[args.preset]
    if not overrides:
        return args
    if argv is None:
        import sys

        argv = sys.argv[1:]
    explicit = {
        a.split("=", 1)[0].lstrip("-") for a in argv if a.startswith("--")
    }
    for name, value in overrides.items():
        if name not in explicit:
            setattr(args, name, value)
    return args


def postprocess_args(args: Args) -> Args:
    root = args.root_dir
    args.train_dataset_dir = os.path.join(root, "AVDN", "train_images")
    args.val_dataset_dir = os.path.join(root, "AVDN", "train_images")
    args.train_anno_dir = os.path.join(root, "AVDN", "annotations")
    args.val_anno_dir = os.path.join(root, "AVDN", "annotations")
    args.ckpt_dir = os.path.join(args.output_dir, "ckpts")
    args.log_dir = os.path.join(args.output_dir, "logs")
    args.pred_dir = os.path.join(args.output_dir, "preds")
    for d in (args.output_dir, args.ckpt_dir, args.log_dir, args.pred_dir,
              os.path.join(args.pred_dir, "debug_images")):
        os.makedirs(d, exist_ok=True)
    if args.train_val_on_full:
        args.max_action_len *= 4  # reference main.py:292-293
        # concatenated GT paths grow with the round count; widen the static
        # pad so the appended goal view area is never truncated (the
        # reference keeps unbounded lists, env.py:263-268)
        args.max_gt_len = args.max_gt_len * 4 + 1
    return args
