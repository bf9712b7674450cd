"""The train and validation drivers (torch counterpart of
``avdn_tpu/train/loop.py``).

``train`` mirrors the reference's training flow (src/xview_et/main.py:
150-250): intervals of ``--log_every`` epochs over the train split, each
followed by the checkpoint ``latest_dict_{iter}.pt``, the validation and
``best_val_unseen.pt`` by val_unseen SPL; ``--resume_file latest`` resumes
from the newest ``latest_dict_*``, and SIGTERM saves one and exits cleanly
(``utils/preemption.py``). Training runs the reference numerics unless
asked otherwise: fp32 towers unless ``--bf16 True``, the exact render
unless ``--render_twopass True``, no rematerialisation unless ``--remat``
(``--preset production`` sets all three and batch 16, under any explicit
flag); its validation runs the eval defaults below on the same weights.

``valid`` → ``run_validation`` → ``_eval_env`` mirror the reference's
inference flow (src/xview_et/main.py:188-288): the student-forced nav eval
and the teacher-forced human-attention eval over the val splits, the metric
record (``valid.txt``, ``metrics.jsonl``), the debug images, and with
``--submit`` the Eval.ai ``output_test_result.npy``.

Eval modes and defaults are the JAX package's: an unset ``--render_twopass``
means the two-pass render (``sim/warp2pass.py``) with the crop sized from
the annotations (``--render_crop 0``), an unset ``--bf16`` means bf16 towers
on the card and fp32 on the CPU, and the Darknet tower runs BN-folded
(``--fold_bn_eval``); ``--render_subsample``, ``--quant int8`` and
``--et_decode_trunk`` are the opt-in modes. On the card a requested or
defaulted bf16 runs bf16; only the CPU falls back to fp32, as in the JAX
package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import sys
import time

import numpy as np
import torch
from torch import nn

from avdn_tpu_torch.compat.from_jax import load_agent_weights, load_reference_agent
from avdn_tpu_torch.config import Args, check_family
from avdn_tpu_torch.data.annotations import ANDHDataset
from avdn_tpu_torch.data.batcher import BatcherConfig, make_train_batch
from avdn_tpu_torch.data.maps import DeviceMapBank, load_map_image
from avdn_tpu_torch.data.prefetch import Prefetcher
from avdn_tpu_torch.data.tokenizer import WordPieceTokenizer
from avdn_tpu_torch.device import resolve_device, use_fp32_numerics
from avdn_tpu_torch.metrics.nav import assemble_trajectories, eval_metrics
from avdn_tpu_torch.models.bert import BertConfig, BertLanguageEncoder
from avdn_tpu_torch.models.darknet import Darknet, DarknetConfig
from avdn_tpu_torch.models.et import ETConfig, HAATransformer
from avdn_tpu_torch.models.lstm import HAALSTM, LSTMConfig
from avdn_tpu_torch.parallel.collectives import merge_prediction_dicts
from avdn_tpu_torch.parallel.runtime import ParallelRuntime, setup_runtime
from avdn_tpu_torch.sim.warp2pass import auto_render_crop
from avdn_tpu_torch.train import checkpoints as ckpt
from avdn_tpu_torch.train.step import (
    TrainConfig,
    create_train_state,
    make_eval_rollout,
    make_train_step,
)
from avdn_tpu_torch.utils import logging as spans
from avdn_tpu_torch.utils.logging import MetricWriter, PhaseTimer, span
from avdn_tpu_torch.utils.preemption import PreemptionGuard
from avdn_tpu_torch.utils.seed import set_random_seed
from avdn_tpu_torch.viz import save_debug_overlays, save_saliency_heatmaps


def eval_bf16(args: Args, device: torch.device) -> bool:
    """bf16 towers for eval/serving? ``--bf16 True/False`` decides on any
    device; unset means bf16 on the card and fp32 on the CPU (the JAX
    package's rule, ``eval_bf16``: bf16 on a CPU is emulated and slower)."""
    if args.bf16 is None:
        return device.type != "cpu"
    return bool(args.bf16)


def train_bf16(args: Args) -> bool:
    """Training computes fp32 unless ``--bf16 True`` (the reference numerics
    by default; the bf16 recipe is opt-in, ``--preset production``). bf16
    training runs bf16 on any device: the parameters and optimizer stay
    fp32 and the towers compute at flax's bf16 rounding points under
    autograd."""
    return args.bf16 is True


def check_supported(args: Args, device: torch.device) -> None:
    """Raise ``ValueError`` for an unknown ``--family``."""
    check_family(args.family)


def build_models(args: Args, device: torch.device, bf16: bool = False):
    """BERT, Darknet and the VLN model of ``--family`` (the ET trunk, or
    ``HAALSTM`` with ``hidden_size = --demb``) at the flag widths on
    ``device`` (in eval mode): float32 parameters, computing in bf16 with
    ``bf16``."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    if args.demb == 768 and args.bert_layers == 12:
        bert_cfg = BertConfig()
    else:
        bert_cfg = BertConfig(hidden_size=args.demb, num_layers=args.bert_layers,
                              num_heads=args.encoder_heads,
                              intermediate_size=args.demb * 2)
    if args.darknet_model_file and os.path.exists(args.darknet_model_file):
        with open(args.darknet_model_file) as f:
            dk_cfg = DarknetConfig.from_text(f.read(), img_size=224)
    else:
        dk_cfg = DarknetConfig.default(img_size=224)
    check_family(args.family)
    if args.family == "lstm":
        vln = HAALSTM(LSTMConfig(hidden_size=args.demb), dtype=dtype)
    else:
        vln = HAATransformer(ETConfig(demb=args.demb, encoder_heads=args.encoder_heads,
                                      encoder_layers=args.encoder_layers,
                                      dropout_transformer=args.dropout_transformer_encoder,
                                      dropout_emb=args.dropout_emb), dtype=dtype)
    models = (BertLanguageEncoder(bert_cfg, dtype), Darknet(dk_cfg, dtype=dtype), vln)
    return tuple(m.to(device).eval() for m in models)


@torch.no_grad()
def init_state(models, generator: torch.Generator, args: Args = None) -> None:
    """Random weights from ``generator`` (the JAX package's init scheme:
    LeCun-normal weights, zero biases, unit norms, embeddings of std
    1/√features; BatchNorm at identity statistics). Draws on the CPU so the
    same seed gives the same weights on every device. With ``args``, a
    ``--bert_weight_file`` / ``--darknet_weight_file`` that exists replaces
    the language tower's body / the vision tower (the reference's pretrained
    init; the 49-d head stays random)."""
    for model in models:
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                fan_in = mod.weight[0].numel()
                w = torch.randn(mod.weight.shape, generator=generator)
                mod.weight.copy_(w / math.sqrt(fan_in))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                w = torch.randn(mod.weight.shape, generator=generator)
                mod.weight.copy_(w / math.sqrt(mod.weight.shape[1]))
            elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
                mod.reset_parameters()
                if isinstance(mod, nn.BatchNorm2d):
                    mod.reset_running_stats()
        for name, p in model.named_parameters():
            if name.endswith(("in_proj_weight", "weight_ih", "weight_hh")):
                fan_in = p.shape[1]
                p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(fan_in))
            elif name.endswith(("in_proj_bias", "bias_ih", "bias_hh")):
                p.zero_()
    if args is not None:
        if args.bert_weight_file and os.path.exists(args.bert_weight_file):
            ckpt.import_bert_pretrain(args.bert_weight_file, models[0])
            print(f"Loaded BERT pretrain from {args.bert_weight_file}")
        if args.darknet_weight_file and os.path.exists(args.darknet_weight_file):
            ckpt.import_darknet_pretrain(args.darknet_weight_file, models[1])
            print(f"Loaded darknet pretrain from {args.darknet_weight_file}")


def _auto_render_crop(anno_dir: str, splits) -> int:
    """The two-pass crop for a dataset: ``auto_render_crop`` of the finest
    ``lat_ratio`` in the annotations of ``splits`` (a split without a file
    is skipped; 512 when none has one)."""
    lats = []
    for split in splits:
        path = os.path.join(anno_dir, f"{split}_data.json")
        if os.path.exists(path):
            with open(path) as f:
                lats.extend(it["lat_ratio"] for it in json.load(f))
    return auto_render_crop(min(lats)) if lats else 512


def eval_render_twopass(args: Args) -> bool:
    """Eval and serving render with the two-pass warp unless
    ``--render_twopass False`` (the JAX package's shipped default)."""
    return args.render_twopass is not False


def resolve_render_crop(args: Args) -> Args:
    """``--render_crop 0`` → sized from the annotations of EVERY split the
    run touches, train included as in the JAX package (a val map with a
    finer ``lat_ratio`` needs a larger window than any train map); 512 when
    no two-pass render runs."""
    if args.render_crop == 0:
        if eval_render_twopass(args):
            splits = ["train", "val_seen", "val_unseen"] + (
                ["test_unseen"] if args.submit else [])
            args.render_crop = _auto_render_crop(args.train_anno_dir, splits)
            print(f"render_crop auto-derived: {args.render_crop}px", file=sys.stderr)
        else:
            args.render_crop = 512
    return args


def train_render_twopass(args: Args) -> bool:
    """Training renders exact unless ``--render_twopass True``."""
    return args.render_twopass is True


def train_config_from_args(args: Args) -> TrainConfig:
    """The train config of the flags (the JAX package's, field for field);
    ``--optim`` must be ``adam`` or ``adamW``, as the reference asserts
    (src/xview_et/agent.py:152)."""
    if args.optim not in ("adam", "adamW"):
        raise ValueError(
            f"--optim {args.optim!r} is not supported: the reference asserts "
            "optim in ('adam', 'adamW') (src/xview_et/agent.py:152) and so do we")
    return TrainConfig(
        family=args.family,
        feedback=args.feedback,
        lr=args.lr,
        optim=args.optim,
        ml_weight=args.ml_weight,
        teacher_weight=args.teacher_weight,
        nss_w=args.nss_w,
        nss_r=args.nss_r,
        max_action_len=args.max_action_len,
        student_stop=0.25 if args.family == "lstm" else 0.5,
        darknet_in_vln=args.family == "lstm",
        single_bert_pass=args.train_val_on_full,
        language_only=args.language_only,
        vision_only=args.vision_only,
        no_direction=args.no_direction,
        render_subsample=args.render_subsample,
        render_twopass=train_render_twopass(args),
        render_crop=args.render_crop,
        render_bf16=args.render_bf16,
        fold_bn_eval=args.fold_bn_eval,
        grad_accum=args.grad_accum,
        remat=args.remat,
        remat_policy=args.remat_policy,
        fused_teacher=args.fused_teacher,
        fast_eval_trunk=args.fast_eval_trunk,
        et_decode_trunk=args.et_decode_trunk,
    )


def eval_config_from_args(args: Args) -> TrainConfig:
    """The eval/serving config: the train config with the render mode
    two-pass unless ``--render_twopass False``, as in the JAX package's eval
    default (call ``resolve_render_crop`` first for an auto-sized crop), and
    the opt-in int8 tower (``--quant``)."""
    return dataclasses.replace(train_config_from_args(args),
                               render_twopass=eval_render_twopass(args),
                               quant=args.quant)


def describe_eval_mode(cfg: TrainConfig, models) -> str:
    """One line naming the towers' dtype, the vision tower's form and the
    render mode an eval config runs."""
    if cfg.render_twopass:
        render = f"two-pass render, crop {cfg.render_crop} px"
        if cfg.render_bf16:
            render += ", bf16 weights on the card"
    else:
        render = "exact render" + (f", subsample {cfg.render_subsample}"
                                   if cfg.render_subsample > 1 else "")
    tower = ("int8" if cfg.quant == "int8" else
             "BN-folded" if cfg.fold_bn_eval else "unfolded")
    trunk = ("LSTM cell" if cfg.family == "lstm" else
             "KV-decode trunk" if cfg.et_decode_trunk else "re-encode trunk")
    return (f"towers {str(models[0].dtype).replace('torch.', '')}, {tower} "
            f"Darknet, {trunk}, {render}")


def batcher_config(args: Args) -> BatcherConfig:
    return BatcherConfig(
        max_gt_len=args.max_gt_len,
        max_circles=args.max_circles,
        instr_pad=args.max_instr_len,
        dialog_pad=args.dialog_pad,
        lang_dim=args.demb,
        vision_only=args.vision_only,
        single_bert_pass=args.train_val_on_full,
    )


# ------------------------------------------------------ validation driver --


def _shard(runtime: ParallelRuntime):
    """This process's dataset shard, ``(index, count)``, or None."""
    return (runtime.process_index, runtime.process_count) if runtime.multiprocess else None


def build_dataset(args: Args, runtime: ParallelRuntime):
    """The validation envs, ``{name: ANDHDataset}`` (val_seen, val_unseen,
    and test_unseen under ``--submit``), each with the seeded shuffle of
    ``--seed`` and, in a multi-process run, this process's shard (``train``
    builds the train env the same way, its shuffle seeded per process)."""
    names = ["val_seen", "val_unseen"] + (["test_unseen"] if args.submit else [])
    return {name: ANDHDataset(args.val_anno_dir, [name], args.batch_size, seed=args.seed,
                              full_traj=args.train_val_on_full, shard=_shard(runtime))
            for name in names}


def _check_dataset(args: Args, splits):
    """Fail fast (before the expensive model init) when the dataset is
    missing, with a message that names the flag to fix."""
    missing = [
        s for s in splits
        if not os.path.exists(os.path.join(args.train_anno_dir, f"{s}_data.json"))
    ]
    if missing:
        raise FileNotFoundError(
            f"annotation files for splits {missing} not found under "
            f"{args.train_anno_dir} — point --root_dir at a dataset root "
            "containing AVDN/{annotations,train_images}"
        )


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the enclosed block with ``torch.profiler`` (host ops, and the
    card's kernels where there is one) into ``<log_dir>/trace.json``, a
    Chrome trace, with the program's spans (``utils/logging.py``) recorded
    over the block and merged in as ``"X"`` events on the trace's clock and
    threads (category ``span``), so the layers show over the ops."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    spans.drain()
    spans.enable()
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        spans.disable()
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base_ns = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    trace["traceEvents"] += [
        {"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": s.thread,
         "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": s.id, "parent": s.parent, "root": s.root}}
        for s in spans.drain()]
    with open(path, "w") as f:
        json.dump(trace, f)


def _eval_env(args, env, eval_fn, tokenizer, bank, bcfg, device, runtime,
              on_batch=None, profile_dir=None):
    """One full pass over a val env; returns preds keyed by instr_id.
    Wrap-around duplicate items overwrite by key (reference agent.test,
    agent.py:204-206). ``on_batch(out, meta)`` observes each batch's rollout
    outputs on the host (debug-image dumps). Every batch gets a fresh
    generator seeded with ``--seed`` (the JAX package's one fixed key): the
    only random draw left in eval is the unused loss's heading jitter.
    ``profile_dir`` traces the FIRST batch only. In a multi-process run each
    process evaluates its shard alone and the predictions are unioned over
    the processes, so every process returns the same dict."""
    preds = {}

    def _prepare(items):
        """Host batch assembly — prefetched under ``--prefetch`` so map
        decode and tokenisation overlap the rollouts on the card."""
        bank_arr, slot_of = bank.prepare(items)
        batch, meta = make_train_batch(items, tokenizer, slot_of, bcfg, device=device)
        return bank_arr, batch, meta

    if args.prefetch:
        batches = Prefetcher(env, _prepare, depth=2)
    else:
        batches = (_prepare(items) for items in env)
    for bi, (bank_arr, batch, meta) in enumerate(batches):
        gen = torch.Generator(device).manual_seed(args.seed)
        trace = (profile_trace(profile_dir) if profile_dir and bi == 0
                 else contextlib.nullcontext())
        with trace:
            out = eval_fn(bank_arr, batch, gen)
            with span("valid.metrics"):  # the copy waits for the rollout
                out = out.cpu()
                preds.update(assemble_trajectories(out, meta))
        if on_batch is not None:
            on_batch(out, meta)
    return merge_prediction_dicts(preds) if runtime.multiprocess else preds


def _write_debug_images(args, env, preds, env_name):
    """Inference-mode trajectory overlays (agent.py:776-879 flow), of the
    items this process owns (a shard's wrap-around pad items are another
    process's to write)."""
    owned = env.owned_instr_ids
    items_by_id = {it["map_name"] + "__" + it["route_index"]: it for it in env.data
                   if owned is None
                   or it["map_name"] + "__" + str(it["route_index"]) in owned}
    host_maps = {}
    for it in items_by_id.values():
        nm = it["map_name"]
        if nm not in host_maps:
            try:
                host_maps[nm] = load_map_image(
                    os.path.join(args.val_dataset_dir, nm + ".tif"),
                    it["lng_ratio"], it["lat_ratio"])
            except FileNotFoundError:
                pass
    save_debug_overlays(args.pred_dir, env_name, preds, host_maps, items_by_id)


def _write_saliency_debug(args, env_name, out, meta):
    """Per-step pred/GT attention heatmaps + input views during the
    teacher-forced HA eval in inference mode (agent.py:694-706): one jpg
    triple per item per step while the episode loop is still running."""
    out_dir = os.path.join(args.pred_dir, "debug_images")
    alive_any = out.alive_pre.numpy().any(axis=1)  # (T,)
    pred = out.pred_sal.numpy()
    gt = out.gt_sal.numpy()
    views = out.views.numpy() if out.views is not None else None
    for t in range(pred.shape[0]):
        if not alive_any[t]:
            break
        for i, m in enumerate(meta):
            map_name, route = m["instr_id"].split("__", 1)
            tag = f"{env_name}val{map_name}_{route}"
            save_saliency_heatmaps(
                out_dir, tag, pred[t, i], gt[t, i],
                view=None if views is None else views[t, i], step=t)


def run_validation(args, val_envs, eval_student, eval_teacher, tokenizer, bank,
                   bcfg, writer, step: int, device, runtime, eval_student_test=None,
                   eval_teacher_debug=None, profile_dir=None, timers=None):
    """Student nav eval + teacher-forced HA eval over all val envs
    (main.py:188-239). Returns {env_name: avg_metrics}.

    With ``eval_teacher_debug`` (a ``collect_debug`` rollout) in inference
    mode, per-step saliency heatmaps are written to preds/debug_images
    (agent.py:694-706). ``timers`` (a ``PhaseTimer``) times the nav and HA
    evals and the debug images (the heatmaps inside the HA eval's time).
    In a multi-process run every process evaluates its shards and computes
    the same metrics from the merged predictions; the Eval.ai file is
    process 0's to write. The pass is the span ``valid.pass``, the evals
    ``valid.nav`` and ``valid.ha``, the metrics and the copies of the
    rollouts to the host ``valid.metrics``."""
    timers = timers or PhaseTimer()
    with span("valid.pass"):
        results = {}
        loss_str = f"iter {step}"
        for ei, (env_name, env) in enumerate(val_envs.items()):
            fn = eval_student
            if "test" in env_name and eval_student_test is not None:
                fn = eval_student_test
            with timers("nav_eval", span="valid.nav"):
                preds = _eval_env(args, env, fn, tokenizer, bank, bcfg, device, runtime,
                                  profile_dir=profile_dir if ei == 0 else None)
            if "test_unseen" in env_name:
                if runtime.is_main:
                    np.save("./output_test_result.npy", preds, allow_pickle=True)
                    print("inference_result on test is generated.")
                continue
            if args.inference:
                with timers("debug_images"):
                    _write_debug_images(args, env, preds, env_name)
            with span("valid.metrics"):
                avg, _ = eval_metrics(preds)
            results[env_name] = avg
            loss_str += f", {env_name} " + "".join(
                f", {k}: {v:.2f}" for k, v in avg.items())
            writer.scalars(step, {f"{k}/{env_name}": v for k, v in avg.items()})
        for env_name, env in val_envs.items():
            if "test_unseen" in env_name:
                continue
            teacher_fn, on_batch = eval_teacher, None
            if args.inference and eval_teacher_debug is not None:
                teacher_fn = eval_teacher_debug

                def on_batch(out, meta, _env=env_name):
                    with timers("debug_images"):  # inside the HA eval's wall
                        _write_saliency_debug(args, _env, out, meta)

            with timers("ha_eval", span="valid.ha"):
                preds = _eval_env(args, env, teacher_fn, tokenizer, bank, bcfg,
                                  device, runtime, on_batch=on_batch)
            with span("valid.metrics"):
                ha_avg, _ = eval_metrics(preds, human_att_eval=True)
            results[env_name + "_human_att"] = ha_avg
            loss_str += f", {env_name}_human_att " + "".join(
                f", {k}: {v:.2f}" for k, v in ha_avg.items())
            writer.scalars(step, {f"{k}/{env_name}_ha": v for k, v in ha_avg.items()})
        writer.text(loss_str)
        return results


def _log_dir(args: Args, runtime: ParallelRuntime) -> str:
    """``logs/`` for process 0, ``logs/proc{i}/`` for the others."""
    if runtime.is_main:
        return args.log_dir
    return os.path.join(args.log_dir, f"proc{runtime.process_index}")


def _describe_device(device, runtime: ParallelRuntime) -> str:
    name = f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""
    return f"device: {device}{name}; {runtime.describe()}"


def _timed_loader(loader, timers):
    """``loader`` with each call timed under the "map_load" phase (summed
    over the decode threads)."""
    def load(item):
        with timers("map_load"):
            return loader(item)
    return load


def valid(args: Args, device=None):
    """Inference mode (main.py:253-288) on the card, or on ``device``.

    ``--resume_file`` is a reference-format ``.pt`` agent checkpoint
    (``tools/export_torch_ckpt.py`` writes one from a JAX checkpoint);
    without it the weights are random from ``--seed``. Writes
    ``logs/valid.txt``, ``logs/metrics.jsonl`` and
    ``logs/validation_args.json``, with ``--inference`` the debug images
    under ``preds/debug_images``, and with ``--submit`` the Eval.ai
    ``output_test_result.npy``. ``--profile_dir`` traces the first eval
    batch. Returns ``({env_name: avg_metrics}, PhaseTimer)``; the timer
    holds the map loading, nav-eval, HA-eval and debug-image walls.

    In a multi-process run (``parallel/runtime.py``) each process evaluates
    its shard of every split on its own card, the predictions are merged,
    and process 0 writes ``logs/``, the others ``logs/proc{i}/``."""
    runtime = setup_runtime(args)  # joins the processes and picks the card
    device = resolve_device(device)
    check_supported(args, device)
    resolve_inference_checkpoint(args)
    set_random_seed(args.seed + runtime.process_index)
    _check_dataset(args, ["val_seen", "val_unseen"])
    use_fp32_numerics()
    args = resolve_render_crop(args)
    cfg = eval_config_from_args(args)
    models = build_models(args, device, bf16=eval_bf16(args, device))
    init_state(models, torch.Generator().manual_seed(args.seed))
    if args.resume_file:
        load_agent_weights(models, load_reference_agent(args.resume_file, args.family))
        print(f"Imported reference checkpoint {args.resume_file}")
    runtime.assert_replicas_identical(models, "weights")
    tokenizer = WordPieceTokenizer.load(args.bert_vocab_file)
    bcfg = batcher_config(args)
    timers = PhaseTimer()
    bank = DeviceMapBank(args.val_dataset_dir, (args.map_bank_px, args.map_bank_px),
                         n_slots=args.map_bank_slots, device=device)
    bank.loader = _timed_loader(bank.loader, timers)
    writer = MetricWriter(_log_dir(args, runtime), "valid.txt")
    writer.text(_describe_device(device, runtime) + "; " + describe_eval_mode(cfg, models))
    if runtime.is_main:
        with open(os.path.join(args.log_dir, "validation_args.json"), "w") as f:
            json.dump(vars(args), f, indent=4, default=str)
    val_envs = build_dataset(args, runtime)
    bert, darknet, vln = models
    eval_student = make_eval_rollout(cfg, bert, darknet, vln, teacher=False)
    eval_teacher = make_eval_rollout(cfg, bert, darknet, vln, teacher=True,
                                     collect_ha=True)
    eval_teacher_debug = (
        make_eval_rollout(cfg, bert, darknet, vln, teacher=True, collect_ha=True,
                          collect_debug=True)
        if args.inference else None)
    eval_student_test = (
        make_eval_rollout(cfg, bert, darknet, vln, teacher=False,
                          compute_losses=False)
        if args.submit else None)
    t0 = time.perf_counter()
    results = run_validation(args, val_envs, eval_student, eval_teacher, tokenizer,
                             bank, bcfg, writer, 0, device, runtime, eval_student_test,
                             eval_teacher_debug=eval_teacher_debug,
                             profile_dir=args.profile_dir or None, timers=timers)
    writer.text(f"validation wall {time.perf_counter() - t0:.3f} s; phase timers: "
                f"{timers.summary()}")
    return results, timers


# ----------------------------------------------------------- train driver --

_LATEST = re.compile(r"^latest_dict_(\d+)\.pt$")


def _latest_checkpoints(ckpt_dir: str):
    """``[(iteration, path)]`` of the ``latest_dict_{iter}.pt`` files, oldest
    first."""
    if not os.path.isdir(ckpt_dir):
        return []
    found = [(int(m.group(1)), os.path.join(ckpt_dir, name))
             for name in os.listdir(ckpt_dir) if (m := _LATEST.match(name))]
    return sorted(found)


def _find_latest_checkpoint(ckpt_dir: str):
    """The newest ``latest_dict_{iter}.pt`` by iteration, or None."""
    found = _latest_checkpoints(ckpt_dir)
    return found[-1][1] if found else None


def _prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    """Keep the ``keep`` newest ``latest_dict_*.pt`` (0 = keep all, the
    reference's behaviour); ``best_val_unseen.pt`` is never pruned."""
    if keep <= 0:
        return
    for _, path in _latest_checkpoints(ckpt_dir)[:-keep]:
        os.remove(path)


def _refuse_orbax(path) -> None:
    if path and os.path.isdir(path):
        raise NotImplementedError(
            f"--resume_file {path}: orbax checkpoints need the JAX "
            "package; export them to a .pt with tools/export_torch_ckpt.py")


def resolve_inference_checkpoint(args: Args) -> None:
    """``--resume_file latest`` → the newest ``latest_dict_*.pt`` under
    ``ckpts/`` (the sentinel ``train()`` honours). Inference and serving
    have no fresh start to fall back on, so without one it raises
    ``FileNotFoundError``; an orbax directory raises
    ``NotImplementedError``."""
    if args.resume_file == "latest":
        args.resume_file = _find_latest_checkpoint(args.ckpt_dir)
        if not args.resume_file:
            raise FileNotFoundError(f"--resume_file latest: no latest_dict_*.pt "
                                    f"checkpoint under {args.ckpt_dir}")
    _refuse_orbax(args.resume_file)


def train(args: Args, device=None):
    """The train driver on the card, or on ``device``.

    Builds the models (random init from ``--seed``, the pretrained towers
    where ``--bert_weight_file`` / ``--darknet_weight_file`` exist), resumes
    ``--resume_file`` (a path, or ``latest``: the newest ``latest_dict_*``
    under ``ckpts/``, else a fresh start; the optimizer moments only with
    ``--resume_optimizer``), then runs ``--iters`` iterations in intervals of
    ``--log_every`` epochs: after each, ``IL_loss``, the mean grad norms
    and ``throughput/train_eps`` go to ``logs/metrics.jsonl`` and
    ``logs/train.txt`` with the phase timers, the state to
    ``ckpts/latest_dict_{iter}.pt`` (``--async_ckpt``: in the background;
    ``--ckpt_keep``: prune older ones), the validation runs and
    ``best_val_unseen.pt`` is kept by val_unseen SPL. ``--profile_dir``
    traces the second train step. A ``torch.Generator`` seeded with
    ``--seed`` + 1 on the device draws the dropout masks and the loss's
    heading jitter. Returns ``(TrainState, [per-step metrics as floats])``.

    In a multi-process run (``parallel/runtime.py``) each process trains on
    its shard of the train split, one slice of a global batch of
    process-count × ``--batch_size`` items (``make_train_step``'s
    ``group``); the replicas are checked identical after the init and the
    resume, the map banks grow together (so ``--prefetch`` is off), a
    SIGTERM to any process stops all of them at the same step, process 0
    alone writes the checkpoints (synchronously), and the validation merges
    the processes' predictions.
    """
    runtime = setup_runtime(args)  # joins the processes and picks the card
    device = resolve_device(device)
    check_supported(args, device)
    set_random_seed(args.seed + runtime.process_index)
    _check_dataset(args, ["train", "val_seen", "val_unseen"])
    use_fp32_numerics()
    args = resolve_render_crop(args)
    cfg = train_config_from_args(args)
    models = build_models(args, device, bf16=train_bf16(args))
    init_state(models, torch.Generator().manual_seed(args.seed), args)
    state = create_train_state(cfg, *models)
    train_step = make_train_step(cfg, *models, group=runtime.group)
    tokenizer = WordPieceTokenizer.load(args.bert_vocab_file)
    bcfg = batcher_config(args)
    bank = DeviceMapBank(args.train_dataset_dir, (args.map_bank_px, args.map_bank_px),
                         n_slots=args.map_bank_slots, device=device)
    writer = MetricWriter(_log_dir(args, runtime), "train.txt")
    writer.text(_describe_device(device, runtime))
    if runtime.is_main:
        with open(os.path.join(args.log_dir, "training_args.json"), "w") as f:
            json.dump(vars(args), f, indent=4, default=str)
    # the reference seeds each rank's shuffle apart (main.py:304)
    train_env = ANDHDataset(args.train_anno_dir, ["train"], args.batch_size,
                            seed=args.seed + runtime.process_index,
                            full_traj=args.train_val_on_full, shard=_shard(runtime))
    val_envs = build_dataset(args, runtime)

    # validation runs the eval config on the same weights; eval towers of
    # another dtype than training's (bf16 eval, the default on the card,
    # after fp32 training) are separate modules that take a copy
    ecfg = eval_config_from_args(args)
    ebf16 = eval_bf16(args, device)
    emodels = (build_models(args, device, bf16=ebf16)
               if ebf16 != train_bf16(args) else models)
    writer.text("validation: " + describe_eval_mode(ecfg, emodels))
    eval_student = make_eval_rollout(ecfg, *emodels, teacher=False)
    eval_teacher = make_eval_rollout(ecfg, *emodels, teacher=True, collect_ha=True)
    eval_student_test = (make_eval_rollout(ecfg, *emodels, teacher=False,
                                           compute_losses=False)
                         if args.submit else None)

    def validate(step):
        if emodels is not models:
            for em, m in zip(emodels, models):
                em.load_state_dict(m.state_dict())
        return run_validation(args, val_envs, eval_student, eval_teacher, tokenizer,
                              bank, bcfg, writer, step, device, runtime,
                              eval_student_test, timers=timers)

    if args.resume_file == "latest":
        args.resume_file = _find_latest_checkpoint(args.ckpt_dir)
        writer.text(f"auto-resume: {args.resume_file or 'no checkpoint, fresh start'}")
    _refuse_orbax(args.resume_file)
    if args.resume_file:
        ckpt.wait_for_saves()  # the file may be an in-flight async write
        ckpt.load_checkpoint(args.resume_file, state, optimizer=args.resume_optimizer)
        writer.text(f"\nLOAD the model from {args.resume_file}, iteration {state.step}")
    start_iter = state.step
    runtime.assert_replicas_identical(state)

    timers = PhaseTimer()
    if args.eval_first:
        validate(start_iter)

    def _prepare(items):
        """Host batch assembly, on the prefetch thread under ``--prefetch``."""
        with timers("map_bank"):
            bank_arr, slot_of = bank.prepare(items)
            if runtime.multiprocess:  # every process's bank of one shape
                runtime.sync_bank_growth(bank)
                bank_arr = bank.array
        with timers("batch_build"):
            batch, _ = make_train_batch(items, tokenizer, slot_of, bcfg, device=device)
        return bank_arr, batch

    def _epoch_batches():
        # the bank-growth sync is a collective: it stays on the main thread,
        # where it cannot interleave with the train step's collectives
        if args.prefetch and not runtime.multiprocess:
            return Prefetcher(train_env, _prepare, depth=2)
        return (_prepare(items) for items in train_env)

    best_spl, best_line = 0.0, ""
    interval = max(int(train_env.size() / args.batch_size), 1) * args.log_every
    generator = torch.Generator(device).manual_seed(args.seed + 1)
    guard = PreemptionGuard().install() if args.preempt_save else None
    history = []
    start = time.time()
    interval_t0 = time.time()
    preempted = False
    for idx in range(start_iter, start_iter + args.iters, interval):
        it = idx + interval
        metrics = []
        for _epoch in range(args.log_every):
            for bank_arr, batch in _epoch_batches():
                with timers("train_step"):
                    if args.profile_dir and len(history) + len(metrics) == 1:
                        # the second step: the first one builds the kernels
                        with profile_trace(args.profile_dir):
                            m = train_step(state, bank_arr, batch, generator)
                            m = {k: float(v) for k, v in m.items()}
                        writer.text(f"profiler trace written to {args.profile_dir}")
                    else:
                        m = train_step(state, bank_arr, batch, generator)
                metrics.append(m)
                # a collective in a multi-process run: every process stops
                # at the same step
                if guard is not None and runtime.any_flag(guard.triggered):
                    preempted = True
                    break
            if preempted:
                break
        metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
        history += metrics
        if preempted:
            if runtime.is_main:
                ckpt.save_checkpoint(args.ckpt_dir, f"latest_dict_{state.step}", state)
            ckpt.wait_for_saves()
            writer.text(f"\npreemption signal — saved latest_dict_{state.step}, "
                        "exiting cleanly (relaunch with --resume_file latest)")
            break
        il_loss = float(np.mean([m["loss"] for m in metrics]))
        eps = (len(metrics) * args.batch_size * runtime.process_count
               / max(time.time() - interval_t0, 1e-9))
        writer.scalars(it, {
            "loss/IL_loss": il_loss,
            "grad_norm/vln": float(np.mean([m["grad_norm_vln"] for m in metrics])),
            "grad_norm/bert": float(np.mean([m["grad_norm_bert"] for m in metrics])),
            "throughput/train_eps": eps})
        writer.text(f"\nIL_loss {il_loss:.4f}  ({eps:.1f} episodes/s)")
        writer.text(f"phase timers: {timers.summary()}")
        # checkpoints are process 0's to write, synchronously in a
        # multi-process run (no write may outlive the process group)
        do_async = args.async_ckpt and not runtime.multiprocess
        if runtime.is_main:
            with timers("checkpoint"):
                ckpt.save_checkpoint(args.ckpt_dir, f"latest_dict_{it}", state,
                                     asynchronous=do_async)
                if args.ckpt_keep > 0:
                    ckpt.wait_for_saves()  # never prune an in-flight write
                    _prune_checkpoints(args.ckpt_dir, args.ckpt_keep)
        results = validate(it)
        if "val_unseen" in results:
            spl = results["val_unseen"].get("spl", 0.0)
            if spl >= best_spl:
                best_spl, best_line = spl, f"Iter {it} spl {spl:.2f}"
                if runtime.is_main:
                    with timers("checkpoint"):
                        ckpt.save_checkpoint(args.ckpt_dir, "best_val_unseen", state,
                                             asynchronous=do_async)
        writer.text(f"{time.time() - start:.1f}s iter {it} BEST: {best_line}")
        # reset after the checkpoint and validation: the next interval's
        # episodes/s covers training only
        interval_t0 = time.time()
    if guard is not None:
        guard.uninstall()
    ckpt.wait_for_saves()
    return state, history
