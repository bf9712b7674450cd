"""Artifacts that the port's test files share across pytest-xdist workers.

The JAX gate checkpoint (the recipe of ``tests/test_render_mode_goldens.py``:
iters 8, lr 1e-3, exact render, on the fixture dataset, the native resampler
loaded first) and its export to a reference ``.pt`` by
``tools/export_torch_ckpt.py`` take minutes on the CPU, and several files
validate it; JAX's ``valid()`` of an LSTM checkpoint is made here too.
Each artifact here is made once per test session in an on-disk cache
under the session's temporary root, guarded by a file lock: the first
worker that asks makes it, the others wait for it and read it. Outside
xdist the cache lives under the session's own temporary directory.
"""

import json
import os
import shutil

import pytest
import torch
from filelock import FileLock

from fixtures import write_fixture_dataset
from test_e2e_loop import TINY_DARKNET_CFG, make_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Under xdist the workers share the host's cores: each worker's torch takes
# its share of them for its intra-op threads instead of all of them (every
# worker imports this module when it collects the port's test files), so the
# workers' CPU kernels do not oversubscribe the cores and spin against each
# other.
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))


def _session_dir(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent  # shared by the session's workers
    path = base / "torch_shared"
    path.mkdir(exist_ok=True)
    return path


def cached(tmp_path_factory, name, make):
    """``make(directory)``'s JSON-able result, made once per session into a
    fresh ``directory`` named ``name``. A half-made directory (its maker
    failed) is made again."""
    base = _session_dir(tmp_path_factory)
    out = base / name
    with FileLock(str(base / (name + ".lock"))):
        done = out / "result.json"
        if not done.exists():
            if out.exists():
                shutil.rmtree(out)
            out.mkdir()
            done.write_text(json.dumps(make(out)))
        return json.loads(done.read_text())


def fixture_dataset(tmp_path_factory):
    """``(root, tiny Darknet cfg path)`` of the fixture dataset
    (``tests/fixtures.py``, seeded)."""
    def make(out):
        root = write_fixture_dataset(str(out / "andh"))
        cfg_path = str(out / "tiny_yolo.cfg")
        with open(cfg_path, "w") as f:
            f.write(TINY_DARKNET_CFG)
        return {"root": root, "cfg_path": cfg_path}

    got = cached(tmp_path_factory, "dataset", make)
    return got["root"], got["cfg_path"]


def port_argv(args):
    """The port CLI's flags for a JAX ``make_args`` run."""
    flags = dict(root_dir=args.root_dir, output_dir=args.output_dir,
                 seed=args.seed, batch_size=args.batch_size,
                 max_action_len=args.max_action_len,
                 max_instr_len=args.max_instr_len, dialog_pad=args.dialog_pad,
                 demb=args.demb, encoder_heads=args.encoder_heads,
                 encoder_layers=args.encoder_layers, bert_layers=args.bert_layers,
                 nss_w=args.nss_w, darknet_model_file=args.darknet_model_file,
                 map_bank_px=args.map_bank_px, map_bank_slots=args.map_bank_slots,
                 inference=args.inference, render_twopass=args.render_twopass,
                 submit=args.submit)
    if args.resume_file:
        flags["resume_file"] = args.resume_file
    argv = []
    for k, v in flags.items():
        argv += ["--" + k, str(v)]
    return argv


def gate_checkpoint(tmp_path_factory):
    """The JAX gate checkpoint on the fixture dataset: ``{root, cfg_path,
    jax_ckpt (the orbax best_val_unseen), pt (its reference-format
    export)}``."""
    root, cfg_path = fixture_dataset(tmp_path_factory)

    def make(out):
        import importlib.util

        from avdn_tpu.data import native
        from avdn_tpu.train.loop import train

        targs = make_args(root, str(out / "train"), cfg_path, iters=8, log_every=1,
                          seed=0, lr=1e-3, render_twopass=False)
        # load the native resampler before the JAX bank's decode threads do: a
        # thread that races its first load falls back to OpenCV (±1
        # intensity), trains another checkpoint and misses the goldens
        # (ROADMAP.md queue 3)
        native.available()
        train(targs)
        spec = importlib.util.spec_from_file_location(
            "export_torch_ckpt", os.path.join(REPO, "tools", "export_torch_ckpt.py"))
        export = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(export)
        jax_ckpt = os.path.join(targs.ckpt_dir, "best_val_unseen")
        pt = str(out / "best_val_unseen.pt")
        export.main(port_argv(targs) + ["--resume_file", jax_ckpt, "--output", pt])
        return {"jax_ckpt": jax_ckpt, "pt": pt}

    got = cached(tmp_path_factory, "gate_checkpoint", make)
    return dict(got, root=root, cfg_path=cfg_path)


def metrics_of(log_dir):
    """The scalars of a run's ``metrics.jsonl`` (throughput excluded)."""
    recs = [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]
    return {k: float(v) for r in recs for k, v in r.items()
            if k != "step" and isinstance(v, (int, float))
            and not k.startswith("throughput/")}


def _mode_argv(over):
    """The port CLI's flags for a render-mode entry's extra overrides."""
    argv = []
    for k, v in over.items():
        if k != "render_twopass":  # port_argv passes it
            argv += ["--" + k, str(v)]
    return argv


def port_mode_run(tmp_path_factory, mode):
    """The port CLI's ``valid()`` of the gate checkpoint on the CPU in the
    render mode ``mode`` of ``tests/test_render_mode_goldens.py:MODES``:
    ``{"metrics", "log" (valid.txt), "run_dir" (the working directory),
    "output_dir", "results" (valid()'s), "timer_phases"}``. The exact run
    is also the ``--submit`` run, without ``--prefetch`` and with
    ``--profile_dir run_dir/trace`` (``test_torch_valid.py`` checks its
    Eval.ai file and trace; the metrics do not depend on them)."""
    from test_render_mode_goldens import MODES

    gate = gate_checkpoint(tmp_path_factory)

    def make(out):
        from avdn_tpu_torch.cli.train_et import main as port_main

        over = MODES[mode]
        extra = (["--prefetch", "False", "--profile_dir", str(out / "trace")]
                 if mode == "exact" else [])
        args = make_args(gate["root"], str(out / "out"), gate["cfg_path"],
                         inference=True, seed=0, resume_file=gate["pt"],
                         submit=mode == "exact", **over)
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(out)
            results, timers = port_main(port_argv(args) + _mode_argv(over) + extra,
                                        device="cpu")
        with open(os.path.join(args.log_dir, "valid.txt")) as f:
            return {"metrics": metrics_of(args.log_dir), "log": f.read(),
                    "run_dir": str(out), "output_dir": args.output_dir,
                    "results": results, "timer_phases": sorted(timers.totals)}

    return cached(tmp_path_factory, f"port_valid_{mode}", make)


def jax_twopass_bf16_one_device(tmp_path_factory):
    """JAX's own ``valid()`` of the gate checkpoint in the ``twopass_bf16``
    mode at the port's batch layout (the whole batch on one device,
    ``AVDN_DP_DEVICES=1``): its metrics."""
    from test_render_mode_goldens import MODES

    gate = gate_checkpoint(tmp_path_factory)

    def make(out):
        from avdn_tpu.train.loop import valid as jax_valid

        jargs = make_args(gate["root"], str(out / "out"), gate["cfg_path"],
                          inference=True, seed=0, resume_file=gate["jax_ckpt"],
                          **MODES["twopass_bf16"])
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(out)
            mp.setenv("AVDN_DP_DEVICES", "1")
            jax_valid(jargs)
        return metrics_of(jargs.log_dir)

    return cached(tmp_path_factory, "jax_valid_twopass_bf16_one_device", make)


def recording_successes(mp, module, log):
    """Inside the ``pytest.MonkeyPatch`` ``mp``, ``module.eval_metrics``
    (a validation driver's) also appends each nav eval's per-episode success
    ``{instr_id: success}`` to ``log``."""
    real = module.eval_metrics

    def eval_metrics(preds, human_att_eval=False):
        avg, per = real(preds, human_att_eval=human_att_eval)
        if not human_att_eval:
            log.append({str(i): bool(s) for i, s in zip(per["instr_id"], per["success"])})
        return avg, per

    mp.setattr(module, "eval_metrics", eval_metrics)


def jax_lstm_valid(tmp_path_factory):
    """An LSTM agent checkpoint of the JAX package's random init (seed 0, the
    fixture widths: BERT 2×64, the tiny Darknet, ``HAALSTM`` at ``demb`` 64)
    exported by ``export_reference_agent(family="lstm")``, and JAX's
    ``valid()`` of it at the reference numerics (exact render, fp32):
    ``{root, cfg_path, pt, metrics, successes (per nav eval, {instr_id:
    success})}``."""
    root, cfg_path = fixture_dataset(tmp_path_factory)

    def make(out):
        import jax

        import avdn_tpu.train.loop as jax_loop
        from avdn_tpu.compat.torch_export import export_reference_agent
        from avdn_tpu.data import native

        args = make_args(root, str(out / "out"), cfg_path, family="lstm", inference=True,
                         seed=0, render_twopass=False, bf16=False)
        cfg = jax_loop.train_config_from_args(args)
        bert, dk, vln = jax_loop.build_models(args, bf16=False)
        state = jax.device_get(jax.jit(lambda k: jax_loop.init_state(
            args, bert, dk, vln, cfg, k))(jax.random.PRNGKey(0)))
        pt = str(out / "lstm_agent.pt")
        export_reference_agent(pt, "lstm", dk.cfg.block_dicts(),
                               {"params": state.bert_params},
                               {"params": state.darknet_params,
                                "batch_stats": state.batch_stats},
                               {"params": state.vln_params}, bert_layers=args.bert_layers)
        args.resume_file = pt
        native.available()  # before the bank's decode threads (ROADMAP.md queue 3)
        successes = []
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(out)
            recording_successes(mp, jax_loop, successes)
            jax_loop.valid(args)
        return {"pt": pt, "metrics": metrics_of(args.log_dir), "successes": successes}

    return dict(cached(tmp_path_factory, "jax_lstm_valid", make), root=root,
                cfg_path=cfg_path)


# ------------------------------------------------- shared dropout masks --

_HASH_MUL = (2654435761, 2246822519)


def _hash_keep_torch(shape, keep, device):
    """The keep mask of ``shared_dropout_masks`` in torch (int64 arithmetic
    kept to 32 bits)."""
    m = 0xFFFFFFFF
    h = torch.arange(int(torch.Size(shape).numel()), dtype=torch.int64, device=device)
    h = (h * _HASH_MUL[0]) & m
    h = h ^ (h >> 15)
    h = (h * _HASH_MUL[1]) & m
    h = h ^ (h >> 13)
    return ((h >> 8) < int(keep * (1 << 24))).reshape(shape)


def _hash_keep_jax(shape, keep):
    """The keep mask of ``shared_dropout_masks`` in uint32 jax.numpy."""
    import math

    import jax.numpy as jnp

    h = jnp.arange(math.prod(shape), dtype=jnp.uint32)
    h = h * jnp.uint32(_HASH_MUL[0])
    h = h ^ (h >> 15)
    h = h * jnp.uint32(_HASH_MUL[1])
    h = h ^ (h >> 13)
    return ((h >> 8) < jnp.uint32(int(keep * (1 << 24)))).reshape(shape)


def shared_dropout_masks(mp):
    """Inside the ``pytest.MonkeyPatch`` ``mp``, every dropout of both
    packages keeps the same elements: the mask of a tensor is a fixed hash
    of each element's flat index (kept with probability ≈ 1 − rate), with
    each package's own semantics around it (``where(mask, x / keep, 0)``,
    the identity in eval mode or at rate 0). The two sides' draws then
    coincide, so a train step with dropout on can be compared op for op.
    The JAX package is not edited: flax's ``Dropout.__call__`` is replaced
    while a function is traced."""
    import flax.linen as nn
    import jax

    from avdn_tpu_torch.models import layers

    def port_forward(self, x, generator=None):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        return torch.where(_hash_keep_torch(x.shape, keep, x.device), x / keep, 0.0)

    def flax_call(self, x, deterministic=None, rng=None):
        if nn.merge_param("deterministic", self.deterministic, deterministic) \
                or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        return jax.lax.select(_hash_keep_jax(x.shape, keep), x / keep,
                              jax.numpy.zeros_like(x))

    mp.setattr(layers.Dropout, "forward", port_forward)
    mp.setattr(nn.Dropout, "__call__", flax_call)
