"""The regime gate of the port's production train recipe: does the port,
trained with ``--preset production``'s flags, learn like the JAX package?

The port trains the fixture dataset with
``tests/test_production_train_golden.py``'s ``PRODUCTION_OVERRIDES`` (batch
16, bf16 towers, the two-pass render in training, dots remat, ``log_every``
4) and its schedule (``iters`` 8, seed 0, lr 1e-3: two intervals of four
steps, each with a checkpoint and a validation), from the JAX package's own
tiny init at seed 0 (its ``init_state``, exported by
``compat/torch_export.py`` and loaded through ``--resume_file``), on one CPU
thread (a training's trajectory depends on the thread count; the tier-1
run's xdist workers have one each), and validates ``best_val_unseen.pt``
with the exact float32 render at batch 2. Three runs:

* ``bf16``: the recipe with every dropout mask a fixed hash of the
  element's index (``torch_shared.shared_dropout_masks``), the masks the
  JAX package's run ``JAX_SHARED_MASKS["bf16"]`` drew too. Held to that run
  in either direction within the budgets of the JAX gate
  (``test_production_not_worse_than_reference``): SR, oracle SR and SPL one
  episode of a split (100/16), goal progress 2.5 m, IoU 0.05, the saliency
  metrics 0.15, episode counts and GT lengths equal. Readings: SR and oracle
  SR equal, SPL 0.28 / 0.20 apart, GP 0.26 / 0.42 m, IoU 0.004, NSS 0.006;
  the intervals' IL_loss 6.8e-4 and 5.0e-3 relative (bf16's roundings
  differ between autograd and XLA's transposes).
* ``fp32``: the same with fp32 towers, held to ``JAX_SHARED_MASKS["fp32"]``
  step for step: IL_loss within 1e-4 relative (readings 5.7e-8, 2.6e-6),
  SR, oracle SR and the counts equal, every other metric within 1e-3
  relative + 1e-3 (largest reading: SPL 1.4e-3 on 36.09).
* ``generator``: the recipe with the train driver's own dropout generator
  (``--seed`` + 1): 8 finite steps and SR > 0.

Every run's metric set is ``tests/golden/eval_metrics_production_train.json``'s.

Why the same masks. The two packages draw their masks from different
generators, and one run's metrics move with the draw by about one episode
a split: the tolerance study (``study`` below, run as a script on an 8-core
Intel Xeon CPU with torch 2.13 and jax 0.9, the production recipe in bf16,
the validation exact) trained the JAX package with 20 dropout seeds (1–20,
one device) and the port with 40 (1–40, one thread). val_seen / val_unseen,
mean (sample sd) per run:

* SR: JAX 39.06 (7.82) / 35.31 (5.83); the port 36.56 (6.87) / 33.91 (6.31);
* SPL: JAX 34.34 (6.71) / 30.56 (5.35); the port 32.33 (6.34) / 28.89 (5.52);
* the golden (JAX, seed 1, eight devices): SR 37.5 / 37.5, SPL 34.0 / 31.6.

The port's means sit 0.9–1.2 standard errors under JAX's (0.2–0.4 episode),
with the same spread. A single draw against a single draw at a one-episode
budget fails about as often as it passes whatever the code, and so does a
three-seed mean: the port's seeds 1–3 average 27.1 val_unseen SR and its
seeds 1–10 30.0, while its seeds 11–40 average 35.2 (JAX's seeds 1–5: 37.5,
6–20: 34.6). With the masks shared, the runs are the same function of the
same noise, and what is left between them is rounding: in fp32 the port
trains as JAX does step for step, and the bf16 run lands within the budgets
with SR equal. A recipe regression such as a bf16 divergence, a corrupt
render in the loss path or a dropout site out of place moves these runs by
many episodes (removing the saliency projection's dropout fails
``tests/test_torch_train_step_dropout.py``'s one step on every group).
"""

import json
import os
import sys

if __name__ == "__main__":  # the tolerance study (``study``), run as a script
    os.environ["JAX_PLATFORMS"] = "cpu"
    if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8").strip()
    _here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [_here, os.path.dirname(_here)]

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from test_e2e_loop import make_args  # noqa: E402
from test_production_train_golden import (  # noqa: E402
    GOLDEN_PATH,
    PRODUCTION_OVERRIDES,
    _episodes_per_split,
)
from torch_shared import (fixture_dataset, metrics_of, port_argv,  # noqa: E402
                          shared_dropout_masks)

#: the JAX package's run of the recipe with the shared masks, per tower
#: dtype (``python tests/test_torch_production_train.py --side jax --seeds 1
#: --shared_masks --bf16 True|False``: eight CPU devices, as
#: ``tests/conftest.py`` gives the JAX package's own tests): the exact
#: float32 validation of its ``best_val_unseen`` and the two intervals'
#: ``IL_loss``
JAX_SHARED_MASKS = {
    "bf16": {
        "interval_losses": [1.31108558177948, 0.7287313342094421],
        "metrics": {
            "HA_precision/val_seen_ha": 0.8244026510510594,
            "HA_precision/val_unseen_ha": 0.7202117225776116,
            "HA_recall/val_seen_ha": 0.4042996828754743,
            "HA_recall/val_unseen_ha": 0.42777248389191097,
            "gp/val_seen": -1.892199842144918,
            "gp/val_unseen": -2.038096208234741,
            "gp_1/val_seen": -1.892199842144918,
            "gp_1/val_unseen": -2.038096208234741,
            "gt_length/val_seen": 57.80755296433828,
            "gt_length/val_unseen": 60.97692312303616,
            "iou/val_seen": 0.27537150494754314,
            "iou/val_unseen": 0.24078304891008884,
            "lengths/val_seen": 12.526861339308754,
            "lengths/val_unseen": 15.598770551265023,
            "nss/val_seen_ha": 0.05266323145093618,
            "nss/val_unseen_ha": -0.01101262038401174,
            "num_1/val_seen": 16.0,
            "num_1/val_unseen": 16.0,
            "oracle_gp/val_seen": 2.240615422515141,
            "oracle_gp/val_unseen": 4.459551817615536,
            "oracle_sr/val_seen": 50.0,
            "oracle_sr/val_unseen": 50.0,
            "spl/val_seen": 34.33611919477484,
            "spl/val_unseen": 22.217100655897603,
            "spl_1/val_seen": 34.33611919477484,
            "spl_1/val_unseen": 22.217100655897603,
            "sr/val_seen": 43.75,
            "sr/val_unseen": 25.0,
            "sr_1/val_seen": 43.75,
            "sr_1/val_unseen": 25.0,
        },
    },
    "fp32": {
        "interval_losses": [1.312156319618225, 0.7267106771469116],
        "metrics": {
            "HA_precision/val_seen_ha": 0.8237929014023393,
            "HA_precision/val_unseen_ha": 0.7207677068395747,
            "HA_recall/val_seen_ha": 0.38961974705259006,
            "HA_recall/val_unseen_ha": 0.40967270400789046,
            "gp/val_seen": -1.2536227873522907,
            "gp/val_unseen": -1.9157211176719153,
            "gp_1/val_seen": -1.2536227873522907,
            "gp_1/val_unseen": -1.9157211176719153,
            "gt_length/val_seen": 57.80755296433828,
            "gt_length/val_unseen": 60.97692312303616,
            "iou/val_seen": 0.28344863709207857,
            "iou/val_unseen": 0.22919288014236372,
            "lengths/val_seen": 9.668884215607518,
            "lengths/val_unseen": 11.614427781263643,
            "nss/val_seen_ha": 0.04915186498019463,
            "nss/val_unseen_ha": -0.002448851797824503,
            "num_1/val_seen": 16.0,
            "num_1/val_unseen": 16.0,
            "oracle_gp/val_seen": 1.8934489111360424,
            "oracle_gp/val_unseen": 3.502281784267713,
            "oracle_sr/val_seen": 50.0,
            "oracle_sr/val_unseen": 50.0,
            "spl/val_seen": 36.09248677871,
            "spl/val_unseen": 22.34641278844752,
            "spl_1/val_seen": 36.09248677871,
            "spl_1/val_unseen": 22.34641278844752,
            "sr/val_seen": 43.75,
            "sr/val_unseen": 25.0,
            "sr_1/val_seen": 43.75,
            "sr_1/val_unseen": 25.0,
        },
    },
}

#: the runs: (tower dtype, shared masks)
RUNS = {"bf16": ("True", True), "fp32": ("False", True),
        "generator": ("True", False)}


def _jax_init_checkpoint(root, cfg_path, out):
    """The JAX package's tiny init at seed 0 as a reference-format ``.pt``."""
    import jax

    from avdn_tpu.compat.torch_export import export_reference_agent
    from avdn_tpu.train.loop import build_models, init_state, train_config_from_args

    args = make_args(root, out, cfg_path, iters=8, seed=0, lr=1e-3,
                     **PRODUCTION_OVERRIDES)
    bert, dk, vln = build_models(args, bf16=False)
    state = jax.jit(lambda key: init_state(args, bert, dk, vln,
                                           train_config_from_args(args), key))(
        jax.random.PRNGKey(0))
    path = os.path.join(out, "jax_init.pt")
    export_reference_agent(
        path, "et", dk.cfg.block_dicts(), {"params": state.bert_params},
        {"params": state.darknet_params, "batch_stats": state.batch_stats},
        {"params": state.vln_params}, bert_layers=args.bert_layers,
        et_layers=args.encoder_layers)
    return args, path


def train_and_validate(out, init, generator_seed, extra=()):
    """The port's production training from the JAX init ``(args, .pt)``
    into the directory ``out``, its train driver's dropout generator seeded
    with ``generator_seed`` (the driver's own seed is ``--seed`` + 1) and
    the CLI flags ``extra`` last, then the exact float32 validation of its
    ``best_val_unseen.pt``: its metrics, steps and losses."""
    import torch

    import avdn_tpu_torch.train.loop as loop
    from avdn_tpu_torch.cli.train_et import main

    args, pt = init
    argv = port_argv(args) + [
        "--output_dir", out, "--iters", "8", "--log_every", str(args.log_every),
        "--lr", "1e-3", "--resume_file", pt, "--render_crop", "0", "--bf16", "True",
        "--remat", "True", "--remat_policy", "dots", *extra]

    class Seeded(torch.Generator):
        def manual_seed(self, seed):
            return super().manual_seed(generator_seed if seed == args.seed + 1 else seed)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop.torch, "Generator", Seeded)
        state, history = main(argv, device="cpu")
    ckpt = os.path.join(out, "ckpts", "best_val_unseen.pt")
    vargs = make_args(args.root_dir, os.path.join(out, "eval"), args.darknet_model_file,
                      inference=True, seed=0, resume_file=ckpt, render_twopass=False,
                      bf16=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(out)
        main(port_argv(vargs) + ["--bf16", "False"], device="cpu")
    return {"metrics": metrics_of(vargs.log_dir), "steps": state.step,
            "losses": [m["loss"] for m in history]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch

    root, cfg_path = fixture_dataset(tmp_path_factory)
    init = _jax_init_checkpoint(root, cfg_path, str(tmp_path_factory.mktemp("jax_init")))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for name, (bf16, shared) in RUNS.items():
            with pytest.MonkeyPatch.context() as mp:
                if shared:
                    shared_dropout_masks(mp)
                run_dir = str(tmp_path_factory.mktemp(f"port_production_{name}"))
                out[name] = train_and_validate(run_dir, init, 1, ["--bf16", bf16])
                out[name]["interval_losses"] = _interval_losses(
                    os.path.join(run_dir, "logs"))
    finally:
        torch.set_num_threads(threads)
    return out


def test_trains_the_recipe(runs):
    for run in runs.values():
        assert run["steps"] == 8
        assert all(np.isfinite(v) and v > 0 for v in run["losses"])
        assert set(run["metrics"]) == set(json.load(open(GOLDEN_PATH)))


def test_success_metrics_nonzero(runs):
    for run in runs.values():
        srs = {k: v for k, v in run["metrics"].items() if k.startswith("sr/")}
        assert srs and any(v > 0 for v in srs.values()), srs


def test_metrics_within_the_jax_run_budgets(runs):
    """The bf16 run with the shared masks against the JAX package's, in
    either direction, within the JAX gate's budgets (module docstring)."""
    want = JAX_SHARED_MASKS["bf16"]["metrics"]
    got = runs["bf16"]["metrics"]
    bad = []
    for k in sorted(want):
        d = got[k] - want[k]
        if k.startswith(("sr", "oracle_sr", "spl")):
            budget = 100.0 / _episodes_per_split(want, k) + 1e-6
        elif k.startswith(("gp", "oracle_gp")):
            budget = 2.5
        elif k.startswith("iou"):
            budget = 0.05
        elif k.startswith(("nss", "HA_")):
            budget = 0.15
        elif k.startswith(("gt_length", "num_")):
            budget = 0.0
        else:
            continue  # lengths: informational, as in the JAX gate
        if abs(d) > budget:
            bad.append((k, got[k], want[k], budget))
    assert not bad, bad


def test_fp32_trains_as_jax(runs):
    """The fp32 run with the shared masks against the JAX package's, step
    for step (module docstring)."""
    ref = JAX_SHARED_MASKS["fp32"]
    run = runs["fp32"]
    np.testing.assert_allclose(run["interval_losses"], ref["interval_losses"], rtol=1e-4)
    for k, want in sorted(ref["metrics"].items()):
        if k.startswith(("sr", "oracle_sr", "num_")):
            assert run["metrics"][k] == want, (k, run["metrics"][k], want)
        else:
            np.testing.assert_allclose(run["metrics"][k], want, rtol=1e-3, atol=1e-3,
                                       err_msg=k)


# ------------------------------------------------- the tolerance study --


def _interval_losses(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r["loss/IL_loss"] for r in map(json.loads, f) if "loss/IL_loss" in r]


def jax_run(root, cfg_path, out, seed, bf16, no_dropout):
    """The JAX package's production training with the dropout stream of
    ``seed``, then its exact float32 ``valid()`` of ``best_val_unseen``."""
    import flax.linen
    import jax

    import avdn_tpu.train.loop as jax_loop

    args = make_args(root, os.path.join(out, "train"), cfg_path, iters=8, seed=0,
                     lr=1e-3, **dict(PRODUCTION_OVERRIDES, bf16=bf16))
    real = jax.random.PRNGKey
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loop.jax.random, "PRNGKey",
                   lambda s, *a, **k: real(seed if s == args.seed + 1 else s, *a, **k))
        if no_dropout:
            mp.setattr(flax.linen.Dropout, "__call__",
                       lambda self, x, deterministic=None, rng=None: x)
        jax_loop.train(args)
    vargs = make_args(root, os.path.join(out, "eval"), cfg_path, inference=True, seed=0,
                      resume_file=os.path.join(args.ckpt_dir, "best_val_unseen"),
                      render_twopass=False, bf16=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(out)
        jax_loop.valid(vargs)
    return {"metrics": metrics_of(vargs.log_dir),
            "interval_losses": _interval_losses(args.log_dir)}


def study():
    """The tolerance study behind this gate: the production recipe trained
    on the fixture dataset once per dropout seed, from the JAX package's tiny
    init at seed 0, each ``best_val_unseen`` then validated with the exact
    float32 render at batch 2, by the port or by the JAX package, on the
    CPU.

        python tests/test_torch_production_train.py --side port --seeds $(seq 1 40) --threads 1
        python tests/test_torch_production_train.py --side jax --seeds $(seq 1 20) --devices 1
        python tests/test_torch_production_train.py --side jax --seeds 1 2 3 4 5
        python tests/test_torch_production_train.py --side port --seeds 1 --no_dropout --bf16 False
        python tests/test_torch_production_train.py --side jax --seeds 1 --no_dropout --bf16 False
        python tests/test_torch_production_train.py --side jax --seeds 1 --shared_masks --bf16 True
        python tests/test_torch_production_train.py --side port --seeds 1 --shared_masks --bf16 True

    ``--seeds`` replace the seed of the train driver's dropout stream (its own
    is ``--seed`` + 1 = 1: a ``torch.Generator`` in the port, a
    ``jax.random.PRNGKey`` in the JAX package). ``--threads`` sets torch's
    intra-op threads (the port's trajectories depend on it); ``--devices``
    caps the JAX package's data-parallel width (``AVDN_DP_DEVICES``; the CPU
    shows eight devices, as under ``tests/conftest.py``). ``--bf16`` sets the
    towers' dtype in training, ``--no_dropout`` turns every dropout off (the
    port's rates, flax's ``Dropout`` the identity), and ``--shared_masks``
    gives both packages the same masks (``torch_shared.shared_dropout_masks``;
    the seeds then move nothing but the loss's heading jitter): either leaves
    the two packages' runs comparable step for step. Prints one JSON line per run (the
    validation metrics and the train intervals' ``IL_loss``), then each
    metric's per-seed values, mean and sample standard deviation. A JAX run
    takes ~2-3 minutes, a port run ~30 s on one thread.
    """
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description=study.__doc__.split("\n\n")[0])
    ap.add_argument("--side", choices=("port", "jax"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--bf16", default="True", help="--bf16 in training (towers)")
    ap.add_argument("--no_dropout", action="store_true")
    ap.add_argument("--shared_masks", action="store_true",
                    help="every dropout mask a fixed hash of the element's index, "
                         "the same in both packages (torch_shared.shared_dropout_masks)")
    ap.add_argument("--work_dir", default=None)
    a = ap.parse_args()
    if a.devices:
        os.environ["AVDN_DP_DEVICES"] = str(a.devices)
    import torch

    from avdn_tpu.data import native
    from fixtures import write_fixture_dataset
    from test_e2e_loop import TINY_DARKNET_CFG

    torch.set_num_threads(a.threads)
    native.available()  # before any bank's decode threads (ROADMAP.md queue 3)
    work = a.work_dir or tempfile.mkdtemp(prefix="production_study_")
    root = write_fixture_dataset(os.path.join(work, "andh"))
    cfg_path = os.path.join(work, "tiny_yolo.cfg")
    with open(cfg_path, "w") as f:
        f.write(TINY_DARKNET_CFG)
    init = _jax_init_checkpoint(root, cfg_path, work) if a.side == "port" else None
    runs = []
    for seed in a.seeds:
        out = os.path.join(work, f"{a.side}_{seed}")
        os.makedirs(out, exist_ok=True)
        with pytest.MonkeyPatch.context() as mp:
            if a.shared_masks:
                shared_dropout_masks(mp)
            if a.no_dropout:
                from avdn_tpu_torch.models import layers

                mp.setattr(layers.Dropout, "forward", lambda self, x, generator=None: x)
            if a.side == "port":
                run = train_and_validate(out, init, seed, ["--bf16", a.bf16])
                run["interval_losses"] = _interval_losses(os.path.join(out, "logs"))
            else:
                run = jax_run(root, cfg_path, out, seed, a.bf16 == "True",
                              a.no_dropout)
        runs.append(run["metrics"])
        print(json.dumps({"side": a.side, "seed": seed, "threads": a.threads,
                          "devices": a.devices, "bf16": a.bf16,
                          "no_dropout": a.no_dropout, "shared_masks": a.shared_masks,
                          **run}), flush=True)
    for k in sorted(runs[0]):
        v = [r[k] for r in runs]
        sd = float(np.std(v, ddof=1)) if len(v) > 1 else float("nan")
        print(f"{k:32s} {' '.join(f'{x:9.4f}' for x in v)}  mean {np.mean(v):9.4f}  "
              f"sd {sd:7.4f}")


if __name__ == "__main__":
    study()
