"""The port's eval modes against the JAX package's metric goldens, on the CPU
at tiny width (the fixture and gate of ``tests/test_render_mode_goldens.py``).

One checkpoint is trained by the JAX package with the gate recipe (iters 8,
lr 1e-3, exact render, the native resampler loaded first), exported with
``tools/export_torch_ckpt.py`` and validated by the port's CLI once in the
exact mode and once in each fast mode of that file's ``MODES``: the two-pass
render with the auto-sized crop, the same with bf16 towers, the subsample-2
gather and the int8 tower on the two-pass render. Each fast mode must

* reproduce its ``tests/golden/eval_metrics_<mode>.json``: the same keys,
  every value within that mode's ``PIN_TOL`` (rtol = atol), SR and oracle
  SR exactly equal;
* pass the ``GATE`` of ``tests/test_render_mode_goldens.py`` against the
  port's own exact run (no success flips in the shipped modes, one episode
  per split for subsample-2).

On the CPU the two-pass weights are float32 (as in the JAX package) and
``--bf16 True`` runs bf16 towers, so the bf16 mode is held here too, with
one change of reference. The committed bf16 golden is JAX's ``valid()``
with the batch of 2 split over two CPU devices, one item each (the
8-device mesh of ``tests/conftest.py``); the port runs the batch of 2 on
one device. XLA compiles the per-device shapes differently, and the bf16
student trajectories are closed-loop, so one bf16 rounding flip moves the
next view: JAX's own bf16 ``valid()`` on the same checkpoint moves past
``PIN_TOL`` when only that layout changes
(``test_bf16_golden_depends_on_batch_layout``), while the float32 modes do
not. The bf16 mode is therefore held to JAX's ``valid()`` at the port's
layout (``AVDN_DP_DEVICES=1``), run here on the same checkpoint, within the
same ``PIN_TOL`` and with SR and oracle SR equal to that run and to the
committed golden.
"""

import json
import os

import numpy as np
import pytest

from fixtures import write_fixture_dataset
from test_e2e_loop import TINY_DARKNET_CFG, make_args
from test_render_mode_goldens import GATE, MODES, PIN_TOL
from test_render_mode_goldens import test_fast_mode_matches_exact_metrics as _gate
from test_torch_valid import REPO, _metrics, _port_argv

FAST_MODES = [m for m in MODES if m != "exact"]


def _mode_argv(over):
    """The port CLI's flags for a ``MODES`` entry's extra overrides."""
    argv = []
    for k, v in over.items():
        if k != "render_twopass":  # _port_argv passes it
            argv += ["--" + k, str(v)]
    return argv


@pytest.fixture(scope="module")
def port_metrics(tmp_path_factory):
    """Train the gate checkpoint in JAX, export it, validate it with the
    port's CLI in the exact mode and every fast mode; ``{mode: metrics}``,
    each run's ``valid.txt`` and JAX's bf16 metrics at the port's layout."""
    import importlib.util

    from avdn_tpu.data import native
    from avdn_tpu.train.loop import train
    from avdn_tpu_torch.cli.train_et import main as port_main

    root = write_fixture_dataset(str(tmp_path_factory.mktemp("andh_modes")))
    out = str(tmp_path_factory.mktemp("out_train"))
    cfg_path = os.path.join(out, "tiny_yolo.cfg")
    with open(cfg_path, "w") as f:
        f.write(TINY_DARKNET_CFG)
    targs = make_args(root, out, cfg_path, iters=8, log_every=1, seed=0,
                      lr=1e-3, render_twopass=False)
    # the native resampler first: a bank decode thread racing its load falls
    # back to OpenCV and trains another checkpoint (ROADMAP.md queue 3)
    native.available()
    train(targs)
    spec = importlib.util.spec_from_file_location(
        "export_torch_ckpt", os.path.join(REPO, "tools", "export_torch_ckpt.py"))
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    pt = os.path.join(out, "best_val_unseen.pt")
    export.main(_port_argv(targs) + [
        "--resume_file", os.path.join(targs.ckpt_dir, "best_val_unseen"),
        "--output", pt])

    # JAX's own bf16 run at the port's layout: the whole batch on one device
    from avdn_tpu.train.loop import valid as jax_valid

    jax_dir = tmp_path_factory.mktemp("jax_twopass_bf16_one_device")
    jargs = make_args(root, str(jax_dir / "out"), cfg_path, inference=True, seed=0,
                      resume_file=os.path.join(targs.ckpt_dir, "best_val_unseen"),
                      **MODES["twopass_bf16"])
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(jax_dir)
        mp.setenv("AVDN_DP_DEVICES", "1")
        jax_valid(jargs)
    jax_one_device = _metrics(jargs.log_dir)

    metrics, logs = {}, {}
    for mode, over in MODES.items():
        run_dir = tmp_path_factory.mktemp(f"port_{mode}")
        args = make_args(root, str(run_dir / "out"), cfg_path, inference=True,
                         seed=0, resume_file=pt, **over)
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(run_dir)
            port_main(_port_argv(args) + _mode_argv(over), device="cpu")
        metrics[mode] = _metrics(args.log_dir)
        with open(os.path.join(args.log_dir, "valid.txt")) as f:
            logs[mode] = f.read()
    return metrics, logs, jax_one_device


def _golden(mode):
    with open(os.path.join(REPO, "tests", "golden", f"eval_metrics_{mode}.json")) as f:
        return json.load(f)


def _assert_reproduces(got, want, mode):
    assert set(got) == set(want), (sorted(set(got) - set(want)),
                                   sorted(set(want) - set(got)))
    for k in sorted(want):
        if k.startswith(("sr/", "oracle_sr/")):
            assert got[k] == want[k], k
        np.testing.assert_allclose(got[k], want[k], rtol=PIN_TOL[mode],
                                   atol=PIN_TOL[mode], err_msg=f"{mode} {k}")


@pytest.mark.parametrize("mode", FAST_MODES)
def test_mode_reproduces_golden(port_metrics, mode):
    """The committed golden; for bf16, JAX's run of it at the port's
    layout (module docstring), and the committed golden's SR and oracle
    SR."""
    got, golden = port_metrics[0][mode], _golden(mode)
    if mode == "twopass_bf16":
        for k in golden:
            if k.startswith(("sr/", "oracle_sr/")):
                assert got[k] == golden[k], k
        golden = port_metrics[2]
    _assert_reproduces(got, golden, mode)


def test_bf16_golden_depends_on_batch_layout(port_metrics):
    """The evidence for the bf16 reference: on one checkpoint, JAX's own
    twopass_bf16 ``valid()`` with the batch on one device leaves the
    committed golden (two devices, one item each) by more than ``PIN_TOL``
    in some metric, with SR and oracle SR unchanged. The float32 two-pass
    golden, run by the port at the one-device layout, holds within 1e-3
    (``test_mode_reproduces_golden[twopass]``). ``-s`` prints the
    readings."""
    jax_one, golden, port = port_metrics[2], _golden("twopass_bf16"), \
        port_metrics[0]["twopass_bf16"]
    assert set(jax_one) == set(golden)
    tol = {k: PIN_TOL["twopass_bf16"] * (1 + abs(golden[k])) for k in golden}
    print("\nkey  golden(JAX, 2 devices)  JAX 1 device  port  |JAX1-golden|/tol")
    for k in sorted(golden):
        print(f"{k} {golden[k]!r} {jax_one[k]!r} {port[k]!r} "
              f"{abs(jax_one[k] - golden[k]) / tol[k]:.3f}")
        if k.startswith(("sr/", "oracle_sr/")):
            assert jax_one[k] == golden[k], k
    assert max(abs(jax_one[k] - golden[k]) / tol[k] for k in golden) > 1.0


@pytest.mark.parametrize("mode", FAST_MODES)
def test_mode_passes_gate_against_port_exact(port_metrics, mode):
    """The JAX package's gate (``GATE[mode]`` flips, continuous and
    saliency tolerances) between the port's fast and exact runs."""
    assert mode in GATE
    _gate(port_metrics[0], mode)


@pytest.mark.parametrize("mode", list(MODES))
def test_valid_log_names_the_mode(port_metrics, mode):
    """``valid.txt`` says which dtype, tower and render the run used."""
    over = MODES[mode]
    line = next(l for l in port_metrics[1][mode].splitlines() if l.startswith("device"))
    assert "towers " + ("bfloat16" if over.get("bf16") else "float32") in line
    assert ("int8 Darknet" if over.get("quant") == "int8" else "BN-folded Darknet") in line
    if over.get("render_twopass"):
        assert "two-pass render, crop 320 px" in line, line
    else:
        assert "exact render" in line
        assert ("subsample 2" in line) == (over.get("render_subsample") == 2)
