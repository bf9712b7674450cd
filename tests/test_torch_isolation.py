"""The port stands alone and never falls back quietly.

* Importing every module of ``avdn_tpu_torch`` loads no ``jax``, ``flax``
  or ``avdn_tpu`` module (checked in a fresh interpreter), and neither the
  package nor ``chip_smoke.py`` names one in an import.
* Without a card, an entry point given no ``device`` raises instead of
  running on the CPU, and ``chip_smoke.py`` exits non-zero without a result.
* Every eval mode of the JAX package is accepted (the shipped defaults and
  the opt-in modes), the LSTM family (its student stop threshold 0.25),
  training at the reference configuration and the production recipe; a
  multi-process flag the process cannot honour raises ``ValueError`` naming
  the fix (``--world_size 2`` in one process names the launch of 2
  processes, ``AVDN_NUM_PROCESSES=2`` without ``AVDN_COORDINATOR`` names
  it), and so does an unknown family.
"""

import dataclasses
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "avdn_tpu_torch")

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import avdn_tpu_torch
for m in pkgutil.walk_packages(avdn_tpu_torch.__path__, "avdn_tpu_torch."):
    importlib.import_module(m.name)
print(json.dumps(sorted(sys.modules)))
"""


def _forbidden(name):
    return (name in ("jax", "flax", "avdn_tpu")
            or name.startswith(("jax.", "flax.", "avdn_tpu.")))


def test_import_loads_no_jax_or_reference_package():
    import json

    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    modules = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("serve", "train.loop", "train.step", "train.optim",
                 "train.checkpoints", "utils.preemption", "rollout.fused",
                 "models.et_fast", "models.lstm", "data.annotations", "utils.logging",
                 "utils.seed", "viz", "cli.main", "cli.train_et", "cli.train_lstm",
                 "serve_http", "parallel.runtime", "parallel.collectives",
                 "parallel.batch"):
        assert "avdn_tpu_torch." + name in modules
    assert [m for m in modules if _forbidden(m)] == []


def test_sources_import_nothing_of_jax():
    pattern = re.compile(r"^\s*(?:from|import)\s+(jax|flax|avdn_tpu)(?:\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, "tools", name)
        for name in ("bench_serving_torch.py", "bn_conditioning_torch.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            assert not pattern.findall(f.read()), path


def _cpu_only():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")


def test_entry_points_without_card_raise(tmp_path):
    _cpu_only()
    from avdn_tpu_torch.config import Args, postprocess_args
    from avdn_tpu_torch.data.maps import DeviceMapBank
    from avdn_tpu_torch.cli.train_et import main as cli_main
    from avdn_tpu_torch.serve import Navigator
    from avdn_tpu_torch.train.loop import train, valid

    args = postprocess_args(Args(output_dir=str(tmp_path), render_twopass=False,
                                 bf16=False))
    with pytest.raises(RuntimeError, match="CUDA"):
        Navigator(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceMapBank(str(tmp_path), (64, 64))
    with pytest.raises(RuntimeError, match="CUDA"):
        valid(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        train(args, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main(["--output_dir", str(tmp_path), "--inference", "True",
                  "--render_twopass", "False", "--bf16", "False"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main(["--output_dir", str(tmp_path)])


def test_chip_smoke_fails_without_card_or_package(tmp_path):
    _cpu_only()
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd in (REPO, str(alone)):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0, cwd
        assert '"ok"' not in proc.stdout, cwd


UNSUPPORTED = {
    "multi_process": dict(world_size=2),
}

# case: (flags, device, what the eval config / dtype rule must then say)
SUPPORTED = {
    "bf16": (dict(bf16=True), "cpu", "bf16"),
    "bf16_unset_on_card": (dict(bf16=None), "cuda", "bf16"),
    "twopass_unset": (dict(render_twopass=None), "cpu", ("render_twopass", True)),
    "twopass": (dict(render_twopass=True), "cpu", ("render_twopass", True)),
    "subsample": (dict(render_subsample=2), "cpu", ("render_subsample", 2)),
    "int8": (dict(quant="int8"), "cpu", ("quant", "int8")),
    "decode_trunk": (dict(et_decode_trunk=True), "cpu", ("et_decode_trunk", True)),
    "lstm": (dict(family="lstm"), "cpu", ("student_stop", 0.25)),
}


def _mode_args(tmp_path, flags):
    from avdn_tpu_torch.config import Args, postprocess_args

    fields = dict(output_dir=str(tmp_path), render_twopass=False, bf16=False)
    fields.update(flags)
    return postprocess_args(Args(**fields))


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_flags_raise(case, tmp_path):
    """``--world_size 2`` passes the flag checks, and in one process the
    runtime refuses it, naming how to launch 2 processes (one per card);
    ``valid()`` and the ``Navigator`` refuse it before building a model."""
    from avdn_tpu_torch.parallel.runtime import setup_runtime
    from avdn_tpu_torch.serve import Navigator
    from avdn_tpu_torch.train.loop import (check_supported, eval_config_from_args,
                                           valid)
    from avdn_tpu_torch.train.step import check_rollout_supported

    args = _mode_args(tmp_path, UNSUPPORTED[case])
    check_supported(args, torch.device("cpu"))
    check_rollout_supported(eval_config_from_args(args))
    launch = "launch 2 processes with AVDN_NUM_PROCESSES=2"
    for call in (lambda: setup_runtime(args), lambda: valid(args, device="cpu"),
                 lambda: Navigator(args, device="cpu")):
        with pytest.raises(ValueError, match=launch):
            call()


@pytest.mark.parametrize("case", sorted(SUPPORTED))
def test_eval_mode_flags_supported(case, tmp_path):
    """Each eval mode's flags pass both checks and select the mode: bf16
    towers where requested or (unset) on the card, the two-pass render
    unless ``--render_twopass False``, the opt-in modes in the config (and
    in the rollout config where the rollout reads them; the int8 tower is
    chosen when the rollout is built); ``--family lstm`` its student stop
    threshold, 0.25 (and in the rollout config, its ``stop_threshold``)."""
    from avdn_tpu_torch.train.loop import (check_supported, eval_bf16,
                                           eval_config_from_args)
    from avdn_tpu_torch.train.step import check_rollout_supported

    flags, device, want = SUPPORTED[case]
    args = _mode_args(tmp_path, flags)
    device = torch.device(device)
    check_supported(args, device)
    cfg = eval_config_from_args(args)
    check_rollout_supported(cfg)
    if want == "bf16":
        assert eval_bf16(args, device)
    else:
        assert not eval_bf16(args, device)
        field, value = want
        assert getattr(cfg, field) == value
        roll = cfg.rollout_cfg(teacher=False)
        assert getattr(roll, field, value) == value
        if field == "student_stop":
            assert roll.stop_threshold == value


def test_unknown_family_raises_before_models(tmp_path):
    """``--family`` other than ``et`` or ``lstm`` is refused by
    ``check_supported`` (so by ``valid()``, ``train()`` and ``Navigator``
    before any model is built), by ``build_models`` and by
    ``load_reference_agent``, each with ``ValueError``."""
    from avdn_tpu_torch.compat.from_jax import load_reference_agent
    from avdn_tpu_torch.serve import Navigator
    from avdn_tpu_torch.train.loop import build_models, check_supported

    args = _mode_args(tmp_path, dict(family="gru"))
    cpu = torch.device("cpu")
    for call in (lambda: check_supported(args, cpu), lambda: build_models(args, cpu),
                 lambda: Navigator(args, device="cpu"),
                 lambda: load_reference_agent(str(tmp_path / "none.pt"), "gru")):
        with pytest.raises(ValueError, match="unknown family: gru"):
            call()


def test_fused_teacher_rollout_raises(tmp_path):
    """The fused teacher path runs in eval mode (the default for the HA
    eval) and in train mode (the teacher half of the train step), for both
    families; an unknown family raises ``ValueError`` in the rollout and in
    the rollout check, and a student config is refused."""
    from torch import nn

    from avdn_tpu_torch.config import Args, postprocess_args
    from avdn_tpu_torch.rollout.fused import rollout_teacher_fused
    from avdn_tpu_torch.train.loop import eval_config_from_args
    from avdn_tpu_torch.train.step import check_rollout_supported

    args = postprocess_args(Args(output_dir=str(tmp_path), render_twopass=False,
                                 bf16=False))
    cfg = eval_config_from_args(args)
    assert cfg.fused_teacher and cfg.fast_eval_trunk
    check_rollout_supported(cfg)
    check_rollout_supported(dataclasses.replace(cfg, family="lstm"))
    with pytest.raises(ValueError, match="choose 'et' or 'lstm'"):
        check_rollout_supported(dataclasses.replace(cfg, family="gru"))
    roll = cfg.rollout_cfg(teacher=True)
    assert roll.fused_teacher and roll.fast_eval_trunk
    dk, vln = nn.Linear(1, 1), nn.Linear(1, 1)
    train_roll = cfg.rollout_cfg(teacher=True, nss_w=0.0, train=True)
    assert train_roll.train and train_roll.fused_teacher
    for r in (roll, train_roll):
        kw = dict(map_bank=None, batch=None, cfg=r, generator=None)
        with pytest.raises(ValueError, match="unknown family: gru"):
            rollout_teacher_fused(family="gru", darknet_model=dk, vln_model=vln, **kw)
    with pytest.raises(ValueError, match="teacher forcing only"):
        rollout_teacher_fused(family="et", darknet_model=dk, vln_model=vln,
                              map_bank=None, batch=None, generator=None,
                              cfg=cfg.rollout_cfg(teacher=False, train=True))


def test_driver_rejects_what_it_cannot_run(tmp_path, monkeypatch):
    """The drivers raise for orbax checkpoints (naming the export tool), for
    ``AVDN_NUM_PROCESSES=2`` without the coordinator's address (naming
    ``AVDN_COORDINATOR``), and on a malformed ``--optim`` or
    ``--remat_policy``; ``--resume_file latest`` without a checkpoint is a
    missing file in ``valid()``. The production train recipe
    (``--preset production``: batch 16, ``--bf16 True`` training, the
    two-pass render in training, ``--remat`` dots) is accepted, with
    explicit flags over the preset's values."""
    from avdn_tpu_torch.cli.train_et import main as cli_main
    from avdn_tpu_torch.config import Args, parse_args, postprocess_args
    from avdn_tpu_torch.train.loop import (train_bf16, train_config_from_args,
                                           train_render_twopass, valid)
    from avdn_tpu_torch.train.step import check_train_supported

    base = ["--output_dir", str(tmp_path), "--render_twopass", "False",
            "--bf16", "False"]
    args = parse_args(["--output_dir", str(tmp_path), "--preset", "production"])
    cfg = train_config_from_args(args)
    check_train_supported(cfg)
    assert (args.batch_size, train_bf16(args), train_render_twopass(args), cfg.remat,
            cfg.remat_policy) == (16, True, True, True, "dots")
    assert cfg.rollout_cfg(teacher=False, train=True).remat
    assert not cfg.rollout_cfg(teacher=False).remat  # eval never rematerialises
    args = parse_args(["--output_dir", str(tmp_path), "--preset", "production",
                       "--batch_size", "32", "--remat", "False"])
    assert (args.batch_size, args.remat, train_bf16(args)) == (32, False, True)
    with pytest.raises(ValueError, match="remat_policy"):
        check_train_supported(train_config_from_args(postprocess_args(
            Args(output_dir=str(tmp_path), remat=True, remat_policy="some"))))
    with pytest.raises(ValueError, match="optim"):
        train_config_from_args(postprocess_args(Args(output_dir=str(tmp_path),
                                                     optim="rms")))
    args = postprocess_args(Args(output_dir=str(tmp_path), render_twopass=False,
                                 bf16=False, inference=True, resume_file="latest"))
    with pytest.raises(FileNotFoundError, match="latest_dict"):
        valid(args, device="cpu")
    args = postprocess_args(Args(output_dir=str(tmp_path), render_twopass=False,
                                 bf16=False, inference=True, resume_file=str(tmp_path)))
    with pytest.raises(NotImplementedError, match="export_torch_ckpt"):
        valid(args, device="cpu")
    monkeypatch.setenv("AVDN_NUM_PROCESSES", "2")
    monkeypatch.delenv("AVDN_COORDINATOR", raising=False)
    with pytest.raises(ValueError, match="AVDN_COORDINATOR"):
        cli_main(base + ["--inference", "True"], device="cpu")
    with pytest.raises(ValueError, match="AVDN_COORDINATOR"):
        cli_main(base, device="cpu")
