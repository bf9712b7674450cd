"""The port stands alone and never falls back quietly.

* Importing every module of ``avdn_tpu_torch`` loads no ``jax``, ``flax``
  or ``avdn_tpu`` module (checked in a fresh interpreter), and neither the
  package nor ``chip_smoke.py`` names one in an import.
* Without a card, an entry point given no ``device`` raises instead of
  running on the CPU, and ``chip_smoke.py`` exits non-zero without a result.
* Flags this slice cannot run raise ``NotImplementedError``.
"""

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
    assert "avdn_tpu_torch.serve" in modules
    assert [m for m in modules if _forbidden(m)] == []


def test_sources_import_nothing_of_jax():
    pattern = re.compile(r"^\s*(?:from|import)\s+(jax|flax|avdn_tpu)(?:\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
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
    from avdn_tpu_torch.serve import Navigator

    args = postprocess_args(Args(output_dir=str(tmp_path), render_twopass=False,
                                 bf16=False))
    with pytest.raises(RuntimeError, match="CUDA"):
        Navigator(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceMapBank(str(tmp_path), (64, 64))


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
    "bf16": dict(bf16=True),
    "bf16_unset_on_card": dict(bf16=None),
    "twopass_unset": dict(render_twopass=None),
    "twopass": dict(render_twopass=True),
    "subsample": dict(render_subsample=2),
    "int8": dict(quant="int8"),
    "decode_trunk": dict(et_decode_trunk=True),
    "lstm": dict(family="lstm"),
    "multi_process": dict(world_size=2),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_flags_raise(case, tmp_path):
    from avdn_tpu_torch.config import Args, postprocess_args
    from avdn_tpu_torch.train.loop import check_supported, eval_config_from_args
    from avdn_tpu_torch.train.step import check_rollout_supported

    fields = dict(output_dir=str(tmp_path), render_twopass=False, bf16=False)
    fields.update(UNSUPPORTED[case])
    args = postprocess_args(Args(**fields))
    device = torch.device("cuda" if case == "bf16_unset_on_card" else "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        check_supported(args, device)
        check_rollout_supported(eval_config_from_args(args), teacher=False)


def test_fused_teacher_rollout_raises(tmp_path):
    from avdn_tpu_torch.config import Args, postprocess_args
    from avdn_tpu_torch.train.loop import eval_config_from_args
    from avdn_tpu_torch.train.step import check_rollout_supported

    args = postprocess_args(Args(output_dir=str(tmp_path), render_twopass=False,
                                 bf16=False))
    cfg = eval_config_from_args(args)
    assert cfg.fused_teacher
    check_rollout_supported(cfg, teacher=False)  # the student rollout runs
    with pytest.raises(NotImplementedError, match="fused teacher"):
        check_rollout_supported(cfg, teacher=True)
