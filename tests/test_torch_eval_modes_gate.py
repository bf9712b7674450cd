"""The port's fast eval modes against its own exact mode, on the CPU at tiny
width: the ``GATE`` of ``tests/test_render_mode_goldens.py`` and the mode
line of ``valid.txt``.

The runs are those of ``test_torch_eval_modes.py`` (its docstring): the
JAX gate checkpoint validated by the port's CLI in every mode of ``MODES``,
each made once per test session and shared across the xdist workers
(``tests/torch_shared.py``). This file asks for the modes in the reverse of
that file's order, so two workers make them side by side.
"""

import pytest

from test_render_mode_goldens import GATE, MODES
from test_render_mode_goldens import test_fast_mode_matches_exact_metrics as _gate
from torch_shared import port_mode_run

FAST_MODES = [m for m in MODES if m != "exact"]


@pytest.mark.parametrize("mode", FAST_MODES[::-1])
def test_mode_passes_gate_against_port_exact(tmp_path_factory, mode):
    """The JAX package's gate (``GATE[mode]`` flips, continuous and
    saliency tolerances) between the port's fast and exact runs."""
    assert mode in GATE
    _gate({m: port_mode_run(tmp_path_factory, m)["metrics"] for m in ("exact", mode)},
          mode)


@pytest.mark.parametrize("mode", list(MODES)[::-1])
def test_valid_log_names_the_mode(tmp_path_factory, mode):
    """``valid.txt`` says which dtype, tower and render the run used."""
    over = MODES[mode]
    log = port_mode_run(tmp_path_factory, mode)["log"]
    line = next(l for l in log.splitlines() if l.startswith("device"))
    assert "towers " + ("bfloat16" if over.get("bf16") else "float32") in line
    assert ("int8 Darknet" if over.get("quant") == "int8" else "BN-folded Darknet") in line
    if over.get("render_twopass"):
        assert "two-pass render, crop 320 px" in line, line
    else:
        assert "exact render" in line
        assert ("subsample 2" in line) == (over.get("render_subsample") == 2)
