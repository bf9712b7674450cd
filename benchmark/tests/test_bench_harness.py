"""The benchmark harness on the CPU: cells found by name, the result line,
the refusal without a card, the import rule, the reference against the port
at tiny width, and every planted fault failing the comparison."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from harness import faults
from harness.cell import BENCH_DIR, ROOT, load_cell, metric_reader
from harness.runner import run_cell
from harness.trace import Trace
from bench_tiny import tiny_cell, tiny_context


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(obj if isinstance(obj, str) else json.dumps(obj))


def test_new_cell_config_and_metric_are_found_by_name(tmp_path):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "new_cfg.new_mix", "config": "new_cfg",
                              "traffic": "new_mix", "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "new.metric", "unit": "ms", "better": "lower",
                              "source": "program_span", "layer": "device",
                              "moves": "train_eps", "workloads": ["new_cfg.new_mix"]})
    spec["end_to_end"][0]["workloads"].append("new_cfg.new_mix")
    _write(str(tmp_path / "BENCHMARK.json"), spec)
    bench = tmp_path / "benchmark"
    _write(str(bench / "configs" / "new_cfg.json"), {"family": "et", "args": {"demb": 8}})
    _write(str(bench / "traffic" / "new_mix.json"), {"kind": "train", "args": {}})
    _write(str(bench / "limits" / "new_cfg.new_mix.json"), {"loss_gap": 1.0})
    _write(str(bench / "metrics" / "new.metric.py"), "def read(rec):\n    return 4.5\n")
    cell = load_cell("new_cfg.new_mix", root=str(tmp_path))
    assert cell.config["args"] == {"demb": 8} and cell.traffic["kind"] == "train"
    assert cell.limits == {"loss_gap": 1.0}
    assert [m["name"] for m in cell.per_layer] == ["new.metric"]
    assert {m["name"] for m in cell.end_to_end} == {"train_eps", "setup_s"}
    assert metric_reader("new.metric", bench=str(bench))({}) == 4.5


def test_every_shipped_cell_has_its_files():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for w in spec["workloads"]:
        cell = load_cell(w["name"])
        assert cell.per_layer and len(cell.end_to_end) >= 2
        for m in cell.per_layer:
            metric_reader(m["name"])({})  # finds nothing to read: None, no error


@pytest.mark.parametrize("config,traffic", [("et_haa", "train"), ("haa_lstm", "train"),
                                            ("et_haa", "valid"), ("haa_lstm", "valid"),
                                            ("et_haa", "serve")])
def test_reference_agrees_with_the_port_at_tiny_width(config, traffic, tmp_path):
    """The train step (loss, every leaf's first gradient and change), the
    student nav rollout, the fused HA eval and serving: the frozen reference
    and the port's plain CPU paths give the same numbers."""
    out = run_cell(tiny_context(tiny_cell(config, traffic, tmp_path), tmp_path))
    assert out["correct"], out["compared"]
    for name, (value, _limit) in out["compared"].items():
        assert value <= 1e-6, (name, value)


@pytest.mark.parametrize("config,traffic,fault", [
    ("et_haa", "train", "frozen"), ("et_haa", "train", "half"),
    ("et_haa", "train", "wrong_b2"), ("haa_lstm", "train", "frozen"),
    ("haa_lstm", "train", "half"), ("haa_lstm", "train", "wrong_b2"),
    ("et_haa", "valid", "altered"), ("et_haa", "serve", "altered")])
def test_a_planted_fault_fails_the_check(config, traffic, fault, tmp_path):
    ctx = tiny_context(tiny_cell(config, traffic, tmp_path), tmp_path)
    if traffic == "train":
        ctx.wrap_step = faults.TRAIN[fault]
    elif traffic == "valid":
        ctx.wrap_step = faults.altered_outputs
    else:
        ctx.wrap_step = faults.altered_rollout
    out = run_cell(ctx)
    assert not out["correct"], out["compared"]


class _Stub:
    """A driver that measures nothing: its record holds a made-up trace."""

    @staticmethod
    def run(ctx):
        if ctx.trace:
            ctx.record["trace"] = Trace(window_s=2.0, busy_s=0.5, launches=100, units=4,
                                        device_ops=[("k", 0.5)],
                                        idle_gaps=[("aten::mm", 1.5)], kernels={})
        ctx.record.update(units=4, window_s=2.0, batch_wait_s=0.1)
        return {"metrics": {"train_eps": 2.0, "setup_s": 1.0}, "attempted": 7,
                "compared": {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0,
                             "adam_gap": 0.0}}


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_has_the_contract_keys(trace, tmp_path, monkeypatch):
    import harness.runner as runner

    cell = load_cell("haa_lstm.train")
    monkeypatch.setattr(runner.importlib, "import_module", lambda name: _Stub)
    ctx = tiny_context(cell, tmp_path)
    ctx.trace = trace
    out = runner.run_cell(ctx)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[:5] == keys and list(out)[-1] == "compared"
    assert ("breakdown" in out) == trace and set(out) <= set(keys) | {"breakdown", "compared"}
    if trace:
        assert out["metrics"]["device_idle.train"] == {"value": 75.0, "unit": "%"}
        assert out["metrics"]["launches.train"]["value"] == 25.0
        assert out["device"]["busy_s"] == 0.5 and out["device"]["window_s"] == 2.0
    else:
        assert set(out["metrics"]) == {"train_eps", "setup_s"}
    json.dumps(out)


def test_a_measuring_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "haa_lstm.train",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    """By whole top-level name: ``avdn_tpu_torch`` is not ``avdn_tpu``; the
    reference imports nothing of the port either."""
    for dirpath, _, files in os.walk(BENCH_DIR):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            tops = set(_imports(path))
            assert not tops & {"jax", "jaxlib", "flax", "avdn_tpu"}, path
            if os.sep + "reference" + os.sep in path:
                assert "avdn_tpu_torch" not in tops, path


def test_the_module_check_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, BENCH_DIR)
    import run as entry

    monkeypatch.setitem(sys.modules, "avdn_tpu_torch_fake", object())
    assert "avdn_tpu" not in entry.forbidden_modules()
    monkeypatch.setitem(sys.modules, "avdn_tpu.models", object())
    assert entry.forbidden_modules() == ["avdn_tpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("config,traffic", [("et_haa", "train"), ("et_haa", "valid"),
                                            ("et_haa", "serve")])
def test_the_control_fails_on_the_card(config, traffic, tmp_path):
    """The control (TF32 in the reference's place; the int8 tower for the
    bf16 serving cell) fails a number the sound run passes, at tiny width on
    the card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, os.path.join(BENCH_DIR, "tools"))
    import calibrate

    cell = tiny_cell(config, traffic, tmp_path)
    sound = run_cell(tiny_context(cell, tmp_path / "a", seed=5, device="cuda"))
    assert sound["correct"], sound["compared"]
    ctx = tiny_context(cell, tmp_path / "b", seed=5, device="cuda")
    got = calibrate.control(ctx)
    assert any(v > cell.limits[k] for k, v in got.items()), got
