"""The port's shipped entry points and its memory census, on the CPU.

* ``tools/repro_valid_torch.py`` exits 0 with SKIPPED and names every
  missing asset on an empty root (the script and the tool, in fresh
  interpreters); its ``find_assets`` finds a release layout.
* A dress rehearsal of the asset-day path at CI width: release-layout assets
  written from the port's demo generator (annotations and ``.tif`` tiles,
  the tiny Darknet cfg as ``yolo_v3.cfg``, a ``vocab.txt`` of the special
  tokens and the demo dialogs' words) and a ``best_val_unseen`` written by
  the JAX package's ``export_reference_agent`` from JAX parameters, with
  what a released file carries besides (the reference ET's dead modules, a
  torch AdamW state per entry, HF BERT's ``position_ids``). The tool reaches
  its table (every BASELINE metric of both splits, finite, exit 1 with the
  DIFF lines on random weights), and the weights it loads equal
  ``avdn_tpu.train.checkpoints.import_reference_agent``'s, carried across by
  ``compat/from_jax.py``; ``train/checkpoints.py:load_checkpoint`` loads the
  same file.
* ``tools/visualize_sub_traj_torch.py`` draws the same pixels as
  ``tools/visualize_sub_traj.py`` and writes one JPG per item.
* The ``_torch`` scripts carry the JAX scripts' flags, flag for flag, call
  the port and append the caller's arguments.
* ``utils/debug.py``'s census on the CPU: groups by dtype and shape, a
  storage shared by views counted once, sorted by bytes.

Wall: ~25 s on one worker (the rehearsal's JAX init and CPU validation).
"""

import importlib.util
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_e2e_loop import TINY_DARKNET_CFG, make_args  # noqa: E402


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_repro_valid_skips_cleanly(tmp_path):
    for argv in (["bash", os.path.join("scripts", "repro_valid_torch.sh"), str(tmp_path)],
                 [sys.executable, os.path.join("tools", "repro_valid_torch.py"),
                  "--root_dir", str(tmp_path)]):
        out = subprocess.run(argv, capture_output=True, text=True, cwd=REPO, timeout=120,
                             env=dict(os.environ, PATH=os.path.dirname(sys.executable)
                                      + os.pathsep + os.environ.get("PATH", "")))
        assert out.returncode == 0, out.stderr
        assert "SKIPPED" in out.stdout
        for asset in ("yolo_v3.cfg", "best_val_unseen", "vocab.txt", "GeoTIFF", "annotations"):
            assert asset in out.stdout, (asset, argv)
        assert "jax" not in out.stderr.lower()


def test_find_assets_detects_presence(tmp_path):
    repro = _tool("repro_valid_torch")
    avdn = tmp_path / "AVDN"
    for d in ("annotations", "pretrain_weights", "train_images"):
        (avdn / d).mkdir(parents=True)
    for f in ("annotations/val_seen_data.json", "annotations/val_unseen_data.json",
              "pretrain_weights/yolo_v3.cfg", "pretrain_weights/vocab.txt",
              "pretrain_weights/best_val_unseen", "train_images/map1.tif"):
        (avdn / f).write_text("x")
    need, missing, ckpt = repro.find_assets(str(tmp_path), None)
    assert not missing and ckpt.endswith("best_val_unseen")
    os.remove(avdn / "train_images" / "map1.tif")
    assert list(repro.find_assets(str(tmp_path), None)[1]) == ["xView GeoTIFF tiles"]


def _release_assets(root):
    """Release-layout assets from the port's demo generator; returns the
    pretrain_weights directory."""
    from avdn_tpu_torch.data.demo import write_demo_dataset
    from avdn_tpu_torch.data.tokenizer import CLS, MASK, PAD, SEP, UNK, basic_tokenize

    write_demo_dataset(root, n_train=2, n_val=4)
    pw = os.path.join(root, "AVDN", "pretrain_weights")
    os.makedirs(pw)
    with open(os.path.join(pw, "yolo_v3.cfg"), "w") as f:
        f.write(TINY_DARKNET_CFG)
    words = set()
    for split in ("val_seen", "val_unseen"):
        with open(os.path.join(root, "AVDN", "annotations", f"{split}_data.json")) as f:
            for item in json.load(f):
                for text in item["pre_dialogs"] + [item["instructions"]]:
                    words.update(basic_tokenize(text))
    with open(os.path.join(pw, "vocab.txt"), "w") as f:
        f.write("\n".join([PAD, UNK, CLS, SEP, MASK] + sorted(words)) + "\n")
    return pw


def _released_checkpoint(path, args):
    """``export_reference_agent`` of a JAX init, plus what a released file
    carries besides; returns JAX's import of the file."""
    import jax

    from avdn_tpu.compat.torch_export import export_reference_agent
    from avdn_tpu.train.checkpoints import import_reference_agent
    from avdn_tpu.train.loop import build_models, init_state, train_config_from_args

    bert, darknet, vln = build_models(args)
    state = init_state(args, bert, darknet, vln, train_config_from_args(args),
                       jax.random.PRNGKey(0))
    blocks = darknet.cfg.block_dicts()
    export_reference_agent(path, "et", blocks, {"params": state.bert_params},
                           {"params": state.darknet_params, "batch_stats": state.batch_stats},
                           {"params": state.vln_params}, epoch=4,
                           bert_layers=args.bert_layers, et_layers=args.encoder_layers)
    blob = torch.load(path, weights_only=False)
    g = torch.Generator().manual_seed(0)
    vln_sd = blob["vln_model"]["state_dict"]
    vln_sd["dec_action.weight"] = torch.randn(args.demb, args.demb, generator=g)
    vln_sd["dec_action.bias"] = torch.randn(args.demb, generator=g)
    vln_sd["attention_layer_vision.c.0.weight"] = torch.randn(256, 768, generator=g)
    blob["lang_model"]["state_dict"]["bert.embeddings.position_ids"] = torch.arange(512)[None]
    for entry in blob.values():
        params = [torch.nn.Parameter(v.float().clone()) for v in entry["state_dict"].values()
                  if v.is_floating_point()]
        opt = torch.optim.AdamW(params, lr=1e-5)
        sum(p.sum() for p in params).backward()
        opt.step()
        entry["optimizer"] = opt.state_dict()
    torch.save(blob, path)
    return import_reference_agent(path, "et", blocks, bert_layers=args.bert_layers,
                                  et_layers=args.encoder_layers), blocks


def test_repro_valid_dress_rehearsal(tmp_path, capsys, monkeypatch):
    from avdn_tpu_torch.compat import from_jax
    from avdn_tpu_torch.train import loop

    root = str(tmp_path / "release")
    pw = _release_assets(root)
    ckpt = os.path.join(pw, "best_val_unseen")
    args = make_args(root, str(tmp_path / "jax"), os.path.join(pw, "yolo_v3.cfg"))
    (bert_v, dk_v, vln_v, epoch), blocks = _released_checkpoint(ckpt, args)
    assert epoch == 4

    loaded = []
    real = loop.load_agent_weights

    def capture(models, state_dicts):
        real(models, state_dicts)
        loaded.append(models)

    monkeypatch.setattr(loop, "load_agent_weights", capture)
    repro = _tool("repro_valid_torch")
    rc = repro.main(["--root_dir", root, "--output_dir", str(tmp_path / "out"),
                     "--batch_size", "2", "--max_action_len", "2", "--demb", "64",
                     "--bert_layers", "2", "--encoder_heads", "4", "--encoder_layers", "1",
                     "--max_instr_len", "32", "--dialog_pad", "64", "--map_bank_px", "256",
                     "--map_bank_slots", "3"], device="cpu")
    out = capsys.readouterr().out
    assert "SKIPPED" not in out and rc == 1 and "outside tolerance" in out
    rows = {}
    for line in out.splitlines():
        m = re.match(r"^(val_seen|val_unseen)\s+(\w+)\s+(\S+)\s+(\S+)\s+(ok|DIFF)$", line)
        if m:
            rows[m.group(1), m.group(2)] = float(m.group(4))
    want = {(env, m) for env, exp in repro.EXPECTED.items() for m in exp}
    assert set(rows) == want
    assert all(math.isfinite(v) for v in rows.values()), rows

    (bert, darknet, vln), = loaded
    expected = (from_jax.bert_state_dict(bert_v, args.bert_layers),
                from_jax.darknet_state_dict(dk_v, blocks),
                from_jax.et_state_dict(vln_v, args.encoder_layers))
    for model, sd in zip((bert, darknet, vln), expected):
        got = model.state_dict()
        assert sorted(got) == sorted(sd)
        for k, v in sd.items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)

    # the train resume's loader takes the released layout too (weights only)
    from avdn_tpu_torch.config import Args, postprocess_args
    from avdn_tpu_torch.train.checkpoints import load_checkpoint

    class State:
        family = "et"

        def __init__(self, models):
            self._models, self.step = models, None

        def models(self):
            return self._models

    port_args = postprocess_args(Args(output_dir=str(tmp_path / "p"), demb=64, encoder_heads=4,
                                      encoder_layers=1, bert_layers=2,
                                      darknet_model_file=os.path.join(pw, "yolo_v3.cfg")))
    state = State(loop.build_models(port_args, torch.device("cpu")))
    assert load_checkpoint(ckpt, state, optimizer=False) == 4
    for model, sd in zip(state.models(), expected):
        for k, v in sd.items():
            np.testing.assert_array_equal(model.state_dict()[k].numpy(), np.asarray(v))


def test_viewer_draws_the_jax_tools_pixels(tmp_path):
    from avdn_tpu_torch.data.annotations import load_annotations
    from avdn_tpu_torch.data.demo import write_demo_dataset
    from avdn_tpu_torch.data.maps import load_map_image

    root = write_demo_dataset(str(tmp_path / "demo"), n_train=4, n_val=2)
    anno = os.path.join(root, "AVDN", "annotations")
    tiles = os.path.join(root, "AVDN", "train_images")
    port, jax_tool = _tool("visualize_sub_traj_torch"), _tool("visualize_sub_traj")
    for item in load_annotations(anno, ["train"]):
        tile = load_map_image(os.path.join(tiles, item["map_name"] + ".tif"),
                              item["lng_ratio"], item["lat_ratio"])
        got, want = port.draw_item(item, tile), jax_tool.draw_item(item, tile)
        assert not np.array_equal(got, tile[:, :, ::-1])
        np.testing.assert_array_equal(got, want)
    out = tmp_path / "viz"
    port.main(["--anno_dir", anno, "--dataset_dir", tiles, "--split", "train",
               "--out_dir", str(out), "--limit", "3"])
    assert len([n for n in os.listdir(out) if n.endswith(".jpg")]) == 3


def _flags(path):
    with open(os.path.join(REPO, "scripts", path)) as f:
        text = f.read()
    flag = re.search(r'flag="(.*?)"', text, re.S).group(1).split()
    return text, list(zip(flag[::2], flag[1::2]))


@pytest.mark.parametrize("family", ["et", "lstm"])
def test_torch_scripts_carry_the_jax_flags(family):
    text, flags = _flags(f"run_{family}_haa_torch.sh")
    jax_text, jax_flags = _flags(f"run_{family}_haa.sh")
    assert flags == jax_flags and len(flags) == 16
    cmd = [line for line in text.splitlines() if line.startswith("python ")]
    jax_cmd = [line for line in jax_text.splitlines() if line.startswith("python ")]
    assert cmd == [jax_cmd[0].replace("-m avdn_tpu.cli.", "-m avdn_tpu_torch.cli.")
                   + ' "$@"']
    with open(os.path.join(REPO, "scripts", "repro_valid_torch.sh")) as f:
        assert "tools/repro_valid_torch.py" in f.read()


def test_memory_census_on_cpu():
    from avdn_tpu_torch.utils.debug import device_memory_census, format_memory_census

    big = torch.zeros(1000, 257, dtype=torch.float64)
    views = [big[:10], big[:, :100], big[5]]  # noqa: F841 (kept alive)
    small = [torch.ones(3, 7, dtype=torch.int16) for _ in range(4)]  # noqa: F841
    rows = device_memory_census(10 ** 6, "cpu")
    assert rows == sorted(rows, key=lambda r: -r[2])
    by_key = {k: (n, b) for k, n, b in rows}
    assert by_key["float64[1000, 257]"] == (1, big.nbytes)  # the views add nothing
    assert "float64[1000, 100]" not in by_key and "float64[10, 257]" not in by_key
    n, b = by_key["int16[3, 7]"]
    assert n >= 4 and b == n * 42
    text = format_memory_census(3, "cpu")
    lines = text.splitlines()
    assert len(lines) == min(3, len(rows)) + 1
    assert lines[-1].endswith("total live tensors on cpu")
    assert float(lines[-1].split()[0]) * 1e6 >= big.nbytes
