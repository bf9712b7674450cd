"""The port's data generators against the JAX package's, on the CPU.

* ``avdn_tpu_torch.data.demo.write_demo_dataset`` writes, for the same
  arguments, the same annotation JSON (parsed, equal as objects) and the
  same ``.tif`` files (decoded pixels equal) as ``avdn_tpu.data.demo``, at
  the default and at other sizes and seeds; ``main`` (``python -m
  avdn_tpu_torch.data.demo --out DIR``) writes the default dataset.
* ``synthetic_world`` returns, for the same arguments, a map bank and an
  ``EpisodeBatch`` whose every field equals the JAX arrays (dtype kind and
  values), the episode metadata alike, the batch on the requested device.

Wall: ~3 s on one worker.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from avdn_tpu.data import demo as jax_demo
from avdn_tpu.data.synthetic import synthetic_world as jax_world

from avdn_tpu_torch.data import demo
from avdn_tpu_torch.data.synthetic import synthetic_world


def _dataset(root):
    """``{relative path: parsed JSON or decoded pixels}`` of a demo root."""
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            rel = os.path.relpath(path, root)
            if name.endswith(".json"):
                with open(path) as f:
                    out[rel] = json.load(f)
            else:
                out[rel] = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return out


@pytest.mark.parametrize("kwargs", [{}, dict(n_train=5, n_val=3, map_px=200, seed=3)],
                         ids=["default", "small_seed3"])
def test_demo_dataset_equals_jax(tmp_path, kwargs):
    got = _dataset(demo.write_demo_dataset(str(tmp_path / "port"), **kwargs))
    want = _dataset(jax_demo.write_demo_dataset(str(tmp_path / "jax"), **kwargs))
    assert sorted(got) == sorted(want)
    assert len([k for k in got if k.endswith(".tif")]) == 2
    for key in want:
        if key.endswith(".json"):
            assert got[key] == want[key], key
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_demo_main_writes_the_default_dataset(tmp_path, capsys):
    demo.main(["--out", str(tmp_path / "cli")])
    assert "demo dataset written" in capsys.readouterr().out
    got = _dataset(str(tmp_path / "cli"))
    want = _dataset(demo.write_demo_dataset(str(tmp_path / "direct")))
    assert sorted(got) == sorted(want)
    for key in want:
        if key.endswith(".json"):
            assert got[key] == want[key]
        else:
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("kwargs", [{}, dict(batch_size=3, n_maps=3, map_px=256, gt_steps=4,
                                          max_gt_len=6, max_circles=4, lang_len=8,
                                          lang_dim=64, seed=5)],
                         ids=["default", "small_seed5"])
def test_synthetic_world_equals_jax(kwargs):
    got = synthetic_world(device="cpu", **kwargs)
    want = jax_world(**kwargs)
    assert got.map_bank.dtype == np.uint8
    np.testing.assert_array_equal(got.map_bank, want.map_bank)
    for field in type(got.batch).__dataclass_fields__:
        g, w = getattr(got.batch, field), np.asarray(getattr(want.batch, field))
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu", field
        assert g.numpy().dtype.kind == w.dtype.kind, field
        np.testing.assert_array_equal(g.numpy(), w, err_msg=field)
    assert len(got.episodes_meta) == len(want.episodes_meta)
    for g, w in zip(got.episodes_meta, want.episodes_meta):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]))
