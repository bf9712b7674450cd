"""The HAA-LSTM family on the card against the CPU (``cuda`` marker; skips
without a card). It imports neither ``jax`` nor ``avdn_tpu``, so it also
collects on a card machine without flax.

At tiny width (BERT 2×64, a two-conv Darknet, ``HAALSTM`` at ``demb`` 64
with its 192/576 cells; every dropout rate 0, TF32 off), B = 2, T = 3, on
``chip_smoke.py``'s generated maps and items, from the same seeded weights
on both devices (``chip_smoke._tiny_setup``): the student nav eval launches
the saliency kernel T times on the card and agrees with the CPU's plain
versions (stop steps identical, actions within 1e-4), and one train step's
loss and the three groups' gradient norms agree within 1e-4 relative.
"""

import math

import pytest
import torch

pytestmark = pytest.mark.cuda


def test_lstm_rollout_and_train_step_match_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the saliency kernels have no CPU mode")
    import chip_smoke
    from avdn_tpu_torch.ops.saliency import saliency_stats

    root = str(tmp_path / "data")
    chip_smoke.write_dataset(root, chip_smoke.make_maps("cpu"), chip_smoke.make_items(),
                             chip_smoke.make_items(chip_smoke.SEED + 3, prefix="t"))
    flags = ["--family", "lstm"]
    work = str(tmp_path / "work")
    before = saliency_stats.launches
    card = chip_smoke._tiny_student_rollout(flags, "cuda", root, work)
    assert saliency_stats.launches - before == 3
    cpu = chip_smoke._tiny_student_rollout(flags, "cpu", root, work)
    assert torch.equal(card.alive_post, cpu.alive_post)
    assert chip_smoke._max_diff(card, cpu) <= 1e-4
    res = {d: chip_smoke._tiny_train_step("lstm", flags, d, root, work)
           for d in ("cuda", "cpu")}
    assert all(math.isfinite(v) for v in res["cuda"])
    assert chip_smoke._rel(res["cuda"], res["cpu"]) <= 1e-4
