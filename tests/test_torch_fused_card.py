"""The time-fused teacher HA eval on the card (``cuda`` marker; skips
without a card). It imports neither ``jax`` nor ``avdn_tpu``, so it also
collects on a card machine without flax.

At full width (BERT-base, Darknet-53, trunk 2×768), B = 8, T = 10, random
weights from a seed, on ``chip_smoke.py``'s generated maps and items: the
fused HA eval launches the saliency kernel once per batch (N = T·B = 80)
where the step loop launches it T times, and the two agree (stops
identical; actions, corners, HA precision, recall and NSS within 1e-4).
"""

import dataclasses

import pytest
import torch

pytestmark = pytest.mark.cuda

B, T = 8, 10


def test_fused_ha_eval_matches_step_loop_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the saliency kernel has no CPU mode")
    import chip_smoke
    from avdn_tpu_torch.config import parse_args
    from avdn_tpu_torch.ops.saliency import saliency_stats
    from avdn_tpu_torch.serve import Navigator
    from avdn_tpu_torch.train.step import make_eval_rollout

    maps = chip_smoke.make_maps("cuda")
    items = [Navigator._normalize_item(it) for it in chip_smoke.make_items()[:B]]
    args = parse_args(["--output_dir", str(tmp_path), "--max_action_len", str(T),
                       "--batch_size", str(B), "--render_twopass", "False",
                       "--bf16", "False"])
    nav = Navigator(args, device="cuda",
                    map_loader=lambda it: maps[int(it["map_name"].rsplit("_", 1)[1])])
    bank, batch, _ = nav.prepare(items)
    outs = {}
    for fused, launches in ((True, 1), (False, T)):
        cfg = dataclasses.replace(nav.cfg, fused_teacher=fused)
        fn = make_eval_rollout(cfg, nav.bert, nav.darknet, nav.vln, teacher=True,
                               collect_ha=True)
        before = saliency_stats.launches
        out = fn(bank, batch, torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        assert saliency_stats.launches - before == launches
        outs[fused] = out.cpu()
    fused, step = outs[True], outs[False]
    assert fused.actions_wp.shape == (T, B, 2)
    for name in ("alive_pre", "alive_post", "ha_valid"):
        assert torch.equal(getattr(fused, name), getattr(step, name)), name
    m = step.ha_valid
    assert m.any()
    for name in ("actions_wp", "actions_alt", "pred_progress", "corners"):
        torch.testing.assert_close(getattr(fused, name), getattr(step, name),
                                   rtol=0, atol=1e-4, msg=name)
    for name in ("ha_precision", "ha_recall", "ha_nss"):
        torch.testing.assert_close(getattr(fused, name)[m], getattr(step, name)[m],
                                   rtol=0, atol=1e-4, msg=name)
