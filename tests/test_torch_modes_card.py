"""The eval modes on the card (``cuda`` marker; skips without a card). It
imports neither ``jax`` nor ``avdn_tpu``, so it also collects on a card
machine without flax.

At full width (BERT-base, Darknet-53, trunk 2×768), B = 8, T = 10, random
weights from a seed, on ``chip_smoke.py``'s generated maps and items:

* an unset ``--bf16`` builds bf16 towers on the card, and the defaults
  render with the two-pass warp and bf16 weights (no quiet fp32 fallback);
* the two-pass render with float32 weights on the card equals the CPU's
  within 1e-3 on the 0–255 scale at B = 2, saliency identical;
* the bf16-weight two-pass views stay within the JAX package's bounds of
  the float32 ones (mean < 1.0, p99 < 6.0 on the 0–255 scale);
* the saliency kernel refuses a bf16 map (the rollouts cast it first);
* the fp32 decode trunk equals the full re-encode (stops identical,
  actions within 1e-4);
* the int8 tower on the card equals the CPU's within 1e-4: its int8
  weights and scales are bit-equal, and on ``chip_smoke.py``'s views every
  convolution's integer sums stay exact in float32 on both devices, so
  the summation order does not show. The bound is far below what quantisation moves the
  output (the card's output must differ from the float32 tower's by more
  than 1e-2 on average), so a card path that lost its quantisation fails.
"""

import dataclasses

import pytest
import torch

pytestmark = pytest.mark.cuda

B, T = 8, 10
CROP = 1024  # auto_render_crop at chip_smoke.py's 5e-6 deg/px


def _navigator(tmp_path, *flags):
    import chip_smoke
    from avdn_tpu_torch.config import parse_args
    from avdn_tpu_torch.serve import Navigator

    maps = chip_smoke.make_maps("cuda")
    args = parse_args(["--output_dir", str(tmp_path), "--max_action_len", str(T),
                       "--batch_size", str(B), *flags])
    return Navigator(args, device="cuda",
                     map_loader=lambda it: maps[int(it["map_name"].rsplit("_", 1)[1])])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    import chip_smoke
    from avdn_tpu_torch.serve import Navigator

    items = [Navigator._normalize_item(it) for it in chip_smoke.make_items()[:B]]
    exact = _navigator(tmp_path_factory.mktemp("exact"), "--render_twopass", "False",
                       "--bf16", "False")
    defaults = _navigator(tmp_path_factory.mktemp("defaults"), "--render_crop", str(CROP))
    return exact, defaults, items


def _render_inputs(nav, items, n):
    from avdn_tpu_torch.rollout.engine import _corners_to_img

    bank, batch, _ = nav.prepare(items)
    ep = batch.episode
    quad = _corners_to_img(ep.start_corners, ep.extent, ep.lat_ratio)
    return bank, [t[:n] for t in (ep.map_idx, quad, ep.circles, ep.n_circles)]


def test_unset_flags_run_bf16_twopass_on_card(setup):
    _, nav, _ = setup
    assert [m.dtype for m in (nav.bert, nav.darknet, nav.vln)] == [torch.bfloat16] * 3
    assert all(p.dtype == torch.float32 for m in (nav.bert, nav.darknet, nav.vln)
               for p in m.parameters())
    assert nav.cfg.render_twopass and nav.cfg.render_bf16 and nav.cfg.fold_bn_eval
    assert nav.cfg.render_crop == CROP


def test_twopass_fp32_card_matches_cpu(setup):
    from avdn_tpu_torch.sim.warp2pass import render_batch_twopass

    _, nav, items = setup
    bank, inputs = _render_inputs(nav, items, 2)
    card_v, card_s = render_batch_twopass(bank, *inputs, crop_hw=CROP, bf16=False)
    cpu_v, cpu_s = render_batch_twopass(bank.cpu(), *(t.cpu() for t in inputs),
                                        crop_hw=CROP, bf16=False)
    torch.testing.assert_close(card_v.cpu(), cpu_v, rtol=0, atol=1e-3)
    assert torch.equal(card_s.cpu(), cpu_s)


def test_twopass_bf16_weights_within_jax_bounds(setup):
    from avdn_tpu_torch.sim.warp2pass import render_batch_twopass

    _, nav, items = setup
    bank, inputs = _render_inputs(nav, items, B)
    v16, s16 = render_batch_twopass(bank, *inputs, crop_hw=CROP, bf16=True)
    v32, s32 = render_batch_twopass(bank, *inputs, crop_hw=CROP, bf16=False)
    d = (v16 - v32).abs().flatten()
    assert d.mean().item() < 1.0
    assert torch.quantile(d[::7], 0.99).item() < 6.0
    assert torch.equal(s16, s32)


def test_saliency_kernel_refuses_bf16(setup):
    from avdn_tpu_torch.ops.saliency import saliency_reductions

    pred = torch.rand((B, 224, 224), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        saliency_reductions(pred, pred.float())


def test_decode_trunk_matches_full_reencode_on_card(setup):
    from avdn_tpu_torch.ops.saliency import saliency_stats
    from avdn_tpu_torch.train.step import make_eval_rollout

    nav, _, items = setup
    bank, batch, _ = nav.prepare(items)
    outs = {}
    for decode in (False, True):
        fn = make_eval_rollout(dataclasses.replace(nav.cfg, et_decode_trunk=decode),
                               nav.bert, nav.darknet, nav.vln, teacher=False,
                               compute_losses=True)
        before = saliency_stats.launches
        outs[decode] = fn(bank, batch, torch.Generator("cuda").manual_seed(0)).cpu()
        assert saliency_stats.launches - before == T
    assert torch.equal(outs[True].alive_post, outs[False].alive_post)
    for name in ("actions_wp", "actions_alt", "pred_progress", "corners"):
        torch.testing.assert_close(getattr(outs[True], name), getattr(outs[False], name),
                                   rtol=0, atol=1e-4, msg=name)


def test_int8_tower_card_vs_cpu(setup):
    from avdn_tpu_torch.models.darknet import Darknet, fold_darknet_params
    import torch.nn.functional as F

    from avdn_tpu_torch.models.darknet_quant import (
        _quant_act,
        quant_forward,
        quantize_darknet_params,
    )
    from avdn_tpu_torch.rollout.engine import RGB_MEAN, RGB_STD
    from avdn_tpu_torch.sim.warp2pass import render_batch_twopass

    _, nav, items = setup
    bank, inputs = _render_inputs(nav, items, 2)
    views, _ = render_batch_twopass(bank, *inputs, crop_hw=CROP)
    x = views - torch.tensor(RGB_MEAN, device="cuda")
    cfg = nav.darknet.cfg
    folded = fold_darknet_params(cfg, nav.darknet.state_dict(), input_std=RGB_STD)
    q = quantize_darknet_params(cfg, folded)
    q_cpu = quantize_darknet_params(cfg, {k: v.cpu() for k, v in folded.items()})
    for i, p in q_cpu.items():
        for k, v in p.items():
            assert torch.equal(q[i][k].cpu(), v), (i, k)
    fp32 = Darknet(cfg, folded=True).eval()
    fp32.load_state_dict({k: v.cpu() for k, v in folded.items()})
    with torch.inference_mode():
        # conv 0's integer sums on the card are the exact (float64) ones
        b0 = cfg.block_dicts()[1]
        stride, pad = int(b0["stride"]), (int(b0["size"]) - 1) // 2 * int(b0["pad"])
        xq, _ = _quant_act(x.permute(0, 3, 1, 2))
        acc = F.conv2d(xq, q[0]["weight_q"].float(), None, stride, pad).cpu().double()
        exact = F.conv2d(xq.cpu().double(), q_cpu[0]["weight_q"].double(), None, stride, pad)
        print(f"int8 conv 0: card vs exact sums max {(acc - exact).abs().max().item()}, "
              f"max |sum| {exact.abs().max().item()}")
        assert torch.equal(acc, exact)
        card = quant_forward(cfg, q, x).cpu()
        cpu = quant_forward(cfg, q_cpu, x.cpu())
        ref = fp32(x.cpu())
    assert torch.isfinite(card).all()
    err = (card - cpu).abs()
    quant_err = (card - ref).abs()
    print(f"int8 tower card vs CPU: max {err.max().item()}, mean {err.mean().item()}; "
          f"int8 on the card vs fp32 on the CPU: max {quant_err.max().item()}, mean "
          f"{quant_err.mean().item()}; output mean |x| {ref.abs().mean().item()}")
    torch.testing.assert_close(card, cpu, rtol=0, atol=1e-4)
    assert quant_err.mean() > 1e-2
