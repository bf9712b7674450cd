"""The teacher oracle's kernel on the card (``cuda`` marker; skips without a
card). It imports neither ``jax`` nor ``avdn_tpu``, so it also collects on a
card machine without flax.

``teacher_action_batch`` on CUDA tensors (one launch of
``csrc/teacher_oracle.cu``) against ``teacher_action_batch_plain`` on the
same tensors: every output bit-equal (NaN to NaN), in both feedback modes,
at B = 1, 4, 16 and 40 and max_gt_len 1 (student mode: under teacher
forcing both raise), 12 and 49, over more than 100,000 items of
``chip_smoke.oracle_inputs`` (views near the path, at the goal, anywhere,
degenerate, a few centimetres wide, far away), then with every item ended
and with every path one step long. One launch a call; inputs the kernel
does not take raise.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

KEYS = ("waypoint_ratio", "altitude", "progress")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the oracle kernel has no CPU mode")
    from avdn_tpu_torch.sim.oracle import teacher_action_batch, teacher_action_batch_plain

    return teacher_action_batch, teacher_action_batch_plain


def _assert_same(got, want, args, where):
    for k in KEYS:
        a, b = got[k], want[k]
        same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
        if a.dim() > 1:
            same = same.all(dim=1)
        if not bool(same.all()):
            bad = (~same).nonzero()[:, 0]
            i = int(bad[0])
            raise AssertionError(
                f"{where}: {k} differs in {bad.numel()} of {same.numel()} items; item "
                f"{i}: kernel {a[i].tolist()} plain {b[i].tolist()}; corners "
                f"{args[0][i].tolist()} ended {bool(args[1][i])} gt_len "
                f"{int(args[3][i])} goal {args[2][i, max(int(args[3][i]) - 1, 0)].tolist()}")


def _compare(card, args, tf, where):
    kernel, plain = card
    before = kernel.launches
    got = kernel(*args, tf)
    assert kernel.launches - before == 1
    want = plain(*args, tf)
    torch.cuda.synchronize()
    _assert_same(got, want, args, where)
    return want


@pytest.mark.parametrize("max_t", [1, 12, 49])
@pytest.mark.parametrize("tf", [True, False])
def test_kernel_bit_equal_to_plain(card, tf, max_t):
    import chip_smoke

    if tf and max_t == 1:
        args = chip_smoke.oracle_inputs(4, 1, 0, "cuda")
        with pytest.raises(ValueError):
            card[0](*args, True)
        with pytest.raises((RuntimeError, IndexError)):
            card[1](*args, True)
        return
    n_items, progress = 0, []
    for B, calls in ((1, 40), (4, 20), (16, 10), (40, 10), (8192, 3)):
        for seed in range(calls):
            args = chip_smoke.oracle_inputs(B, max_t, 1000 * B + seed, "cuda")
            want = _compare(card, args, tf, f"B={B} max_gt_len={max_t} tf={tf} seed={seed}")
            progress.append(want["progress"])
            n_items += B
    p = torch.cat(progress)
    # the cases the inputs are made to reach: at the goal, no overlap, between
    assert (p > 0.5).any() and (p == 0).any() and ((p > 0) & (p < 0.5)).any()
    assert n_items > 25_000  # > 100,000 over the five cases that run


@pytest.mark.parametrize("tf", [True, False])
def test_kernel_all_ended_and_one_step_paths(card, tf):
    import chip_smoke

    corners, ended, gt, gt_len = chip_smoke.oracle_inputs(64, 12, 7, "cuda")
    want = _compare(card, (corners, torch.ones_like(ended), gt, gt_len), tf, "all ended")
    assert bool((want["waypoint_ratio"] == 0).all())
    one = torch.ones_like(gt_len)
    _compare(card, (corners, ended, gt, one), tf, "gt_len 1")


def test_kernel_refuses_what_it_does_not_take(card):
    import chip_smoke

    kernel = card[0]
    corners, ended, gt, gt_len = chip_smoke.oracle_inputs(8, 12, 11, "cuda")
    strided = corners.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    bad = [(strided, ended, gt, gt_len), (corners.double(), ended, gt, gt_len),
           (corners, ended.float(), gt, gt_len), (corners, ended, gt[:, ::2], gt_len),
           (corners, ended, gt, gt_len.int()), (corners.cpu(), ended, gt, gt_len),
           (corners[:4], ended, gt, gt_len)]
    before = kernel.launches
    for args in bad:
        with pytest.raises(ValueError):
            kernel(*args, True)
    assert kernel.launches == before
