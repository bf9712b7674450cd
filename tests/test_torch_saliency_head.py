"""The gradient of −NSS down to the (N, 8, 8) saliency head, on the CPU
against the JAX package and on the card against its plain version.

``ops.saliency.saliency_head_reductions`` spans the saliency upsample and the
reductions; training differentiates its −NSS in the head. Its plain
gradient, ``saliency_head_grad_plain`` (the upsampled prediction, dL/dp,
then the transpose of the upsample's two contractions, in the head's
dtype), is held here at N = 4 and 224 px, for float32 and bfloat16 heads
and every ``nss_r``, through the loss's ``where(valid, −NSS, 0)`` with
random item weights, against

* ``jax.grad`` in the head of ``avdn_tpu.models.layers.saliency_upsample``
  followed by ``saliency_reductions(..., use_pallas=False)`` (the JAX
  package's train path), and
* autograd of the port's own chain, the upsample and
  ``saliency_reductions_plain`` (what the op runs on the CPU).

Tolerance: max abs error over max |grad| within 1e-5 in float32 (sums
taken in another order, and ``F.interpolate``'s weights against
``jax.image.resize``'s to an ulp) and 1e-2 in bfloat16 (another order
inside a bfloat16-rounded contraction flips single bfloat16 ulps). Item 1
has a constant head (a constant map, std = 0): XLA's autodiff gives NaN
there (0·∞ through the square root's derivative) and the port exactly 0.
Item 2 has no fixation (Σg = 0): 0 on every side.

The kernel (``csrc/saliency_head_grad.cu``) has no CPU mode: the ``cuda``
tests below hold it against the plain version on the card (so does
``chip_smoke.py`` phase ``grad_kernel``), with its launch counts and
bitwise repeatability.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avdn_tpu.ops.saliency_pallas import saliency_reductions as jax_reductions
from avdn_tpu_torch.ops.saliency import (
    _head_grad_launch,
    resize_weights,
    saliency_fused,
    saliency_head_grad,
    saliency_head_grad_plain,
    saliency_head_reductions,
    saliency_nss_grad_plain,
    saliency_reductions,
    saliency_reductions_plain,
    saliency_stats,
    saliency_upsample,
)

N_ITEMS = 4
HW = 224
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
#: bfloat16 on the card: the largest share of the gradient's elements that
#: may differ from the plain version's. Another summation order flips single
#: bfloat16 ulps of a few elements in a thousand; a kernel that dropped a
#: bfloat16 rounding point (of dL/dp or of d_rows) would change far more
#: (test_flip_share_sees_a_dropped_rounding), yet stay within TOL
BF16_FLIP_SHARE = 0.01
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(n, seed):
    """Seeded heads (n, 8, 8), GT maps (n, 224, 224) and item weights, as
    numpy float32: item 1 a constant head, item 2 an empty ground truth."""
    rng = np.random.default_rng(seed)
    x8 = rng.normal(0.3, 0.4, (n, 8, 8)).astype(np.float32)
    gt = (rng.uniform(0, 1, (n, HW, HW)) > 0.85).astype(np.float32)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    x8[1] = 0.25
    gt[2] = 0.0
    return x8, gt, w


@pytest.fixture(scope="module")
def inputs():
    return _inputs(N_ITEMS, 0)


def _close(got, want, dtype, ok):
    """Within TOL of the largest gradient on the items ``ok``; exactly 0 on
    the others (std = 0, Σg = 0)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want[ok]).max()
    assert scale > 0
    err = np.abs(got[ok] - want[ok]).max() / scale
    assert err <= TOL[dtype], f"max abs err / max |grad| {err}"
    rest = [i for i in range(len(got)) if i not in ok]
    assert (got[rest] == 0).all()


def _port_chain_grad(x8, gt, w, dtype, nss_r):
    """Autograd of the port's chain on the CPU, and the op's valid flags."""
    x = torch.from_numpy(x8).to(DTYPES[dtype][0]).requires_grad_(True)
    pred = saliency_upsample(x, HW).float()
    neg, valid, _, _ = saliency_reductions_plain(pred, torch.from_numpy(gt), nss_r)
    (torch.from_numpy(w) * torch.where(valid, neg, 0.0)).sum().backward()
    return x.grad, valid


@pytest.mark.parametrize("nss_r", [0, 1, -1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_head_grad_matches_jax(inputs, dtype, nss_r):
    # needs flax: imported here so that the card tests collect without it
    from avdn_tpu.models import layers as jax_layers

    x8, gt, w = inputs
    jdtype = DTYPES[dtype][1]

    def loss(x):
        pred = jax_layers.saliency_upsample(x, HW).astype(jnp.float32)
        neg, valid, _, _ = jax_reductions(pred, jnp.asarray(gt), nss_r=nss_r,
                                          use_pallas=False)
        return jnp.sum(jnp.asarray(w) * jnp.where(valid, neg, 0.0))

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(x8, jdtype)).astype(jnp.float32))
    _, valid = _port_chain_grad(x8, gt, w, dtype, nss_r)
    assert valid.tolist() == [True, False, False, True]
    got = saliency_head_grad_plain(torch.from_numpy(x8).to(DTYPES[dtype][0]),
                                   torch.from_numpy(gt), torch.from_numpy(w) * valid,
                                   nss_r)
    assert got.dtype == DTYPES[dtype][0] and got.shape == (N_ITEMS, 8, 8)
    assert np.isnan(want[1]).all()  # XLA's 0·∞ where std = 0
    _close(got.float().numpy(), want, dtype, ok=[0, 3])


@pytest.mark.parametrize("nss_r", [0, 1, -1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_head_grad_matches_autograd_chain(inputs, dtype, nss_r):
    x8, gt, w = inputs
    want, valid = _port_chain_grad(x8, gt, w, dtype, nss_r)
    got = saliency_head_grad_plain(torch.from_numpy(x8).to(DTYPES[dtype][0]),
                                   torch.from_numpy(gt), torch.from_numpy(w) * valid,
                                   nss_r)
    assert got.dtype == want.dtype
    _close(got.float().numpy(), want.float().numpy(), dtype, ok=[0, 3])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_takes_the_plain_chain_on_cpu(inputs, dtype):
    """On CPU tensors the op is the upsample and the plain reductions, its
    gradient autograd through them, bit for bit, and no kernel launches."""
    x8, gt, w = inputs
    x = torch.from_numpy(x8).to(DTYPES[dtype][0]).requires_grad_(True)
    g = torch.from_numpy(gt)
    fwd, bwd = saliency_stats.launches, saliency_head_grad.launches
    pred, neg, valid, prec, rec = saliency_head_reductions(x, g, 1)
    assert not any(t.requires_grad for t in (pred, valid, prec, rec))
    want_pred = saliency_upsample(x.detach(), HW).float()
    assert torch.equal(pred, want_pred)
    for a, b in zip((neg, valid, prec, rec), saliency_reductions_plain(want_pred, g, 1)):
        assert torch.equal(a.detach(), b)
    (torch.from_numpy(w) * torch.where(valid, neg, 0.0)).sum().backward()
    want, _ = _port_chain_grad(x8, gt, w, dtype, 1)
    assert torch.equal(x.grad, want)
    assert (saliency_stats.launches, saliency_head_grad.launches) == (fwd, bwd)


@pytest.mark.parametrize("dropped", ["dL/dp", "d_rows"])
def test_flip_share_sees_a_dropped_rounding(inputs, dropped):
    """The flip share the card checks hold the bfloat16 kernel to tells a
    gradient that keeps every bfloat16 rounding point from one that drops
    one: the plain gradient without the rounding of dL/dp or of d_rows
    differs from the plain version in far more than BF16_FLIP_SHARE of the
    valid items' elements. Without the rounding of d_rows it stays within
    TOL, so TOL alone cannot see that."""
    x8, gt, w = inputs
    x, g = torch.from_numpy(x8).bfloat16(), torch.from_numpy(gt)
    _, valid = _port_chain_grad(x8, gt, w, "bfloat16", 0)
    up = torch.from_numpy(w) * valid
    want = saliency_head_grad_plain(x, g, up)
    wts = resize_weights(8, HW, "cpu").bfloat16().float()
    dp = saliency_nss_grad_plain(saliency_upsample(x, HW).float(), g, up)
    if dropped != "dL/dp":
        dp = dp.bfloat16().float()
    d_rows = torch.einsum("bpq,jq->bpj", dp, wts)
    if dropped != "d_rows":
        d_rows = d_rows.bfloat16().float()
    got = torch.einsum("bpj,ip->bij", d_rows, wts).bfloat16()
    share = (got[[0, 3]] != want[[0, 3]]).float().mean().item()
    assert share > 10 * BF16_FLIP_SHARE, share
    if dropped == "d_rows":
        _close(got.float().numpy(), want.float().numpy(), "bfloat16", ok=[0, 3])


def test_head_grad_wrapper_rejects_cpu_tensors(inputs):
    x8, gt, _ = (torch.from_numpy(a) for a in inputs)
    with pytest.raises(ValueError, match="CUDA"):
        saliency_head_grad(x8, gt, torch.zeros((N_ITEMS, 8)), torch.zeros(N_ITEMS))


# ------------------------------------------------------------ on the card --


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("nss_r", [0, 1, -1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [8, 16, 80, 240])
def test_head_grad_kernel_matches_plain_on_card(N, dtype, nss_r):
    """The op's backward on the card: one forward and one backward launch,
    the kernel's dL/dx8 against the plain version within TOL (in bfloat16
    differing in at most BF16_FLIP_SHARE of its elements), exactly 0 on the
    std = 0, Σg = 0 and zero-weight items, repeated launches bitwise equal,
    and every split of an item's rows (8, 16 and 32 bands) within TOL of the
    plain."""
    _card()
    x8, gt, w = (torch.from_numpy(a).cuda() for a in _inputs(N, N + nss_r + 1))
    x8 = x8.to(DTYPES[dtype][0])
    w[3] = 0.0  # a valid item the loss does not weigh
    x = x8.clone().requires_grad_(True)
    fwd, bwd = saliency_stats.launches, saliency_head_grad.launches
    _, neg, valid, _, _ = saliency_head_reductions(x, gt, nss_r)
    (w * torch.where(valid, neg, 0.0)).sum().backward()
    torch.cuda.synchronize()
    assert (saliency_stats.launches, saliency_head_grad.launches) == (fwd + 1, bwd + 1)
    want = saliency_head_grad_plain(x8, gt, w * valid, nss_r)
    ok = [i for i in range(N) if i not in (1, 2, 3)]
    _close(x.grad.float().cpu().numpy(), want.float().cpu().numpy(), dtype, ok)
    if dtype == "bfloat16":
        assert (x.grad != want).float().mean().item() <= BF16_FLIP_SHARE
    stats = saliency_fused(saliency_upsample(x8, HW).float(), gt, nss_r)[0]
    up = (w * valid).contiguous()
    runs = [saliency_head_grad(x8, gt, stats, up, nss_r) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    assert torch.equal(runs[0], x.grad)
    for blocks in (8, 16, 32):
        split = _head_grad_launch(x8, gt, stats, up, nss_r, blocks)
        _close(split.float().cpu().numpy(), want.float().cpu().numpy(), dtype, ok)


@pytest.mark.cuda
def test_head_grad_wrapper_rejects_mismatched_inputs_on_card(inputs):
    _card()
    x8, gt, _ = (torch.from_numpy(a).cuda() for a in inputs)
    stats, up = torch.zeros((N_ITEMS, 8), device="cuda"), torch.zeros(N_ITEMS, device="cuda")
    bad = [
        (x8.half(), gt, stats, up),                    # head dtype
        (x8.reshape(N_ITEMS, 64), gt, stats, up),      # head shape
        (x8, gt[:2], stats, up),                       # N differs
        (x8, gt.double(), stats, up),                  # map dtype
        (x8, gt[:, :200, :200].contiguous(), stats, up),  # H not a multiple of 32
        (x8, gt, stats[:, :6].contiguous(), up),       # stats row
        (x8, gt, stats, up[:2]),                       # upstream
        (x8, gt.cpu(), stats, up),                     # device
    ]
    for args in bad:
        with pytest.raises(ValueError):
            saliency_head_grad(*args)
    for blocks in (4, 64):
        with pytest.raises(ValueError, match="blocks"):
            _head_grad_launch(x8, gt, stats, up, 0, blocks)


@pytest.mark.cuda
def test_reductions_refuse_a_gradient_on_card(inputs):
    """On the card −NSS is differentiated in the head only: the full-map
    reductions have no backward there and refuse a map that needs one."""
    _card()
    pred = torch.rand((N_ITEMS, HW, HW), device="cuda", requires_grad=True)
    with pytest.raises(ValueError, match="saliency_head_reductions"):
        saliency_reductions(pred, pred.detach())
