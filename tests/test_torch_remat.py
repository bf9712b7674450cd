"""Rematerialised training is exact, in the port alone, on the CPU at tiny
width (the fixture's train split, B = 2, T = 3, demb 64, the exact render,
``--feedback student``), with dropout on (the trunk's and BERT's rates).

For ``--remat`` with the ``full`` and the ``dots`` policy, in float32 and in
bfloat16 towers, one train loss and its backward from the same weights,
items and generator seed as ``--remat False`` give, bit for bit: the loss,
every gradient leaf, the BatchNorm running statistics and the generator's
state after the step. So the backward pass's recompute draws the forward's
dropout masks (the generator restored to its state at the step) and updates
the running statistics once, as flax's functional state does. A whole
``--grad_accum 2`` train step under remat equals the one without.
"""

import copy
import dataclasses
import json
import os

import pytest
import torch

from test_e2e_loop import make_args
from torch_shared import fixture_dataset

B_ITEMS = 2
T_STEPS = 3


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from avdn_tpu_torch.config import Args, postprocess_args
    from avdn_tpu_torch.data.batcher import make_train_batch
    from avdn_tpu_torch.data.maps import DeviceMapBank
    from avdn_tpu_torch.data.tokenizer import WordPieceTokenizer
    from avdn_tpu_torch.serve import Navigator
    from avdn_tpu_torch.train.loop import batcher_config

    root, cfg_path = fixture_dataset(tmp_path_factory)
    out = str(tmp_path_factory.mktemp("remat"))
    jargs = make_args(root, out, cfg_path, render_twopass=False,
                      batch_size=B_ITEMS, max_action_len=T_STEPS)
    args = postprocess_args(Args(**dataclasses.asdict(jargs)))
    with open(os.path.join(args.train_anno_dir, "train_data.json")) as f:
        items = [Navigator._normalize_item(it) for it in json.load(f)[:B_ITEMS]]
    bank = DeviceMapBank(args.train_dataset_dir, (args.map_bank_px,) * 2,
                         n_slots=args.map_bank_slots, device="cpu")
    arr, slots = bank.prepare(items)
    batch, _ = make_train_batch(items, WordPieceTokenizer.load(None), slots,
                                batcher_config(args))
    return args, arr, batch, {}


def _step(setup, bf16, remat, policy="full"):
    """One train loss and backward: (loss, grads by name, BN running
    statistics, the generator's state after it)."""
    from avdn_tpu_torch.train.loop import build_models, init_state, train_config_from_args
    from avdn_tpu_torch.train.step import make_loss_fn

    args, arr, batch, _ = setup
    models = build_models(args, torch.device("cpu"), bf16=bf16)
    init_state(models, torch.Generator().manual_seed(0))
    cfg = dataclasses.replace(train_config_from_args(args), remat=remat,
                              remat_policy=policy)
    for m in models:
        m.train()
    gen = torch.Generator().manual_seed(5)
    loss = make_loss_fn(cfg, *models)(batch, arr, gen, B_ITEMS)
    loss.backward()
    grads = {f"{i}.{n}": p.grad for i, m in enumerate(models)
             for n, p in m.named_parameters()}
    stats = {n: b.clone() for n, b in models[1].named_buffers()}
    return loss.detach(), grads, stats, gen.get_state()


def _reference(setup, bf16):
    cache = setup[3]
    if bf16 not in cache:
        cache[bf16] = _step(setup, bf16, remat=False)
    return cache[bf16]


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_remat_step_is_exact(setup, bf16, policy):
    loss, grads, stats, rng = _step(setup, bf16, remat=True, policy=policy)
    want_loss, want_grads, want_stats, want_rng = _reference(setup, bf16)
    assert torch.isfinite(loss) and loss > 0
    assert torch.equal(loss, want_loss)
    assert set(grads) == set(want_grads)
    n_nonzero = 0
    for name, g in grads.items():
        w = want_grads[name]
        assert (g is None) == (w is None), name
        if g is not None:
            assert torch.equal(g, w), (name, float((g - w).abs().max()))
            n_nonzero += bool(g.abs().max() > 0)
    assert n_nonzero > len(grads) // 2
    for name, s in stats.items():
        assert torch.equal(s, want_stats[name]), name
    assert torch.equal(rng, want_rng)


def test_grad_accum_under_remat(setup):
    """``--grad_accum 2`` (two micro-batches of one item, the BatchNorm
    statistics chained) with ``--remat`` dots equals it without: every
    parameter and running statistic after one optimizer step."""
    from avdn_tpu_torch.train.loop import build_models, init_state, train_config_from_args
    from avdn_tpu_torch.train.step import create_train_state, make_train_step

    args, arr, batch, _ = setup
    base = build_models(args, torch.device("cpu"))
    init_state(base, torch.Generator().manual_seed(0))
    after = []
    for remat in (False, True):
        models = copy.deepcopy(base)
        cfg = dataclasses.replace(train_config_from_args(args), grad_accum=2,
                                  remat=remat, remat_policy="dots")
        metrics = make_train_step(cfg, *models)(create_train_state(cfg, *models), arr,
                                                batch, torch.Generator().manual_seed(5))
        after.append((metrics, [m.state_dict() for m in models]))
    (m0, sd0), (m1, sd1) = after
    assert torch.equal(m0["loss"], m1["loss"])
    assert float(m0["grad_norm_vln"]) > 0
    for a, b in zip(sd0, sd1):
        for name, x in a.items():
            assert torch.equal(x, b[name]), name
