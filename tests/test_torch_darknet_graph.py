"""Which Darknet calls replay CUDA graphs, on the CPU (``models/darknet.py``).

A train-mode call with grad on the card replays a captured forward and
backward; every other call runs the eager code. Here no call can replay:
each runs eager and is counted under its first reason (eval mode, no grad,
the global batch, frozen running statistics, a rematerialised step, the
CPU), and the output, the gradients and the running statistics are those of
the eager forward itself, bit for bit. A call's lease frees its arena at
the call's backward, or when autograd drops the call's graph without one. The
graphs themselves are held on the card by
``tests/test_torch_darknet_graph_card.py``.
"""

import contextlib
import copy

import pytest
import torch

from avdn_tpu_torch.models.darknet import (Darknet, DarknetConfig, _Lease,
                                           frozen_running_stats, rematerialising)
from avdn_tpu_torch.parallel import batch


def _tower(seed=0):
    torch.manual_seed(seed)
    net = Darknet(DarknetConfig.tiny())
    with torch.no_grad():
        for name, t in net.named_parameters():
            t.copy_(torch.randn_like(t) * 0.2 + (1.0 if name.endswith("weight")
                                                  and t.dim() == 1 else 0.0))
    return net


def _no_params_grad(net):
    for p in net.parameters():
        p.requires_grad_(False)
    return contextlib.nullcontext()


CASES = {
    "cpu": (True, lambda net: contextlib.nullcontext()),
    "eval": (False, lambda net: contextlib.nullcontext()),
    "no_grad": (True, lambda net: torch.no_grad()),
    "inference_mode": (True, lambda net: torch.inference_mode()),
    "frozen_params": (True, _no_params_grad),
    "frozen_stats": (True, lambda net: frozen_running_stats()),
    "remat": (True, lambda net: rematerialising()),
}
REASON = {"inference_mode": "no_grad", "frozen_params": "no_grad"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_call_runs_eager_under_its_reason(case):
    training, context = CASES[case]
    net = _tower().train(training)
    x = torch.randn(2, 224, 224, 3)
    with context(net):
        y = net(x)
    assert y.shape == (2, 64, 49)
    assert dict(net.graph_calls) == {"eager." + REASON.get(case, case): 1}


def test_global_batch_runs_eager():
    """Inside ``global_batch`` BatchNorm all-reduces over the ranks, which a
    graph cannot capture (the reason alone: the forward needs a group)."""
    net = _tower().train()
    x = torch.randn(2, 224, 224, 3)
    with batch.global_batch(object()):
        assert net._eager_reason(x) == "global_batch"
        with frozen_running_stats():
            assert net._eager_reason(x) == "global_batch"
    assert net._eager_reason(x) == "cpu"
    with torch.no_grad(), batch.global_batch(object()):
        assert net._eager_reason(x) == "no_grad"


def test_cpu_train_call_equals_the_eager_forward():
    """Two train-mode calls and one backward through ``forward`` against the
    same through the eager ``_forward``: outputs, gradients and running
    statistics bit-equal, and no capture or replay counted."""
    nets = [_tower(), None]
    nets[1] = copy.deepcopy(nets[0])
    xs = [torch.randn(2, 224, 224, 3) for _ in range(2)]
    outs = []
    for net, call in zip(nets, (lambda n, x: n(x), lambda n, x: n._forward(x))):
        net.train()
        ys = [call(net, x) for x in xs]
        (ys[0] * 0.5 + ys[1] * ys[1]).sum().backward()
        outs.append((ys, [p.grad for p in net.parameters()], list(net.buffers())))
    for got, want in zip(*outs):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert dict(nets[0].graph_calls) == {"eager.cpu": 2}
    assert not nets[1].graph_calls


def test_rematerialised_tower_runs_eager_both_times():
    """Under ``rollout/engine.py:rematerialised`` the forward runs eager
    (``remat``) and so does the recompute in the backward pass, which
    freezes the running statistics (``frozen_stats``)."""
    from avdn_tpu_torch.rollout.engine import rematerialised

    net = _tower().train()
    fn = rematerialised(lambda x: net(x), "full", torch.Generator())
    fn(torch.randn(2, 224, 224, 3).requires_grad_()).sum().backward()
    assert dict(net.graph_calls) == {"eager.remat": 1, "eager.frozen_stats": 1}


def test_lease_frees_its_arena_once():
    """An arena is held while its call lives: freed by the call's backward
    (``take``; a second backward raises) or when autograd drops the call's
    graph (the lease with it), never both."""

    class Arena:
        free = True

    arena = Arena()
    lease = _Lease(arena)
    assert not arena.free
    assert lease.take() is arena
    with pytest.raises(RuntimeError, match="backward ran twice"):
        lease.take()
    del lease
    assert not arena.free  # the backward hands it back, not the lease
    lease = _Lease(arena)
    assert not arena.free
    del lease
    assert arena.free


def test_capture_leaves_stand_in_for_the_parameters():
    """What a capture records: the forward with each trainable parameter
    swapped for a new leaf on its memory (``_own_leaves``), and the
    gradients of those leaves, which equal the parameters' own; after it the
    module holds its parameters again."""
    from avdn_tpu_torch.models.darknet import _own_leaves

    net = _tower().train()
    ref = copy.deepcopy(net)
    net.module_list[0][0].weight.requires_grad_(False)
    ref.module_list[0][0].weight.requires_grad_(False)
    before = [id(p) for p in net.parameters()]
    trained = [p for p in net.parameters() if p.requires_grad]
    x = torch.randn(2, 224, 224, 3)
    with _own_leaves(net._train_graphs.param_dicts) as leaves:
        assert len(leaves) == len(trained) and not any(
            a is b or a.data_ptr() != b.data_ptr() for a, b in zip(leaves, trained))
        out = net._forward(x)
        grads = torch.autograd.grad(out, leaves, out.detach().cos())
    assert [id(p) for p in net.parameters()] == before
    want = ref._forward(x)
    want.backward(want.detach().cos())
    assert torch.equal(out, want)
    assert all(torch.equal(g, p.grad) for g, p in zip(
        grads, (p for p in ref.parameters() if p.requires_grad)))
    assert all(p.grad is None for p in net.parameters())


def test_arena_copy_by_dtype_and_layout():
    """``_copy``, which moves a call's saved activations into its arena and
    back: every pair copied exactly, whatever the mix of dtypes and
    layouts (channels-last views, as the tower saves them)."""
    from avdn_tpu_torch.models.darknet import _copy

    src = [torch.randn(2, 8, 5, 5).to(memory_format=torch.channels_last),
           torch.randn(2, 8, 25).permute(0, 2, 1), torch.randn(7),
           torch.randint(0, 255, (9,), dtype=torch.uint8), torch.randn(3, 3).double()]
    dst = [torch.empty_like(t) for t in src]
    _copy(dst, src)
    assert all(torch.equal(a, b) and a.stride() == b.stride() for a, b in zip(dst, src))
