"""Darknet's train-mode CUDA graphs on the card against its eager code
(``cuda`` marker; skips without a card). It imports neither ``jax`` nor
``avdn_tpu``, so it also collects on a card machine without flax.

The reference is the same module forced onto the eager path (its
``_eager_reason`` replaced), from the same weights and inputs, with TF32
off. Default Darknet-53 at B = 4: 20 calls and one backward, twice (the
second pass replays the first's captures and accumulates into the
gradients the first left), with the outputs, the loss and the running
statistics bit-equal and every gradient leaf within the run-to-run
spread of cuDNN's backward (:data:`GRAD_BAR`); one capture and 20 arenas;
no ``.grad`` shares memory with the graph's gradients. A capture while a
call of another input shape is alive. One
``make_train_step`` step of each family at tiny width (``chip_smoke``'s
tiny set-up), and one at ``--grad_accum 2``: the loss, the gradients handed
to the optimizers and the running statistics against eager. The eager
fallbacks on the card (eval, no grad, frozen running statistics, a
rematerialised call) capture and replay nothing. Deleting the module
returns its graphs' memory.
"""

import copy
import gc

import pytest
import torch

pytestmark = pytest.mark.cuda

#: a gradient leaf's difference over its norm (or the median leaf's, if
#: larger), graphed against eager: 5x the most that eager against eager
#: read on an H100 (6.2e-6; cuDNN's backward sums in no fixed order)
GRAD_BAR = 3e-5


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    from avdn_tpu_torch.device import use_fp32_numerics

    use_fp32_numerics()
    return torch.device("cuda", 0)


def _eager(net):
    net._eager_reason = lambda x: "reference"
    return net


def _pair(device, cfg=None, seed=0):
    """A default Darknet-53 with non-trivial BatchNorm weights on
    ``device`` in train mode, and its eager twin."""
    from avdn_tpu_torch.models.darknet import Darknet, DarknetConfig

    torch.manual_seed(seed)
    net = Darknet(cfg or DarknetConfig.default())
    with torch.no_grad():
        for bn in (m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)):
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.uniform_(-0.2, 0.2)
    net = net.to(device).train()
    return net, _eager(copy.deepcopy(net))


def _gaps(got, want):
    """Per leaf, the norm of ``got − want`` over the norm of ``want``'s leaf
    or of its median leaf, whichever is larger (None leaves skipped)."""
    pairs = [(a, b) for a, b in zip(got, want) if b is not None]
    size = sorted(float(torch.linalg.vector_norm(b)) for _, b in pairs)
    floor = size[len(size) // 2]
    return [float(torch.linalg.vector_norm(a - b)) / max(float(torch.linalg.vector_norm(b)),
                                                         floor, 1e-30) for a, b in pairs]


def _graph_buffers(net):
    return {g.data_ptr() for graph in net._train_graphs.graphs.values()
            for g in graph.grads if g is not None}


def _arenas(net):
    return sorted(len(graph.arenas) for graph in net._train_graphs.graphs.values())


def _calls(net, xs, ws):
    outs = [net(x) for x in xs]
    loss = sum((o * w).sum() for o, w in zip(outs, ws))
    loss.backward()
    return outs, loss.detach()


def _check_same(net, ref, got, want):
    (outs, loss), (routs, rloss) = got, want
    assert all(torch.equal(a, b) for a, b in zip(outs, routs))
    assert torch.equal(loss, rloss)
    assert all(torch.equal(a, b) for a, b in zip(net.buffers(), ref.buffers()))
    gaps = _gaps([p.grad for p in net.parameters()], [p.grad for p in ref.parameters()])
    print(f"worst gradient leaf gap {max(gaps):.3e} over {len(gaps)} leaves")
    assert max(gaps) <= GRAD_BAR
    held = _graph_buffers(net)
    assert not any(p.grad.data_ptr() in held for p in net.parameters())


def test_twenty_calls_twice_equal_eager(card):
    net, ref = _pair(card)
    g = torch.Generator(card).manual_seed(1)
    xs = [torch.randn(4, 224, 224, 3, device=card, generator=g) for _ in range(20)]
    ws = [torch.randn(4, 512, 49, device=card, generator=g) for _ in range(20)]
    for rnd in range(2):  # the second adds into the gradients the first left
        got, want = _calls(net, xs, ws), _calls(ref, xs, ws)
        _check_same(net, ref, got, want)
        assert dict(net.graph_calls) == {"capture": 1, "replay": 20 * (rnd + 1)}
        assert dict(ref.graph_calls) == {"eager.reference": 20 * (rnd + 1)}
        assert _arenas(net) == [20]
        assert all(a.free for graph in net._train_graphs.graphs.values()
                   for a in graph.arenas)


def test_capture_beside_a_live_call_of_another_shape(card):
    net, ref = _pair(card)
    g = torch.Generator(card).manual_seed(2)
    xs = [torch.randn(b, 224, 224, 3, device=card, generator=g) for b in (4, 2, 4)]
    ws = [torch.randn(b, 512, 49, device=card, generator=g) for b in (4, 2, 4)]
    for rnd in range(2):
        _check_same(net, ref, _calls(net, xs, ws), _calls(ref, xs, ws))
        assert dict(net.graph_calls) == {"capture": 2, "replay": 3 * (rnd + 1)}
        assert _arenas(net) == [1, 2]


def test_eager_fallbacks_on_the_card(card):
    from avdn_tpu_torch.models.darknet import DarknetConfig, frozen_running_stats
    from avdn_tpu_torch.rollout.engine import rematerialised

    net, _ = _pair(card, DarknetConfig.tiny())
    x = torch.randn(2, 224, 224, 3, device=card)
    with torch.no_grad():
        net(x)
    with frozen_running_stats():
        net(x).sum().backward()
    rematerialised(lambda v: net(v), "full", torch.Generator(card))(x).sum().backward()
    net.eval()
    net(x)
    assert dict(net.graph_calls) == {"eager.no_grad": 1, "eager.frozen_stats": 2,
                                     "eager.remat": 1, "eager.eval": 1}


@pytest.mark.parametrize("family,flags", [
    ("et", []), ("lstm", ["--family", "lstm"]),
    ("et_accum2", ["--grad_accum", "2"]), ("lstm_accum2", ["--family", "lstm", "--grad_accum", "2"]),
])
def test_train_step_equals_eager(card, tmp_path_factory, family, flags):
    import chip_smoke
    from avdn_tpu_torch.train.loop import train_config_from_args
    from avdn_tpu_torch.train.step import create_train_state, make_train_step

    root = str(tmp_path_factory.getbasetemp() / "graph_data")
    if not (tmp_path_factory.getbasetemp() / "graph_data").exists():
        chip_smoke.write_dataset(root, chip_smoke.make_maps("cpu"), chip_smoke.make_items(),
                                 chip_smoke.make_items(chip_smoke.SEED + 3, prefix="t"))
    work = str(tmp_path_factory.mktemp("graph_work"))
    runs = []
    for eager in (False, True):
        args, models, arr, batch = chip_smoke._tiny_setup(flags, "cuda", root, work)
        if eager:
            _eager(models[1])
        cfg = train_config_from_args(args)
        state = create_train_state(cfg, *models)
        handed = []
        for opt in state.optimizers():
            def step(grads, norm=None, inner=opt.step):
                handed.extend(g.clone() for g in grads)
                return inner(grads, norm)
            opt.step = step
        loss = make_train_step(cfg, *models)(
            state, arr, batch, torch.Generator("cuda").manual_seed(chip_smoke.SEED))["loss"]
        runs.append((loss, handed, [b.clone() for b in models[1].buffers()],
                     dict(models[1].graph_calls)))
    (loss, grads, stats, counts), (rloss, rgrads, rstats, rcounts) = runs
    assert torch.equal(loss, rloss)
    assert all(torch.equal(a, b) for a, b in zip(stats, rstats))
    gaps = _gaps(grads, rgrads)
    print(f"{family}: worst gradient leaf gap {max(gaps):.3e}; graphed {counts}, "
          f"eager {rcounts}")
    assert max(gaps) <= GRAD_BAR
    assert counts["capture"] >= 1 and counts["replay"] == sum(rcounts.values())
    assert set(counts) == {"capture", "replay"}


def test_deleting_the_module_returns_its_graph_memory(card):
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    net, ref = _pair(card)
    del ref
    xs = [torch.randn(4, 224, 224, 3, device=card) for _ in range(3)]
    _calls(net, xs, [1.0] * 3)
    held = torch.cuda.memory_reserved()
    assert net.graph_calls["capture"] == 1 and _arenas(net) == [3]
    del net, xs
    gc.collect()
    torch.cuda.empty_cache()
    print(f"reserved: {base / 2**20:.1f} MiB before, {held / 2**20:.1f} with 3 arenas, "
          f"{torch.cuda.memory_reserved() / 2**20:.1f} after")
    assert torch.cuda.memory_reserved() <= base + 2**20
