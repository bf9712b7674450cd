"""Darknet/YOLOv3 vision tower — cfg-driven conv stack (torch counterpart of
``avdn_tpu/models/darknet.py``).

The reference parses a darknet ``.cfg`` at runtime into torch modules and
uses the network purely as a feature extractor: its forward returns the LAST
layer's activation, which for the released xView config at 224 input is a
(B, 512, 7, 7) conv feature map (src/models/dark_net.py:201-240; callers
flatten to (B, 512, 49), src/xview_et/agent.py:593-594).

This implementation parses the same cfg format, builds the modules with the
reference's names (``module_list.{i}.conv_{i}``,
``module_list.{i}.batch_norm_{i}``) and computes in NCHW inside. At the
module boundary it takes the NHWC views the rollout engine renders and
returns channel-major (B, C, H*W) features, like the JAX tower, in the
compute ``dtype``: as flax's ``nn.Conv(dtype=...)``, each conv casts input,
kernel and bias to it (float32 parameters).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import threading
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from avdn_tpu_torch.parallel import batch
from avdn_tpu_torch.utils.logging import span


def parse_darknet_cfg(text: str) -> List[Dict[str, str]]:
    """Parse darknet cfg text into a list of block dicts (same grammar as the
    reference parser, src/models/dark_net.py:243-261)."""
    blocks: List[Dict[str, str]] = []
    for raw in text.split("\n"):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("["):
            blocks.append({"type": line[1:-1].strip()})
            if blocks[-1]["type"] == "convolutional":
                blocks[-1]["batch_normalize"] = "0"
        else:
            k, v = line.split("=", 1)
            blocks[-1][k.strip()] = v.strip()
    return blocks


def _res_block(ch: int) -> str:
    half = ch // 2
    return f"""
[convolutional]
batch_normalize=1
filters={half}
size=1
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters={ch}
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-3
activation=linear
"""


def default_xview_cfg() -> str:
    """Generated darknet-53 feature-extractor config: backbone to 1024@/32
    plus the YOLOv3 stride-32 conv head ending at 512 channels — i.e. a
    (B, 512, 7, 7) output at 224 input, matching the shape contract of the
    released xView config (SURVEY.md §2.1 #8)."""
    parts = [
        """
[net]
channels=3
height=224
width=224
""",
        """
[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky
""",
    ]
    stages = [(64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)]
    for ch, nres in stages:
        parts.append(
            f"""
[convolutional]
batch_normalize=1
filters={ch}
size=3
stride=2
pad=1
activation=leaky
"""
        )
        parts.extend(_res_block(ch) for _ in range(nres))
    # stride-32 YOLO head conv set, cut at the final 512 feature map
    for f, s in [(512, 1), (1024, 3), (512, 1), (1024, 3), (512, 1)]:
        parts.append(
            f"""
[convolutional]
batch_normalize=1
filters={f}
size={s}
stride=1
pad=1
activation=leaky
"""
        )
    return "".join(parts)


@dataclasses.dataclass(frozen=True)
class DarknetConfig:
    blocks: tuple  # tuple of frozen block dicts (hashable for flax)
    img_size: int = 224

    @staticmethod
    def from_text(text: str, img_size: int = 224) -> "DarknetConfig":
        blocks = parse_darknet_cfg(text)
        return DarknetConfig(
            blocks=tuple(tuple(sorted(b.items())) for b in blocks), img_size=img_size
        )

    @staticmethod
    def default(img_size: int = 224) -> "DarknetConfig":
        return DarknetConfig.from_text(default_xview_cfg(), img_size)

    @staticmethod
    def tiny(img_size: int = 224) -> "DarknetConfig":
        """Small tower for tests: 4 convs + shortcut + route → (B, 64, 7, 7)."""
        txt = """
[net]
channels=3
height=224
width=224

[convolutional]
batch_normalize=1
filters=16
size=3
stride=4
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=3
stride=4
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-3
activation=linear

[convolutional]
batch_normalize=1
filters=64
size=3
stride=2
pad=1
activation=leaky
"""
        return DarknetConfig.from_text(txt, img_size)

    def block_dicts(self) -> List[Dict[str, str]]:
        return [dict(b) for b in self.blocks]



class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` like flax's ``nn.Conv``: in a
    reduced type the convolution is rounded before the bias is added, as
    XLA does."""

    def __init__(self, *args, dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.dtype = dtype

    def forward(self, x):
        if self.dtype == torch.float32:
            return super().forward(x)
        y = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), None,
                     self.stride, self.padding)
        return y if self.bias is None else y + self.bias.to(self.dtype)[:, None, None]


#: flax's ``BatchNorm(momentum=...)`` of the JAX tower (``bn_momentum``):
#: the running statistics keep 0.9 of their value at each train-mode call
BN_MOMENTUM = 0.9

_frozen_stats = 0
_remat = 0
_count_lock = threading.Lock()  # Darknet.graph_calls: a tower may be called from several threads


@contextlib.contextmanager
def frozen_running_stats():
    """Inside, train-mode :class:`BatchNorm2d` still normalises with the
    batch's statistics but leaves the running ones as they are: a
    rematerialised step recomputes its tower in the backward pass, and its
    forward already updated them once (flax's functional state is updated
    once per call, whatever is recomputed). A :class:`Darknet` call inside
    runs eager: its graphs capture the update."""
    global _frozen_stats
    _frozen_stats += 1
    try:
        yield
    finally:
        _frozen_stats -= 1


@contextlib.contextmanager
def rematerialising():
    """Inside, a train-mode :class:`Darknet` call runs eager
    (``rollout/engine.py:rematerialised`` enters it around the checkpoint):
    a graphed call keeps every activation its backward reads, which the
    recompute is there to drop."""
    global _remat
    _remat += 1
    try:
        yield
    finally:
        _remat -= 1


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` normalising in float32 and returning ``dtype``
    (flax ``nn.BatchNorm(dtype=...)``). Eval mode normalises with the
    running statistics. Train mode is flax's ``use_running_average=False``:
    it normalises with the batch's mean and biased variance over (N, H, W)
    and then updates the running statistics as
    ``r ← μ·r + (1 − μ)·s`` with μ = :data:`BN_MOMENTUM` and the batch's
    biased variance computed as flax does, E[x²] − E[x]² clipped at 0.
    (``torch.nn.BatchNorm2d``'s own update would use the unbiased variance
    and weigh the new value by its ``momentum``.) The update is in place,
    outside autograd, so T calls in a row chain the statistics as T steps
    of a rollout do; inside :func:`frozen_running_stats` it is skipped.
    Inside ``parallel.batch.global_batch`` the statistics are those of the
    global batch of every rank (:meth:`_global_batch_forward`)."""

    def __init__(self, n: int, eps: float, dtype=torch.float32):
        super().__init__(n, eps=eps)
        self.dtype = dtype

    def forward(self, x):
        x = x.float()
        if not self.training:
            return super().forward(x).to(self.dtype)
        if batch.active():
            return self._global_batch_forward(x)
        if not _frozen_stats:
            with torch.no_grad():
                mean = x.mean(dim=(0, 2, 3))
                self._update_running_stats(
                    mean, torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0))
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return y.to(self.dtype)

    def _global_batch_forward(self, x):
        """Train mode over the global batch of a data-parallel step: Σx, Σx²
        and the count all-reduced across the ranks (differentiably), then
        flax's statistics, the mean and E[x²] − E[x]² clipped at 0."""
        C = x.shape[1]
        sums = torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)),
                          x.new_full((1,), x.numel() // C)])
        sums = batch.batch_sum(sums)
        mean = sums[:C] / sums[-1]
        var = torch.clamp(sums[C:2 * C] / sums[-1] - mean * mean, min=0.0)
        if not _frozen_stats:
            self._update_running_stats(mean.detach(), var.detach())
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)

    @torch.no_grad()
    def _update_running_stats(self, mean, var):
        mu = BN_MOMENTUM
        self.running_mean.copy_(mu * self.running_mean + (1.0 - mu) * mean)
        self.running_var.copy_(mu * self.running_var + (1.0 - mu) * var)


def leaky_slope(dtype) -> float:
    """flax's ``leaky_relu(x, 0.01)`` multiplies by 0.01 cast to the
    activation's dtype."""
    return float(torch.tensor(0.01, dtype=dtype))


def _conv_blocks(cfg: DarknetConfig):
    """(index, block) of every convolutional block after ``[net]``."""
    return [(i, b) for i, b in enumerate(cfg.block_dicts()[1:])
            if b["type"] == "convolutional"]


def output_channels(cfg: DarknetConfig) -> List[int]:
    """Channel count of every layer's output (the input's first)."""
    chans = [int(cfg.block_dicts()[0].get("channels", 3))]
    outs: List[int] = []
    for b in cfg.block_dicts()[1:]:
        t = b["type"]
        if t == "convolutional":
            ch = int(b["filters"])
        elif t == "route":
            ch = sum(outs[int(v)] for v in b["layers"].split(","))
        elif t == "shortcut":
            ch = outs[int(b["from"])]
        else:  # upsample, maxpool, yolo keep the channel count
            ch = outs[-1] if outs else chans[0]
        outs.append(ch)
    return chans + outs


class Darknet(nn.Module):
    """Darknet network. ``forward(x (B, H, W, 3))`` returns the last layer's
    activation as (B, C, H*W), spatial flattened channel-major — the layout
    downstream attention expects (src/xview_et/agent.py:593-594).

    ``folded=True`` builds the eval-inference variant: every conv carries a
    bias and no BatchNorm modules exist — load it with the state dict of
    :func:`fold_darknet_params` (running stats folded into the conv weights).

    A train-mode call on the card replays CUDA graphs: one captured forward
    (the BatchNorm running statistics updated in place, as eager) and one
    captured backward, two graph launches where eager launches ~1,000
    kernels, each with ~50 µs of host set-up. The pair is captured at the
    first call of each input shape (:class:`_TrainGraphs`). A train step
    keeps all its calls' activations until its backward, so each live call
    copies the activations its backward reads into an arena of its own
    after its forward, and back before its backward: a few multi-tensor
    copies a call, where a pair of graphs per live call took a capture
    each (~0.1–0.5 s of host apiece) at the first step. A call runs eager, the
    same kernels launched one by one, where a graph cannot hold its
    semantics (:meth:`_eager_reason`): in eval mode, without grad, inside
    ``parallel.batch.global_batch`` (its all-reduce cannot be captured),
    inside :func:`frozen_running_stats` or :func:`rematerialising`, and on
    the CPU. ``graph_calls`` counts captures, replays and eager calls by
    reason.
    """

    def __init__(self, cfg: DarknetConfig, folded: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.folded = folded
        self.dtype = dtype
        self._blocks = cfg.block_dicts()[1:]
        chans = output_channels(cfg)
        self.module_list = nn.ModuleList()
        for i, b in enumerate(self._blocks):
            seq = nn.Sequential()
            if b["type"] == "convolutional":
                bn = int(b.get("batch_normalize", "0")) and not folded
                k = int(b["size"])
                pad = (k - 1) // 2 if int(b["pad"]) else 0
                seq.add_module(f"conv_{i}", Conv2d(
                    chans[i], int(b["filters"]), k, stride=int(b["stride"]),
                    padding=pad, bias=not bn, dtype=dtype))
                if bn:
                    seq.add_module(f"batch_norm_{i}",
                                   BatchNorm2d(int(b["filters"]), 1e-5, dtype))
                if b.get("activation") == "leaky":
                    # torch nn.LeakyReLU() default slope 0.01
                    # (src/models/dark_net.py:33)
                    seq.add_module(f"leaky_{i}", nn.LeakyReLU(leaky_slope(dtype)))
            elif b["type"] not in ("upsample", "route", "shortcut", "maxpool",
                                   "yolo"):
                raise ValueError(f"unsupported block type: {b['type']}")
            self.module_list.append(seq)
        self.graph_calls = collections.Counter()
        self._train_graphs = _TrainGraphs(self)

    def _eager_reason(self, x):
        """Why this call runs eager, or None where it replays a graph."""
        if not self.training:
            return "eval"
        if not torch.is_grad_enabled() or not (
                x.requires_grad or any(p.requires_grad for p in self.parameters())):
            return "no_grad"
        if batch.active():
            return "global_batch"
        if _frozen_stats:
            return "frozen_stats"
        if _remat:
            return "remat"
        if not x.is_cuda:
            return "cpu"
        return None

    def forward(self, x):
        why = self._eager_reason(x)
        with _count_lock:
            self.graph_calls["replay" if why is None else "eager." + why] += 1
        with span("models.darknet"):
            if why is not None:
                return self._forward(x)
            return self._train_graphs.call(self, x)

    def _forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC views → NCHW
        outputs = []
        for b, mod in zip(self._blocks, self.module_list):
            t = b["type"]
            if t == "convolutional":
                x = mod(x)
            elif t == "upsample":
                x = F.interpolate(x, scale_factor=int(b["stride"]), mode="nearest")
            elif t == "route":
                x = torch.cat([outputs[int(v)] for v in b["layers"].split(",")],
                              dim=1)
            elif t == "shortcut":
                x = outputs[-1] + outputs[int(b["from"])]
            elif t == "maxpool":
                k, s = int(b["size"]), int(b["stride"])
                # TF "SAME" padding with -inf, as flax's max_pool
                pads = []
                for n in (x.shape[3], x.shape[2]):
                    total = max((-(-n // s) - 1) * s + k - n, 0)
                    pads += [total // 2, total - total // 2]
                x = F.max_pool2d(F.pad(x, pads, value=float("-inf")), k, s)
            outputs.append(x)  # yolo: feature-extraction mode, identity
        return x.flatten(2)


class _TrainGraphs:
    """The captured graphs of one :class:`Darknet`'s train-mode calls, one
    pair by key (the input's shape, strides, dtype, device and whether it
    needs a gradient), and the arenas that hold each live call's saved
    activations between its forward and its backward. A call takes the
    first free arena of its key, or allocates one; the arena is free again
    once the call's backward has replayed, or once autograd drops the call's
    graph without one. So the K micro-batches of ``--grad_accum`` reuse one
    step's arenas, whatever a step is. The graphs read and write the
    parameters and buffers in place: where one of them is replaced (another
    address, or ``requires_grad`` flipped) the graphs are dropped and
    captured again, a live call's arena kept until its call has ended."""

    def __init__(self, net: "Darknet"):
        self.graphs: Dict[tuple, _Graph] = {}
        self.state = None
        # the tensors are read from their modules' dicts at each call, which
        # sees a replaced one (Module.parameters() walks the tree: ~10x slower)
        self.param_dicts = [m._parameters for m in net.modules() if m._parameters]
        self.tensor_dicts = self.param_dicts + [m._buffers for m in net.modules()
                                                if m._buffers]

    def __deepcopy__(self, memo):
        """A copy of the module captures graphs of its own."""
        new = copy.copy(self)
        new.graphs, new.state = {}, None
        new.param_dicts = copy.deepcopy(self.param_dicts, memo)
        new.tensor_dicts = copy.deepcopy(self.tensor_dicts, memo)
        return new

    def call(self, net: "Darknet", x):
        params = [p for d in self.param_dicts for p in d.values()
                  if p is not None and p.requires_grad]
        state = [(t.data_ptr(), t.requires_grad)
                 for d in self.tensor_dicts for t in d.values() if t is not None]
        if state != self.state:
            self.graphs, self.state = {}, state
        key = (tuple(x.shape), x.stride(), x.dtype, x.device, x.requires_grad)
        graph = self.graphs.get(key)
        if graph is None:
            with span("models.darknet.capture"):
                _warm_up(net, x, self.param_dicts)
                graph = self.graphs[key] = _Graph(net, x, self.param_dicts)
            with _count_lock:
                net.graph_calls["capture"] += 1
        arena = next((a for a in graph.arenas if a.free), None)
        if arena is None:
            arena = _Arena(graph.saved)
            graph.arenas.append(arena)
        return _Replay.apply(graph, arena, x, *params)


@contextlib.contextmanager
def _own_leaves(param_dicts):
    """The trainable parameters swapped, in their modules, for new leaves on
    the same memory. A capture's autograd graph then ends in accumulators of
    its own, made on the capture stream: the parameters' own accumulators,
    which the live calls' graphs keep, belong to the stream of the first
    call, and autograd's synchronisation with it would break the capture."""
    swapped = [(d, k, p) for d in param_dicts for k, p in d.items()
               if p is not None and p.requires_grad]
    for d, k, p in swapped:
        d[k] = p.detach().requires_grad_()
    try:
        yield [d[k] for d, k, _ in swapped]
    finally:
        for d, k, p in swapped:
            d[k] = p


def _warm_up(net: "Darknet", x, param_dicts):
    """One eager forward and backward on a side stream before a key's
    capture (cuDNN's and autograd's lazy set-up cannot run inside a
    capture), as ``torch.cuda.make_graphed_callables`` does; the running
    statistics are put back and the gradients thrown away."""
    saved = [b.clone() for b in net.buffers()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), _own_leaves(param_dicts) as leaves:
        xw = x.detach().requires_grad_(x.requires_grad)
        torch.autograd.grad(net._forward(xw).sum(),
                            ([xw] if x.requires_grad else []) + leaves, allow_unused=True)
        for b, s in zip(net.buffers(), saved):
            b.copy_(s)
    torch.cuda.current_stream().wait_stream(side)


class _Graph:
    """A key's two graphs. The forward reads the static input ``x`` and
    writes the static output ``out``, the running statistics and the
    activations its backward reads (``saved``: what autograd saved while
    the forward was captured, the parameters aside); the backward reads
    ``saved`` and the static output gradient ``gout`` and writes ``grads``,
    for the static input where it needs one and for each parameter that
    does. Both share a memory pool of their own. Capture records the
    kernels without running them; ``thread_local``: the prefetch thread may
    allocate and synchronise while a capture is on.
    One pair serves every live call of the key: each call's ``saved`` waits
    in an arena of its own between its forward and its backward."""

    def __init__(self, net: "Darknet", x, param_dicts):
        self.x = torch.empty_like(x).requires_grad_(x.requires_grad)
        self.arenas: List[_Arena] = []
        pool = torch.cuda.graph_pool_handle()
        self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        saved: Dict[tuple, torch.Tensor] = {}

        def keep(t):
            if not any(t is leaf for leaf in leaves) and t.numel():
                saved.setdefault((t.data_ptr(), t.dtype, t.shape, t.stride()), t)
            return t

        with _own_leaves(param_dicts) as leaves, \
                torch.autograd.graph.saved_tensors_hooks(keep, lambda t: t), \
                torch.cuda.graph(self.fwd, pool, capture_error_mode="thread_local"):
            out = net._forward(self.x)
        self.saved = list(saved.values())
        self.gout = torch.empty_like(out)
        with torch.cuda.graph(self.bwd, pool, capture_error_mode="thread_local"):
            # d/d out of (out · gout).sum() is gout, bit for bit; a scalar
            # root spares autograd's check of explicit output gradients,
            # which imports sympy at its first use (~3 s on the card's host)
            grads = torch.autograd.grad((out * self.gout).sum(),
                                        ([self.x] if x.requires_grad else []) + leaves,
                                        allow_unused=True)
        self.out = out.detach()
        self.grads = grads if x.requires_grad else (None, *grads)


def _copy(dst: List[torch.Tensor], src: List[torch.Tensor]):
    """``dst[i].copy_(src[i])`` for all i, in a few multi-tensor launches
    (one group per dtype: the fused path takes one dtype)."""
    groups = collections.defaultdict(lambda: ([], []))
    for d, s in zip(dst, src):
        groups[d.dtype][0].append(d)
        groups[d.dtype][1].append(s)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


class _Arena:
    """One live call's copy of its graph's ``saved`` activations."""

    def __init__(self, saved: List[torch.Tensor]):
        self.free = True
        self.bufs = [torch.empty_like(t) for t in saved]


class _Lease:
    """An arena held by one live call: given back by the call's backward, or
    when autograd drops the call's graph (and with it this lease) without
    one."""

    def __init__(self, arena: _Arena):
        self.arena = arena
        arena.free = False

    def take(self) -> _Arena:
        arena, self.arena = self.arena, None
        if arena is None:
            raise RuntimeError("a graphed Darknet call's backward ran twice; "
                               "retain_graph is not supported")
        return arena

    def __del__(self):
        if self.arena is not None:
            self.arena.free = True


class _Replay(torch.autograd.Function):
    """A train-mode call through ``graph``, its activations kept in
    ``arena``. The output and the gradients are new tensors each call (the
    gradients through an exact ``· 1.0``), so autograd may keep or sum them
    in place whatever the graph replays next."""

    @staticmethod
    def forward(ctx, graph, arena, x, *params):
        graph.x.copy_(x)
        graph.fwd.replay()
        _copy(arena.bufs, graph.saved)
        ctx.graph, ctx.lease = graph, _Lease(arena)
        return graph.out.clone()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        arena, graph = ctx.lease.take(), ctx.graph
        _copy(graph.saved, arena.bufs)
        arena.free = True
        graph.gout.copy_(gout)
        graph.bwd.replay()
        gx, *grads = graph.grads
        fresh = iter(torch._foreach_mul([g for g in grads if g is not None], 1.0))
        return (None, None, None if gx is None else gx.clone(),
                *(None if g is None else next(fresh) for g in grads))


def fold_darknet_params(cfg: DarknetConfig, state_dict: Dict[str, torch.Tensor],
                        input_std=None, eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """Fold eval-mode BatchNorm (and optionally the input ``/std``) into the
    conv weights — the classic inference transform:

        BN(conv(x)) = conv(x)·γ/√(σ²+ε) + (β − μ·γ/√(σ²+ε))

    With ``input_std`` the first conv also absorbs the ``/s`` of the input
    normalisation ``(x − m)/s`` (kernel divided per input channel); the
    caller subtracts the mean (it cannot be folded into a zero-padded conv).
    Takes an unfolded ``Darknet`` state dict and returns the state dict of
    ``Darknet(cfg, folded=True)``; same math up to float reassociation."""
    out: Dict[str, torch.Tensor] = {}
    first = None
    for i, b in _conv_blocks(cfg):
        pre = f"module_list.{i}."
        w = state_dict[pre + f"conv_{i}.weight"]
        bn = pre + f"batch_norm_{i}."
        if int(b.get("batch_normalize", "0")) and bn + "weight" in state_dict:
            scale = state_dict[bn + "weight"] / torch.sqrt(
                state_dict[bn + "running_var"] + eps)
            w = w * scale[:, None, None, None]
            bias = state_dict[bn + "bias"] - state_dict[bn + "running_mean"] * scale
        else:
            bias = state_dict[pre + f"conv_{i}.bias"]
        out[pre + f"conv_{i}.weight"] = w
        out[pre + f"conv_{i}.bias"] = bias
        first = first or pre + f"conv_{i}.weight"
    if input_std is not None and first is not None:
        s = torch.as_tensor(input_std, dtype=torch.float32, device=out[first].device)
        out[first] = out[first] / s[None, :, None, None]
    return out
