# Frozen copy of avdn_tpu_torch/parallel/batch.py at commit d6443de, its imports pointed
# at the reference package.
"""Reductions over the global batch of a data-parallel train step.

The JAX package's multi-process train step is one SPMD program over the
global batch (process_count × ``--batch_size`` items), so every reduction
over the batch inside it is global: the BatchNorm statistics, the ET
readout's batch-max valid step, the step loop's "every item has ended"
test, and every random draw over the batch (the loss's heading jitter and
the dropout masks come from one key over the global shape). Here each rank
holds its own slice of that batch; inside :func:`global_batch` the helpers
below make those reductions global with ``torch.distributed`` collectives,
so P ranks of B items compute what one process computes at P·B.

Outside the context (single-process runs, evaluation, serving) every
helper is the local operation and issues no collective. The active group
is a module-level value, not a context variable, because the autograd
engine runs the backward pass, and with it a rematerialised forward, on
its own device threads.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

_group: Optional[object] = None  # the data-parallel group while a train step runs


@contextlib.contextmanager
def global_batch(group):
    """Inside, batch reductions span every rank of ``group`` (a process
    group, or ``dist.group.WORLD``)."""
    global _group
    outer, _group = _group, group
    try:
        yield
    finally:
        _group = outer


def active() -> bool:
    return _group is not None


class _AllReduceSum(torch.autograd.Function):
    """All-reduce SUM whose backward is the all-reduce SUM of the gradient
    (the role of ``torch.distributed.nn.functional.all_reduce``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably (identity outside
    :func:`global_batch`)."""
    if _group is None:
        return x
    return _AllReduceSum.apply(x, _group)


def batch_max(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max of ``x`` over the ranks (no gradient)."""
    if _group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=_group)
    return y


def batch_all(x: torch.Tensor) -> torch.Tensor:
    """``x.all()`` over every rank's ``x``: a 0-d bool."""
    local = x.all()
    if _group is None:
        return local
    flag = local.to(torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=_group)
    return flag.bool()


def batch_rand(shape, generator: torch.Generator, device) -> torch.Tensor:
    """``torch.rand(shape)`` for a tensor whose leading dimension is this
    rank's slice of the batch, item-major. Inside :func:`global_batch` it
    draws the global shape (ranks × the leading dimension) and returns this
    rank's rows, so with the same generator state on every rank the ranks'
    draws together equal one process's draw over the global batch. Every
    train-mode draw is item-major (the time-major readout of
    ``et_fast.teacher_onepass`` runs in eval only, with no generator);
    ``tests/test_torch_parallel.py`` holds two ranks with dropout on to one
    process."""
    if _group is None:
        return torch.rand(shape, generator=generator, device=device)
    world, rank = dist.get_world_size(_group), dist.get_rank(_group)
    n = shape[0]
    full = torch.rand((world * n, *shape[1:]), generator=generator, device=device)
    return full[rank * n:(rank + 1) * n]
