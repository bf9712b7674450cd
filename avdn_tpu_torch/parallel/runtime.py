"""The drivers' parallel runtime (the port's counterpart of
``avdn_tpu/parallel/runtime.py``).

torch runs one process per card, so every JAX mode maps onto processes:

* **one process** (the default): one card, no process group, no collective;
* **k processes** (``AVDN_NUM_PROCESSES=k``, ``AVDN_COORDINATOR=host:port``
  of process 0, ``AVDN_PROCESS_ID=i``; one card each): ``torch.distributed``
  bootstrap, per-process dataset shards feeding a global batch of k ×
  ``--batch_size`` items (the train step's batch reductions and its mean
  gradient are global, ``parallel/batch.py``), evaluation of each process's
  shard with the prediction dicts merged, checkpoints and logs from
  process 0, and a per-step consensus on preemption.

``--world_size k > 1`` must equal the process count; in one process it
raises, naming how to launch k. The JAX package's single-process
multi-device mesh, its shardings and ``CompileSynced`` have no counterpart:
torch places nothing on a mesh and compiles nothing per process.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable

import numpy as np
import torch
import torch.distributed as dist

from avdn_tpu_torch.parallel.collectives import (
    all_gather_objects,
    init_distributed,
    process_count,
    process_index,
)


def maybe_init_distributed() -> None:
    """Join the processes of a multi-process run when ``AVDN_NUM_PROCESSES >
    1``, before anything touches a card (the process picks its card here).
    A no-op otherwise, and once joined."""
    n = int(os.environ.get("AVDN_NUM_PROCESSES", "0") or 0)
    if n > 1 and not dist.is_initialized():
        pid = os.environ.get("AVDN_PROCESS_ID")
        init_distributed(coordinator=os.environ.get("AVDN_COORDINATOR"),
                         num_processes=n,
                         process_id=None if pid is None else int(pid))


def _state_tensors(state) -> Iterable[torch.Tensor]:
    """The tensors of a ``TrainState`` (models and optimizer moments) or of a
    sequence of modules, in a fixed order."""
    models = state.models() if hasattr(state, "models") else state
    for m in models:
        yield from m.state_dict().values()
    for opt in (state.optimizers() if hasattr(state, "optimizers") else ()):
        yield from opt.mu
        yield from opt.nu


@dataclasses.dataclass
class ParallelRuntime:
    """Who this process is among the run's processes."""

    process_index: int = 0
    process_count: int = 1

    @property
    def is_main(self) -> bool:
        return self.process_index == 0

    @property
    def multiprocess(self) -> bool:
        return self.process_count > 1

    @property
    def group(self):
        """The process group of the global batch, or None in one process."""
        return dist.group.WORLD if self.multiprocess else None

    def sync_bank_growth(self, bank) -> None:
        """Grow every process's map bank to the largest slot shape any of
        them needs, so the processes hold banks of one shape. A collective:
        every process calls it at the same point."""
        if not self.multiprocess:
            return
        shapes = all_gather_objects(tuple(bank.bank_hw))
        bank.grow_to(max(h for h, _ in shapes), max(w for _, w in shapes))

    def assert_replicas_identical(self, state, what: str = "state") -> None:
        """Raise unless every process holds the same parameters, BatchNorm
        statistics and optimizer moments (each tensor's float64 sum compared
        across processes): a divergent resume would otherwise train split
        replicas silently."""
        if not self.multiprocess:
            return
        fp = np.asarray([float(t.detach().double().sum()) for t in _state_tensors(state)])
        rows = all_gather_objects(fp)
        for p in range(1, len(rows)):
            same = np.isclose(rows[0], rows[p], rtol=1e-12, atol=0.0, equal_nan=True)
            if not same.all():
                bad = int(np.argmin(same))
                raise RuntimeError(
                    f"replicated {what} differs between process 0 and process {p} "
                    f"(tensor {bad}: {rows[0][bad]} vs {rows[p][bad]}): all "
                    "processes must resume from the same checkpoint and share seeds")

    def any_flag(self, flag: bool) -> bool:
        """``flag`` OR-ed over the processes. A collective: every process
        calls it at the same point (the per-step preemption consensus)."""
        if not self.multiprocess:
            return flag
        return any(all_gather_objects(bool(flag)))

    def describe(self) -> str:
        if not self.multiprocess:
            return "one process"
        return (f"data parallel: {self.process_count} processes over "
                f"{dist.get_backend()}, process {self.process_index}")


def setup_runtime(args=None) -> ParallelRuntime:
    """The run's runtime: joins the processes named by ``AVDN_*`` (see
    :func:`maybe_init_distributed`), then checks ``--world_size``."""
    maybe_init_distributed()
    pc, world = process_count(), int(getattr(args, "world_size", 0) or 0)
    if world > 1 and pc == 1:
        raise ValueError(
            f"--world_size {world}: the port runs one process per card; launch "
            f"{world} processes with AVDN_NUM_PROCESSES={world}, "
            "AVDN_COORDINATOR=<host:port of process 0> and AVDN_PROCESS_ID=0.."
            f"{world - 1}")
    if world > 1 and world != pc:
        raise ValueError(f"--world_size {world} but {pc} processes joined: "
                         "--world_size must equal the process count")
    return ParallelRuntime(process_index=process_index(), process_count=pc)
