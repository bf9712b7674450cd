"""Process bootstrap and host-side collectives on ``torch.distributed`` (the
port's counterpart of ``avdn_tpu/parallel/collectives.py``).

The JAX package joins processes through ``jax.distributed`` and exchanges
host values with ``multihost_utils.process_allgather``; here one
``init_process_group`` (NCCL with a card, gloo on the CPU) and
``all_gather_object``. Every group is created with an explicit ``timeout``,
so a lost rank fails the run instead of hanging it. The reductions inside
the train step over the global batch are ``parallel/batch.py``.
"""

from __future__ import annotations

import datetime
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

#: seconds a rendezvous or a collective may wait for a lost rank
DEFAULT_TIMEOUT_S = 600.0


def multiprocess() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join ``num_processes`` processes through the TCP rendezvous at
    ``coordinator`` (``host:port``, served by process 0) as ``process_id``,
    and return the process index. With a card, the process first takes card
    ``process_id`` modulo the visible card count: one process per card (on
    several hosts, number the processes host by host). A single process
    joins nothing. ``backend`` defaults to NCCL with a card and gloo
    without one (two processes on one card need gloo: NCCL refuses them)."""
    if dist.is_initialized():
        return dist.get_rank()
    if not num_processes or num_processes <= 1:
        return 0
    if coordinator is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator's host:port "
                         "(AVDN_COORDINATOR) and this process's index "
                         "(AVDN_PROCESS_ID)")
    if torch.cuda.is_available():
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank()


def barrier() -> None:
    if multiprocess():
        dist.barrier()


def all_gather_objects(obj: Any) -> List[Any]:
    """Every process's picklable ``obj``, in process order."""
    if not multiprocess():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def all_gather_metrics(local: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every process's scalar metric dict (values as floats)."""
    keys = sorted(local)
    return [dict(zip(keys, row)) for row in
            all_gather_objects([float(local[k]) for k in keys])]


def merge_prediction_dicts(local_preds: Dict[str, Any]) -> Dict[str, Any]:
    """The union of the processes' prediction dicts (keyed by instr_id);
    wrap-around duplicates overwrite by key, as in one process's eval
    (agent.py:204-206)."""
    merged: Dict[str, Any] = {}
    for preds in all_gather_objects(local_preds):
        merged.update(preds)
    return merged


def reduce_mean_metrics(local: Dict[str, float]) -> Dict[str, float]:
    """Metrics averaged over the processes (reference ``reduce_dict``,
    src/utils/distributed.py:133-157)."""
    rows = all_gather_metrics(local)
    return {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
