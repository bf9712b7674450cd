"""The traced window: ``torch.profiler`` over some units of a cell's work,
and what the per-layer metrics read from it.

Complete-session rule (frozen from ``chip_smoke.py`` ``_profiled_sessions``,
commit d6443de, where ``torch.profiler`` on the card machine now and then
records fewer kernels than were launched): a session counts only when it
holds a kernel record for every kernel launch the host made in the window;
otherwise the window is traced again, up to ``attempts`` times.

Device busy time is the union of the device's kernel, copy and set
intervals inside the window (one device), the window the span of a
``bench.window`` annotation around the units, which ends with a device
synchronise.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

WINDOW_MARK = "bench.window"
_LAUNCH_NAMES = ("LaunchKernel", "LaunchCooperativeKernel", "cuLaunchKernel")


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    launches: int             # kernel records in the window
    units: int                # units of work the window ran
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    kernels: Dict[str, List[float]]  # kernel name -> device seconds, launch order


def _kind(e) -> str:
    """``gpu`` (a kernel, copy or set on the device), ``mark`` (an
    annotation, on either side), ``runtime`` (a CUDA runtime or driver
    call) or ``cpu`` (a host op)."""
    from torch.autograd import DeviceType

    name = e.name()
    if name == WINDOW_MARK or e.is_user_annotation():
        return "mark"
    if e.device_type() == DeviceType.CUDA:
        return "gpu"
    if name.startswith(("cuda", "cu")) and not name.startswith("cudnn"):
        return "runtime"
    return "cpu"


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def analyse(events, units: int, window_s: float, expect: Optional[dict] = None,
            slack: float = 0.0):
    """The trace of one session whose units took ``window_s`` on the host
    clock (from before the first unit to the device's synchronise after the
    last), or None where it is incomplete: fewer kernel records than the
    runtime recorded launches (less a ``slack`` share), or fewer records of
    a hand kernel than ``expect`` (kernel name -> launches the host made)
    says."""
    from torch.autograd import DeviceType

    marks = [e for e in events if e.name() == WINDOW_MARK
             and e.device_type() != DeviceType.CUDA]
    gpu, runtime, cpu = [], {}, []
    n_launch = 0
    for e in events:
        kind = _kind(e)
        if kind == "gpu":
            gpu.append(e)
        elif kind == "runtime":
            runtime[e.correlation_id()] = e
            if any(k in e.name() for k in _LAUNCH_NAMES):
                n_launch += 1
        elif kind == "cpu":
            cpu.append(e)
    if not gpu:
        return None
    # the window on the trace's clock: the host's annotation where host ops
    # were recorded, else the device's first to last activity
    if marks:
        w0 = marks[0].start_ns()
        w1 = w0 + marks[0].duration_ns()
    else:
        w0 = min(e.start_ns() for e in gpu)
        w1 = max(e.start_ns() + e.duration_ns() for e in gpu)
    kernels = [e for e in gpu if not e.name().startswith(("Memcpy", "Memset"))]
    seen = {k: sum(k in e.name() for e in kernels) for k in (expect or {})}
    print(f"[trace] window {window_s:.3f} s: {len(kernels)} kernel records, "
          f"{len(gpu) - len(kernels)} copies and sets, {n_launch} launches recorded by "
          f"the runtime, {len(cpu)} host ops; hand kernels recorded {seen} of "
          f"{expect or {}} launched", file=sys.stderr)
    if not kernels or len(kernels) < (1 - slack) * n_launch or any(
            seen[k] < n for k, n in (expect or {}).items()):
        return None
    busy = _merge([(max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(), w1))
                   for e in gpu])
    busy_ns = sum(b - a for a, b in busy)

    by_name = collections.defaultdict(float)
    per_kernel = collections.defaultdict(list)
    for e in sorted(gpu, key=lambda e: e.start_ns()):
        by_name[e.name()[:100]] += e.duration_ns() / 1e9
        per_kernel[e.name()].append(e.duration_ns() / 1e9)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # each idle gap is named by the host op that launched the work ending
    # it: the innermost op of the launching thread around that launch
    by_thread = collections.defaultdict(list)
    for e in sorted(cpu, key=lambda e: e.start_ns()):
        by_thread[e.start_thread_id()].append(e)
    starts = {tid: [e.start_ns() for e in ops] for tid, ops in by_thread.items()}
    first_gpu = {}
    for e in gpu:
        first_gpu.setdefault(e.start_ns(), e)

    def host_op(launch):
        tid, t_ns = launch.start_thread_id(), launch.start_ns()
        ops = by_thread.get(tid, [])
        i = bisect.bisect_right(starts.get(tid, []), t_ns) - 1
        for j in range(i, max(i - 400, -1), -1):
            if ops[j].start_ns() + ops[j].duration_ns() >= t_ns:
                return ops[j].name()
        return launch.name() if cpu else "(host ops not recorded)"

    gaps = collections.defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for k in range(0, len(edges), 2):
        a, b = edges[k], edges[k + 1]
        if b <= a:
            continue
        if k + 2 >= len(edges):
            name = "(window end: host after the last device op)"
        else:
            ender = first_gpu.get(b)
            launch = None
            if ender is not None:
                launch = runtime.get(ender.correlation_id()) or runtime.get(
                    ender.linked_correlation_id())
            name = host_op(launch) if launch is not None else "(no launch found)"
        gaps[name[:100]] += (b - a) / 1e9
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return Trace(window_s=window_s, busy_s=busy_ns / 1e9, launches=len(kernels),
                 units=units, device_ops=device_ops,
                 idle_gaps=idle_gaps, kernels=dict(per_kernel))


def _session(fn, sync, host: bool, expect=None, slack=0.0):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    sync()
    with profile(activities=activities) as prof:
        with record_function(WINDOW_MARK):
            t0 = time.perf_counter()
            units = fn()
            sync()
            window_s = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    tr = analyse(events, units, window_s, expect() if expect else None, slack)
    del prof, events
    torch.cuda.empty_cache()
    return tr


def traced(fn: Callable[[], int], sync: Callable[[], None],
           name_fn: Optional[Callable[[], int]] = None,
           expect: Optional[Callable[[], dict]] = None,
           attempts: int = 3) -> Optional[Trace]:
    """``fn() -> units`` under ``torch.profiler`` recording the
    device and the CUDA runtime (not host ops, whose recording slows the
    host severalfold), its units inside a ``bench.window`` annotation that
    ends with ``sync()``: the first complete session's :class:`Trace`, or
    None. Then ``name_fn`` (a shorter run of the same work) once more with
    the host ops recorded too, which names the idle gaps by the host op
    that launched the work ending each (the breakdown only)."""
    for attempt in range(1, attempts + 1):
        t0 = time.perf_counter()
        tr = _session(fn, sync, host=False, expect=expect)
        print(f"[trace] session {attempt} of {attempts}: {tr.units if tr else '?'} units in "
              f"{time.perf_counter() - t0:.1f} s, "
              f"{'complete' if tr is not None else 'incomplete, traced again'}",
              file=sys.stderr)
        if tr is not None:
            break
    if tr is not None and name_fn is not None:
        t0 = time.perf_counter()
        # the names only: a session that lost a record or two still names
        named = _session(name_fn, sync, host=True, slack=0.01)
        print(f"[trace] naming session with host ops: {time.perf_counter() - t0:.1f} s, "
              f"{'complete' if named is not None else 'incomplete: gaps left unnamed'}",
              file=sys.stderr)
        if named is not None:
            tr.idle_gaps = named.idle_gaps
    return tr
