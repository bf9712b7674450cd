"""The program's own spans (``avdn_tpu_torch/utils/logging.py``) laid over
the device trace: each cell's kernel launches and idle device time put down
to the layer of the port that caused them.

One more traced session (:func:`session`) runs the cell's units with the
port's span recorder on, recording the device and the CUDA runtime only (no
host ops), after the cell's own traced sessions, whose input it leaves as it
was. The spans carry ``time.time_ns()`` stamps, the clock of the profiler's
records (:func:`clock_proof` checks that on the card), and their thread.

Attribution (:func:`attribute`):
- a runtime call (a launch, a copy, a set) goes to the innermost span open
  on its own thread at its start; from a thread with no open span, to the
  innermost span open at that instant on the root thread, the thread that
  ran the units (so autograd's device thread lands in ``train.backward``);
  else to ``(no span)``;
- a kernel record is counted where its runtime launch went;
- each idle gap of the device inside the window goes where the runtime call
  of the device op that ends it went; the gap after the last device op goes
  to ``(window end)``;
- a span is counted in the group of its nearest enclosing span that
  :data:`GROUPS` names (a phase timer's span inside ``data.prepare`` counts
  as data), else in ``other``.

On the card a runtime record's ``start_thread_id()`` is the same for every
thread; its ``device_resource_id()`` names the thread, as its native id or
as its ``get_ident()``'s low 32 bits, signed or not. A record is matched to
a span's thread by any of these (:func:`thread_map`); a record no span
thread matches (autograd's device thread) goes by time to the root thread,
as does every record where none matches (``SpanTrace.thread_map`` says
which).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import sys
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

#: group -> the span names whose own time it holds
GROUPS: Dict[str, Tuple[str, ...]] = {
    "sim": ("sim.render", "sim.dynamics"),
    "oracle": ("sim.oracle",),
    "models": ("models.bert", "models.darknet", "models.trunk"),
    "rollout": ("rollout",),
    "backward": ("train.backward",),
    "optim": ("train.optim",),
    "data": ("data.wait", "data.prepare"),
    "valid": ("valid.pass", "valid.nav", "valid.ha", "valid.metrics"),
    "step": ("train.step", "train.language"),
}
_GROUP_OF = {name: g for g, names in GROUPS.items() for name in names}
NO_SPAN = "(no span)"
WINDOW_END = "(window end)"
OTHER = "other"


@dataclasses.dataclass
class SpanTrace:
    units: int
    window_s: float
    idle_s: float                 # the window's idle device time
    launches: Dict[str, int]      # group -> kernel records
    idle_s_by: Dict[str, float]   # group -> idle seconds
    thread_map: str               # how runtime threads were matched to spans'
    spans: int                    # spans recorded in the window
    launches_by_span: Dict[str, int]     # innermost span name -> kernel launches
    idle_s_by_span: Dict[str, float]     # innermost span name -> idle seconds


#: the fields of a runtime record that may name its thread
TID_FIELDS = ("device_resource_id", "start_thread_id")


@dataclasses.dataclass(frozen=True)
class Call:
    """A CUDA runtime call: its thread as each of :data:`TID_FIELDS` of the
    profiler's record gives it, and when it started and ended (ns)."""
    tids: Tuple[int, ...]
    start_ns: int
    end_ns: int = 0


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    start_ns: int
    end_ns: int
    call: Optional[Call]   # the runtime call that enqueued it, where found
    kernel: bool           # a kernel (not a copy or a set)


class _Timeline:
    """The innermost open span at any instant on one thread (spans on a
    thread nest)."""

    def __init__(self, spans):
        points = []
        for s in spans:
            points.append((s.start_ns, 1, s))
            points.append((s.end_ns, 0, s))
        # at one instant, closes before opens
        points.sort(key=lambda p: (p[0], p[1], p[2].start_ns if p[1] else -p[2].start_ns))
        self.starts: List[int] = []
        self.owner: List[Optional[object]] = []
        stack = []
        for t, opening, s in points:
            if opening:
                stack.append(s)
            elif s in stack:
                stack.remove(s)
            self.starts.append(t)
            self.owner.append(stack[-1] if stack else None)

    def at(self, t_ns: int):
        i = bisect.bisect_right(self.starts, t_ns) - 1
        return self.owner[i] if i >= 0 else None


def group_of(span, by_id) -> str:
    while span is not None:
        g = "data" if span.name.startswith("data.") else _GROUP_OF.get(span.name)
        if g is not None:
            return g
        span = by_id.get(span.parent)
    return OTHER


_KINDS = ("native id", "ident", "ident, low 32 bits", "ident, low 32 bits signed")


def _thread_keys(span) -> Tuple[int, ...]:
    """The span's thread as each of :data:`_KINDS` names it."""
    low = span.ident & 0xFFFFFFFF
    return (span.thread, span.ident, low, low - (1 << 32) if low >= 1 << 31 else low)


def thread_map(spans, calls: Iterable[Call]) -> Tuple[str, int, Dict[int, int]]:
    """``(label, field, {runtime tid: native id})``: the field of the
    runtime records that names the spans' threads (by any of
    :data:`_KINDS`; a native id and a 32-bit ident do not collide) on the
    most records, the label counting the records each kind matched; field
    -1 and an empty map where none matches."""
    calls = list(calls)
    best, best_n, best_field, best_map = "time on the root thread", 0, -1, {}
    for field, field_name in enumerate(TID_FIELDS):
        m, hits = {}, collections.Counter()
        for s in spans:
            for kind, key in zip(_KINDS, _thread_keys(s)):
                m.setdefault(key, (s.thread, kind))
        for c in calls:
            if c.tids[field] in m:
                hits[m[c.tids[field]][1]] += 1
        n = sum(hits.values())
        if n > best_n:
            best_n, best_field = n, field
            best = f"{field_name} = the span's " + ", ".join(
                f"{kind} ({k} of {len(calls)})" for kind, k in hits.most_common())
            best_map = {key: native for key, (native, _) in m.items()}
    return best, best_field, best_map


def attribute(spans: Sequence, ops: Sequence[DeviceOp], launch_calls: Sequence[Call],
              w0: int, w1: int, root_thread: int, by_group: bool = True):
    """``(launches, idle_s_by, idle_s, thread_map)``: the session's kernel
    launches (runtime records), and the idle device seconds of the window
    ``[w0, w1]`` (ns), by group (or, ``by_group`` False, by the name of the
    innermost span)."""
    by_id = {s.id: s for s in spans}
    by_thread = collections.defaultdict(list)
    for s in spans:
        by_thread[s.thread].append(s)
    lines = {t: _Timeline(ss) for t, ss in by_thread.items()}
    root_line = lines.get(root_thread)
    kind, field, tid_map = thread_map(spans, launch_calls)

    def owner(call: Optional[Call]) -> str:
        if call is None:
            return NO_SPAN
        s = None
        native = tid_map.get(call.tids[field]) if field >= 0 else None
        if native is not None and native in lines:
            s = lines[native].at(call.start_ns)
        if s is None and root_line is not None:
            s = root_line.at(call.start_ns)
        if s is None:
            return NO_SPAN
        return group_of(s, by_id) if by_group else s.name

    launches = collections.Counter(owner(c) for c in launch_calls)

    busy = []
    for op in sorted(ops, key=lambda o: o.start_ns):
        a, b = max(op.start_ns, w0), min(op.end_ns, w1)
        if b < a:
            continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b, op])   # the op that starts the busy stretch
    idle = collections.defaultdict(float)
    t = w0
    for a, b, op in busy:
        if a > t:
            idle[owner(op.call)] += (a - t) / 1e9
        t = max(t, b)
    if w1 > t:
        idle[WINDOW_END] += (w1 - t) / 1e9
    return dict(launches), dict(idle), sum(idle.values()), kind


def device_ops(events) -> Tuple[List[DeviceOp], List[Call]]:
    """The device ops of a ``torch.profiler`` session's kineto events, each
    with the runtime call that enqueued it (by correlation id), and the
    runtime's kernel launch calls."""
    from harness.trace import _LAUNCH_NAMES, _kind

    runtime, gpu, launches = {}, [], []
    for e in events:
        kind = _kind(e)
        if kind == "runtime":
            call = Call(tuple(getattr(e, f)() for f in TID_FIELDS), e.start_ns(),
                        e.start_ns() + e.duration_ns())
            runtime[e.correlation_id()] = call
            if any(k in e.name() for k in _LAUNCH_NAMES):
                launches.append(call)
        elif kind == "gpu":
            gpu.append(e)
    ops = []
    for e in gpu:
        call = runtime.get(e.correlation_id()) or runtime.get(e.linked_correlation_id())
        ops.append(DeviceOp(e.start_ns(), e.start_ns() + e.duration_ns(), call,
                            not e.name().startswith(("Memcpy", "Memset"))))
    return ops, launches


def _recorder():
    """The port's span recorder, or None in a checkout that has none."""
    try:
        from avdn_tpu_torch.utils.logging import disable, drain, enable
    except ImportError:
        return None
    return enable, disable, drain


def session(fn: Callable[[], int], sync: Callable[[], None],
            attempts: int = 3, slack: float = 0.01) -> Optional[SpanTrace]:
    """``fn() -> units`` once more under ``torch.profiler`` (the device and
    the CUDA runtime) with the port's span recorder on: the
    :class:`SpanTrace` of the first session that holds a kernel record for
    all but ``slack`` of the launches the runtime recorded (the rule of
    ``harness/trace.py``'s naming session; the launches are counted from the
    runtime's records, which the card machine's sessions do not drop), or
    None (also where the port has no recorder)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rec = _recorder()
    if rec is None:
        return None
    enable, disable, drain = rec
    root = threading.get_native_id()
    for attempt in range(1, attempts + 1):
        sync()
        drain()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            enable()
            try:
                w0 = time.time_ns()
                units = fn()
                sync()
                w1 = time.time_ns()
            finally:
                disable()
        spans = drain()
        ops, calls = device_ops(prof.profiler.kineto_results.events())
        del prof
        n_kernels = sum(op.kernel for op in ops)
        complete = n_kernels > 0 and n_kernels >= (1 - slack) * len(calls)
        print(f"[spans] session {attempt} of {attempts}: {units} units, {len(spans)} "
              f"spans, {n_kernels} kernel records of {len(calls)} launches, "
              f"{'complete' if complete else 'incomplete, traced again'}", file=sys.stderr)
        if complete:
            launches, idle_by, idle, kind = attribute(spans, ops, calls, w0, w1, root)
            by_span = attribute(spans, ops, calls, w0, w1, root, by_group=False)
            torch.cuda.empty_cache()
            return SpanTrace(units=units, window_s=(w1 - w0) / 1e9, idle_s=idle,
                             launches=launches, idle_s_by=idle_by, thread_map=kind,
                             spans=len(spans), launches_by_span=by_span[0],
                             idle_s_by_span=by_span[1])
    return None


# -- what the per-layer readers read --

def launches_per_unit(rec, group: str):
    st = rec.get("spans")
    if st is None or not st.units:
        return None
    return st.launches.get(group, 0) / st.units


def idle_ms_per_unit(rec, group: str):
    st = rec.get("spans")
    if st is None or not st.units:
        return None
    return st.idle_s_by.get(group, 0.0) * 1e3 / st.units


def idle_named_pct(rec):
    """The share of the window's idle device time put down to a span, %."""
    st = rec.get("spans")
    if st is None or st.idle_s <= 0:
        return None
    named = sum(v for k, v in st.idle_s_by.items() if k not in (NO_SPAN, WINDOW_END))
    return 100.0 * named / st.idle_s


#: the per-layer metrics of each traffic kind: name -> (reader, group)
METRICS = {
    "train": {**{f"{g}.launches.train": (launches_per_unit, g)
                 for g in ("sim", "oracle", "models", "rollout")},
              **{f"{g}.idle_ms.train": (idle_ms_per_unit, g)
                 for g in ("sim", "oracle", "models", "rollout", "backward", "optim",
                           "data")},
              "spans.idle_named.train": (idle_named_pct, None)},
    "valid": {**{f"{g}.launches.valid": (launches_per_unit, g)
                 for g in ("sim", "oracle", "models", "rollout")},
              **{f"{g}.idle_ms.valid": (idle_ms_per_unit, g)
                 for g in ("sim", "oracle", "models", "rollout", "valid", "data")},
              "spans.idle_named.valid": (idle_named_pct, None)},
}


def read(rec, name: str):
    """The per-layer metric ``name`` of the run's record, or None."""
    for metrics in METRICS.values():
        if name in metrics:
            reader, group = metrics[name]
            return reader(rec) if group is None else reader(rec, group)
    raise KeyError(name)


# -- the clock and thread proof, on the card --

def clock_proof(n: int = 1000) -> dict:
    """``n`` spans, half on this thread and half on a worker thread, each
    around one kernel launch, under ``torch.profiler`` (device and runtime).
    ``share``: the launch records whose start and end lie inside their own
    span's ``time.time_ns()`` interval, on the span's thread as
    :func:`thread_map` matches it, over ``n``; ``share_by_time``: inside the
    interval alone; the thread mapping; how long after its span's start each
    record starts (µs); the records' raw thread fields; and the host's ns
    an empty span takes, the recorder off and on (``span_host_ns``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    enable, disable, drain = _recorder()
    from avdn_tpu_torch.utils.logging import span

    x = torch.zeros(1024, device="cuda")
    x.add_(1)
    torch.cuda.synchronize()

    def launch(k):
        for _ in range(k):
            with span("proof"):
                x.add_(1)

    drain()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        enable()
        try:
            launch(n // 2)
            worker = threading.Thread(target=launch, args=(n - n // 2,))
            worker.start()
            worker.join()
            torch.cuda.synchronize()
        finally:
            disable()
    spans = sorted(drain(), key=lambda s: s.start_ns)
    _, calls = device_ops(prof.profiler.kineto_results.events())
    kind, field, tid_map = thread_map(spans, calls)
    starts = [s.start_ns for s in spans]
    by_time, inside, lead = 0, 0, []
    for c in sorted(calls, key=lambda c: c.start_ns):
        i = bisect.bisect_right(starts, c.start_ns) - 1
        if i < 0 or c.end_ns > spans[i].end_ns:
            continue
        by_time += 1
        lead.append((c.start_ns - spans[i].start_ns) / 1e3)
        if field >= 0 and tid_map.get(c.tids[field]) == spans[i].thread:
            inside += 1
    lead.sort()
    def per_span_ns(on: bool, k: int = 200_000) -> float:
        (enable if on else disable)()
        t0 = time.perf_counter_ns()
        for _ in range(k):
            with span("cost"):
                pass
        dt = (time.perf_counter_ns() - t0) / k
        disable()
        drain()
        return dt

    host_ns = {"off": per_span_ns(False), "on": per_span_ns(True)}
    return {"spans": len(spans), "launch_records": len(calls), "span_host_ns": host_ns,
            "share": inside / max(len(spans), 1),
            "share_by_time": by_time / max(len(spans), 1), "thread_map": kind,
            "span_threads": sorted({(s.thread, s.ident) for s in spans}),
            "record_thread_fields": dict(zip(TID_FIELDS, zip(*sorted({c.tids for c in calls})))),
            "lead_us_min_median_max": [lead[0], lead[len(lead) // 2], lead[-1]] if lead else None}
