"""Record files, phase timers, spans and metric logs (the port's copy of
``write_to_record_file``, ``PhaseTimer`` and ``MetricWriter`` from
``avdn_tpu/utils/logging.py``, without the TensorBoard writer): plain-text
record lines (the reference's src/utils/logger.py), cumulative per-phase
wall timers, structured JSONL, and the span recorder.

The span recorder marks where the program's layers start and end:
``with span("sim.oracle"): ...``. Off (the default) ``span`` returns one
shared no-op context after a single flag check. On (``enable()``), each
span keeps its name, its start and end from ``time.time_ns()`` (the clock
``torch.profiler``'s records carry, so spans line up with the card's
launches and kernels), its id, the span that caused it (the innermost span
open on the same thread), its thread (``threading.get_native_id()``, and
``threading.get_ident()``) and its root: the id of the outermost span open
on its thread, or, on a thread with no open span, of the root span most
recently opened and still open on any thread, so that the spans of one
train step or one validation pass share one root. ``drain()`` returns the
finished spans and clears the store; nothing is written on the hot path.
A finished span is stored as numbers in one flat array, so recording
allocates no object the garbage collector tracks and keeps.
"""

from __future__ import annotations

import itertools
import json
from array import array
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional


class Span(NamedTuple):
    id: int
    parent: int        # 0: no span open on the thread
    root: int
    name: str
    thread: int        # threading.get_native_id()
    ident: int         # threading.get_ident()
    start_ns: int      # time.time_ns()
    end_ns: int


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_on = False
_lock = threading.Lock()
_ints = array("q")              # id, parent, root, thread, ident, start, end a span
_names: List[str] = []
_roots: List[int] = []          # root spans open now, in the order they opened
_ids = itertools.count(1)
_local = threading.local()      # .stack of open spans, .ids (native id, ident)


class _Open:
    """An open span (the recorder was on when it was entered)."""

    __slots__ = ("name", "id", "parent", "root", "start_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
            _local.ids = (threading.get_native_id(), threading.get_ident())
        self.id = next(_ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent = 0
            self.root = _roots[-1] if _roots else self.id
            if self.root == self.id:
                _roots.append(self.id)
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        _local.stack.pop()
        if self.root == self.id:
            _roots.remove(self.id)
        thread, ident = _local.ids
        with _lock:
            _ints.extend((self.id, self.parent, self.root, thread, ident, self.start_ns,
                          end_ns))
            _names.append(self.name)
        return False


def span(name: str):
    """A context that records the enclosed block as the span ``name`` when
    the recorder is on, and does nothing otherwise."""
    if not _on:
        return _NO_SPAN
    return _Open(name)


def enable() -> None:
    """Turn the span recorder on."""
    global _on
    _on = True


def disable() -> None:
    """Turn the span recorder off (spans still open are recorded when they
    close)."""
    global _on
    _on = False


def drain() -> List[Span]:
    """The finished spans, in the order they closed; the store is cleared."""
    global _ints, _names
    with _lock:
        ints, names, _ints, _names = _ints, _names, array("q"), []
    return [Span(*ints[7 * i:7 * i + 3], name, *ints[7 * i + 3:7 * i + 7])
            for i, name in enumerate(names)]


def write_to_record_file(data: str, file_path: Optional[str], verbose: bool = True):
    if verbose:
        print(data)
    if file_path:
        with open(file_path, "a") as f:
            f.write(data + "\n")


class PhaseTimer:
    """Cumulative per-phase wall timers: ``with timer("render"): ...``;
    ``timer.summary()`` reports totals and shares. Safe across threads.
    With the span recorder on, each phase is also a span, named ``span``
    where given, else by the phase."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    class _Ctx:
        __slots__ = ("timer", "name", "span", "t0")

        def __init__(self, timer, name, span_name):
            self.timer, self.name, self.span = timer, name, span(span_name)

        def __enter__(self):
            self.span.__enter__()
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            self.span.__exit__(*exc)
            with self.timer._lock:
                self.timer.totals[self.name] += dt
                self.timer.counts[self.name] += 1

    def __call__(self, name: str, span: Optional[str] = None) -> "PhaseTimer._Ctx":
        return PhaseTimer._Ctx(self, name, span or name)

    def summary(self) -> str:
        total = sum(self.totals.values()) or 1.0
        parts = [
            f"{k}: {v:.2f}s ({100 * v / total:.0f}%, n={self.counts[k]})"
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        return "; ".join(parts)


class MetricWriter:
    """Record-file + JSONL scalar writer."""

    def __init__(self, log_dir: str, record_name: str = "train.txt"):
        os.makedirs(log_dir, exist_ok=True)
        self.record_path = os.path.join(log_dir, record_name)
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")

    def scalars(self, step: int, values: Dict[str, float]):
        rec = {"step": step, **{k: float(v) for k, v in values.items()}}
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def text(self, line: str):
        write_to_record_file(line, self.record_path)
