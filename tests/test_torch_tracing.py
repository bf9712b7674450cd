"""The port's span recorder (``avdn_tpu_torch/utils/logging.py``): off, a
shared no-op that records nothing; on, nesting, parents, roots and self
time, across threads; ``PhaseTimer`` built on it, exact under threads; and
the spans on the clock of ``torch.profiler``'s records."""

from __future__ import annotations

import threading
import time

import pytest
import torch

from avdn_tpu_torch.utils import logging as rec
from avdn_tpu_torch.utils.logging import PhaseTimer, span


@pytest.fixture
def recorder():
    rec.drain()
    rec.enable()
    yield rec
    rec.disable()
    rec.drain()


def test_off_the_span_is_the_shared_no_op_and_records_nothing():
    rec.disable()
    rec.drain()
    assert span("a") is span("b") is rec._NO_SPAN
    with span("a") as s:
        assert s is None
    timer = PhaseTimer()
    with timer("phase"):
        pass
    assert rec.drain() == [] and timer.counts["phase"] == 1


def test_nesting_parents_roots_and_self_time(recorder):
    with span("train.step"):
        time.sleep(0.02)
        with span("rollout"):
            with span("sim.oracle"):
                time.sleep(0.03)
    with span("train.step"):
        pass
    got = {}
    for s in recorder.drain():
        got.setdefault(s.name, []).append(s)
    (step1, step2), (roll,), (oracle,) = got["train.step"], got["rollout"], got["sim.oracle"]
    assert step1.parent == 0 and step1.root == step1.id
    assert roll.parent == step1.id and oracle.parent == roll.id
    assert roll.root == oracle.root == step1.id
    assert step2.root == step2.id != step1.id
    assert step1.start_ns <= roll.start_ns <= oracle.start_ns
    assert oracle.end_ns <= roll.end_ns <= step1.end_ns
    self_ns = (step1.end_ns - step1.start_ns) - (roll.end_ns - roll.start_ns)
    assert self_ns >= 0.02e9 and oracle.end_ns - oracle.start_ns >= 0.03e9
    assert {s.thread for s in (step1, roll, oracle)} == {threading.get_native_id()}


def test_a_span_on_another_thread_shares_the_open_root(recorder):
    seen = {}

    def work():
        with span("data.prepare"):
            with span("map_bank"):
                seen["thread"] = threading.get_native_id()

    with span("valid.pass"):
        worker = threading.Thread(target=work)
        worker.start()
        worker.join()
    spans = {s.name: s for s in recorder.drain()}
    root, prep, bank = spans["valid.pass"], spans["data.prepare"], spans["map_bank"]
    assert prep.parent == 0 and prep.root == root.id and bank.parent == prep.id
    assert bank.root == root.id and prep.thread == bank.thread == seen["thread"]
    assert prep.thread != root.thread and prep.ident != root.ident


def test_phase_timer_totals_and_counts_are_exact_across_threads(recorder, monkeypatch):
    """Each phase takes exactly 1.0 on a per-thread clock: 4 threads × 1,000
    phases give totals of exactly 4,000.0 and counts of 4,000, with a span
    each."""
    local = threading.local()

    def clock():
        local.t = getattr(local, "t", 0.0) + 1.0
        return local.t

    monkeypatch.setattr(rec.time, "perf_counter", clock)
    timer = PhaseTimer()
    start = threading.Barrier(4)

    def work():
        start.wait()
        for _ in range(1000):
            with timer("map_load"):
                pass

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert timer.counts == {"map_load": 4000}
    assert timer.totals == {"map_load": 4000.0}
    spans = recorder.drain()
    assert len(spans) == 4000 and {s.name for s in spans} == {"map_load"}
    assert len({s.thread for s in spans}) == 4


def test_a_timer_phase_records_its_span_under_the_given_name(recorder):
    timer = PhaseTimer()
    with timer("nav_eval", span="valid.nav"):
        pass
    with timer("dispatch"):
        pass
    assert [s.name for s in recorder.drain()] == ["valid.nav", "dispatch"]
    assert dict(timer.counts) == {"nav_eval": 1, "dispatch": 1}
    assert "nav_eval" in timer.summary()


def test_a_profiler_record_inside_a_span_lies_inside_its_interval(recorder):
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            with span("outer"):
                with record_function("inner"):
                    torch.ones(8).add_(1)
    spans = sorted(recorder.drain(), key=lambda s: s.start_ns)
    inner = sorted((e for e in prof.profiler.kineto_results.events()
                    if e.name() == "inner"), key=lambda e: e.start_ns())
    assert len(spans) == len(inner) == 20
    for s, e in zip(spans, inner):
        assert s.start_ns <= e.start_ns() and e.start_ns() + e.duration_ns() <= s.end_ns
