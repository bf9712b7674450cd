"""``harness/spans.py`` on synthetic spans and device events: launches and
idle gaps put down to the innermost span of the launching thread, a worker
thread with no span landing in the root thread's span, ``(no span)`` and
the window end, the thread mapping, and every reader's None on an empty
record; marked ``cuda``, the clock and thread proof on the card."""

from __future__ import annotations

import pytest

from harness import spans as S

MAIN, WORKER, AUTOGRAD = 101, 102, 103


class _Span:
    def __init__(self, id, parent, name, thread, start_ns, end_ns, ident=None):
        self.id, self.parent, self.root, self.name = id, parent, 1, name
        self.thread, self.start_ns, self.end_ns = thread, start_ns, end_ns
        # a pthread id as the card machine's are: the low 32 bits read
        # negative as a signed int
        self.ident = ident if ident is not None else 0x7F12_8000_0000 + thread * 0x1000


def _call(tid, call_ns):
    """A runtime record whose first thread field names the thread; its
    second (``start_thread_id`` on the card) is the same for every thread."""
    return S.Call((tid, 1), call_ns)


def _op(start, end, tid, call_ns, kernel=True):
    return S.DeviceOp(start, end, _call(tid, call_ns), kernel)


def _attribute(spans, ops, w0, w1, root):
    calls = [op.call for op in ops if op.kernel and op.call is not None]
    return S.attribute(spans, ops, calls, w0, w1, root)


def _step_spans():
    """One train step on MAIN, 0-1000 ns: a rollout with an oracle call and
    a Darknet forward, then the backward; data.prepare on WORKER."""
    return [
        _Span(1, 0, "train.step", MAIN, 0, 1000),
        _Span(2, 1, "rollout", MAIN, 10, 500),
        _Span(3, 2, "sim.oracle", MAIN, 20, 100),
        _Span(4, 2, "models.darknet", MAIN, 200, 300),
        _Span(5, 1, "train.backward", MAIN, 600, 900),
        _Span(6, 0, "data.prepare", WORKER, 50, 150),
        _Span(7, 6, "map_bank", WORKER, 60, 70),
    ]


def test_launches_go_to_the_innermost_span_of_their_thread():
    ops = [_op(30, 40, MAIN, 25), _op(41, 45, MAIN, 26),      # oracle
           _op(210, 220, MAIN, 205),                           # darknet
           _op(400, 410, MAIN, 400),                           # rollout's own
           _op(700, 720, AUTOGRAD, 650),                       # autograd thread
           _op(730, 740, WORKER, 700),                         # worker, no span open
           _op(60, 62, WORKER, 65, kernel=False)]              # a copy in map_bank
    launches, idle, total, kind = _attribute(_step_spans(), ops, 0, 1000, MAIN)
    assert launches == {"oracle": 2, "models": 1, "rollout": 1, "backward": 2}
    calls = [op.call for op in ops if op.kernel]
    by_span = S.attribute(_step_spans(), ops, calls, 0, 1000, MAIN, by_group=False)[0]
    assert by_span == {"sim.oracle": 2, "models.darknet": 1, "rollout": 1,
                       "train.backward": 2}
    assert kind == "device_resource_id = the span's native id (5 of 6)"


def test_idle_gaps_go_to_the_launcher_of_the_op_that_ends_them():
    ops = [_op(100, 200, MAIN, 30),     # gap 0-100, launched in the oracle
           _op(250, 300, MAIN, 210),    # gap 200-250, launched in darknet
           _op(280, 320, MAIN, 220),    # overlaps: no gap of its own
           _op(350, 400, WORKER, 60),   # gap 320-350: map_bank inside data.prepare
           _op(450, 800, AUTOGRAD, 640),  # gap 400-450: the autograd thread
           _op(850, 900, 999, 1500)]    # gap 800-850: no span open then
    launches, idle, total, _ = _attribute(_step_spans(), ops, 0, 1000, MAIN)
    ns = {k: round(v * 1e9) for k, v in idle.items()}
    assert ns == {"oracle": 100, "models": 50, "data": 30, "backward": 50,
                  S.NO_SPAN: 50, S.WINDOW_END: 100}
    assert round(total * 1e9) == 380
    rec = {"spans": S.SpanTrace(units=2, window_s=1e-6, idle_s=total, launches=launches,
                                idle_s_by=idle, thread_map="native id", spans=7,
                                launches_by_span={}, idle_s_by_span={})}
    assert S.read(rec, "spans.idle_named.train") == pytest.approx(100 * 230 / 380)
    assert S.read(rec, "oracle.idle_ms.train") == pytest.approx(100e-6 / 2)
    assert S.read(rec, "oracle.launches.train") == pytest.approx(0.5)
    assert S.read(rec, "sim.launches.valid") == 0


def test_runtime_thread_ids_matched_by_ident_or_else_by_time_on_the_root_thread():
    spans = _step_spans()
    # the runtime records carry the low 32 bits of an ident as a signed int
    # (as on the card), or the whole ident
    ident = {s.thread: s.ident for s in spans}
    ops = [_op(30, 40, (ident[MAIN] & 0xFFFFFFFF) - (1 << 32), 25),
           _op(60, 70, ident[WORKER], 60)]
    launches, _, _, kind = _attribute(spans, ops, 0, 1000, MAIN)
    assert kind == ("device_resource_id = the span's ident, low 32 bits signed (1 of 2), "
                    "ident (1 of 2)")
    assert launches == {"oracle": 1, "data": 1}
    # ids that match nothing: every call by time on the root thread alone
    ops = [_op(30, 40, 7, 25), _op(60, 70, 8, 60)]
    launches, _, _, kind = _attribute(spans, ops, 0, 1000, MAIN)
    assert kind == "time on the root thread" and launches == {"oracle": 2}


def test_an_op_without_its_runtime_call_and_a_span_outside_the_table():
    spans = [_Span(1, 0, "checkpoint", MAIN, 0, 100)]
    ops = [S.DeviceOp(10, 20, None, True), _op(30, 40, MAIN, 25)]
    launches, idle, _, _ = _attribute(spans, ops, 0, 50, MAIN)
    assert launches == {S.OTHER: 1}
    assert set(idle) == {S.NO_SPAN, S.OTHER, S.WINDOW_END}


class _Event:
    """A kineto event as ``torch.profiler`` hands it over."""

    def __init__(self, name, device, start, dur, corr, tid=0):
        self._name, self._device, self._start, self._dur = name, device, start, dur
        self._corr, self._tid = corr, tid

    def name(self):
        return self._name

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._device else DeviceType.CPU

    def is_user_annotation(self):
        return False

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return 0

    def start_thread_id(self):
        return self._tid

    def device_resource_id(self):
        return self._tid


def test_device_ops_pair_each_device_op_with_its_runtime_call():
    events = [_Event("cudaLaunchKernel", False, 25, 5, 1, MAIN),
              _Event("void kernel<float>", True, 30, 10, 1),
              _Event("cudaMemcpyAsync", False, 60, 5, 2, WORKER),
              _Event("Memcpy HtoD (Pageable -> Device)", True, 62, 3, 2),
              _Event("aten::add", False, 20, 30, 0, MAIN)]
    ops, calls = S.device_ops(events)
    launch, copy = S.Call((MAIN, MAIN), 25, 30), S.Call((WORKER, WORKER), 60, 65)
    assert ops == [S.DeviceOp(30, 40, launch, True), S.DeviceOp(62, 65, copy, False)]
    assert calls == [launch]


def test_every_reader_returns_none_on_an_empty_record():
    for metrics in S.METRICS.values():
        for name in metrics:
            assert S.read({}, name) is None
    assert len(S.METRICS["train"]) == 12 and len(S.METRICS["valid"]) == 11


def test_a_checkout_without_the_recorder_gives_no_session(monkeypatch):
    monkeypatch.setattr(S, "_recorder", lambda: None)
    assert S.session(lambda: 1, lambda: None) is None


@pytest.mark.cuda
def test_the_clock_and_thread_proof_on_the_card():
    """1,000 spans, each around one kernel launch, half on a worker thread:
    at least 99 % of the runtime launch records fall inside their own span
    on the span's thread."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from harness import program

    program.modules()
    got = S.clock_proof(1000)
    assert got["spans"] == 1000 and got["share"] >= 0.99, got
