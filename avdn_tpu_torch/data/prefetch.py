"""Host-side pipeline prefetch.

The reference's loop is fully serial: host render → H2D → forward → D2H →
host geometry, every step (SURVEY.md §3.3). Our compiled step removed the
per-step crossings; what remains on host is *batch assembly* — GeoTIFF
decode/resample on map-cache misses (``DeviceMapBank.prepare``) and numpy
batch building. ``Prefetcher`` overlaps that host work with the device step:
a producer thread builds the next batch while the device runs the current
one.

The producer owns all ``DeviceMapBank`` mutation (slot placement is
stateful), so batches must be consumed in order — which the training loop
does anyway.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Any

from avdn_tpu_torch.utils.logging import span


class Prefetcher:
    """Wrap ``(prepare_fn(item) for item in source)`` with a depth-``depth``
    background queue. Exceptions in the producer re-raise at the consumer.
    Spans: ``data.prepare`` on the producer thread around each
    ``prepare_fn``, ``data.wait`` for each time the consumer blocks on the
    queue."""

    _SENTINEL = object()

    def __init__(self, source: Iterable, prepare_fn: Callable[[Any], Any],
                 depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None

        def produce():
            try:
                for item in source:
                    with span("data.prepare"):
                        out = prepare_fn(item)
                    self._q.put(out)
            except BaseException as e:  # surface in the consumer thread
                self._err = e
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        while True:
            with span("data.wait"):
                out = self._q.get()
            if out is self._SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            yield out
