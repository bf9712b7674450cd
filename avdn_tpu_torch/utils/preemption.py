"""Preemption-safe shutdown — save a checkpoint on SIGTERM, exit cleanly
(the port's copy of ``avdn_tpu/utils/preemption.py``).

The reference has no failure/elastic story at all (SURVEY.md §5: only cold
``--resume_file`` restarts); a preempted run loses everything since the last
interval checkpoint — on the real dataset an interval is a full epoch
(~1.5k steps). Accelerator capacity is routinely preemptible (spot/maintenance
events deliver SIGTERM with a short grace window), so the production driver
treats preemption as a first-class event:

* a ``PreemptionGuard`` installs a SIGTERM handler that only sets a flag
  (async-signal-safe — no I/O, no device calls in the handler);
* the train loop polls the flag once per step; when set it saves
  ``latest_dict_{step}`` synchronously, logs, and returns;
* with ``--resume_file latest`` (auto-resume) the relaunched job continues
  from that exact step — preemption costs at most one step of work.

In a multi-process run the train loop ORs the processes' flags every step
(``parallel/runtime.py:ParallelRuntime.any_flag``), so a SIGTERM to any
process stops all of them at the same step.
"""

from __future__ import annotations

import signal
from typing import Optional


class PreemptionGuard:
    """Flag-setting signal trap with handler restore.

    Usage::

        guard = PreemptionGuard().install()
        ...
        if guard.triggered:       # polled, never raises
            save_and_exit()
        ...
        guard.uninstall()
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self.triggered = False
        self._signals = tuple(signals)
        self._previous: Optional[dict] = None

    def _handler(self, signum, frame):  # async-signal-safe: flag only
        self.triggered = True

    def install(self) -> "PreemptionGuard":
        """Install the handlers (main thread only — a Python limitation).
        Safe to call once; returns self for chaining."""
        if self._previous is None:
            self._previous = {}
            for s in self._signals:
                self._previous[s] = signal.signal(s, self._handler)
        return self

    def uninstall(self) -> None:
        """Restore whatever handlers were installed before us."""
        if self._previous is not None:
            for s, prev in self._previous.items():
                signal.signal(s, prev)
            self._previous = None

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
