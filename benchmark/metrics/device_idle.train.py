"""Share of the traced window with no kernel, copy or set running on the
device, %."""

from harness.readers import idle_pct


def read(rec):
    return idle_pct(rec)
