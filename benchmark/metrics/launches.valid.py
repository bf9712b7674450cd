"""Kernel records an item validated (both passes) in the traced window."""

from harness.readers import launches_per_unit


def read(rec):
    return launches_per_unit(rec)
