"""What the per-layer readers (``metrics/<name>.py``) share: each takes
the run's record and returns a number, or None where the run gives it
nothing to read (then the metric is left out of the line; a share of a peak
or a roofline is never reported as 0)."""

from __future__ import annotations

from harness import kernels


def idle_pct(rec):
    """The traced window's share with nothing running on the device, %."""
    tr = rec.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def launches_per_unit(rec):
    """Kernel records of the traced window per unit of work it ran."""
    tr = rec.get("trace")
    if tr is None or not tr.units:
        return None
    return tr.launches / tr.units


def mfu_pct(rec):
    """Model FLOPs of the window's work over the window's seconds, as a
    share of the card's dense peak for the run's dtype (%)."""
    peak = rec.get("peak_flops")
    if not peak or not rec.get("units") or not rec.get("window_s"):
        return None
    return 100.0 * rec["flops_per_unit"] * rec["units"] / rec["window_s"] / peak


def roofline_pct(rec, kernel):
    tr = rec.get("trace")
    if tr is None:
        return None
    share = kernels.roofline(rec.get("launches", []), tr.kernels, kernel)
    return None if share is None else 100.0 * share
