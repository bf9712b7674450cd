"""The Navigator's dispatch phase (enqueueing a batch's rollout) per batch over
the measured window, ms (nav.timers)."""


def read(rec):
    return rec["dispatch_s"] / rec["batches"] * 1e3 if rec.get("batches") else None
