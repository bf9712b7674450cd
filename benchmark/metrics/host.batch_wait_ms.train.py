"""Milliseconds a train step waited for its next batch from the prefetch
thread, over the measured window's steps (the harness's span around the
feed)."""


def read(rec):
    return rec["batch_wait_s"] / rec["units"] * 1e3 if rec.get("units") else None
