"""Items served per batch run over the measured window: how full coalescing
makes a batch."""


def read(rec):
    return rec["items"] / rec["batches"] if rec.get("batches") else None
