"""Multiple processes on ``torch.distributed``: the runtime the drivers take
(``runtime.py``), the host-side collectives (``collectives.py``) and the
train step's reductions over the global batch (``batch.py``)."""
