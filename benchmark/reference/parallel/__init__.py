# Frozen copy of avdn_tpu_torch/parallel/__init__.py at commit d6443de, its imports pointed
# at the reference package.
"""Multiple processes on ``torch.distributed``: the runtime the drivers take
(``runtime.py``), the host-side collectives (``collectives.py``) and the
train step's reductions over the global batch (``batch.py``)."""
