"""avdn_tpu_torch — the PyTorch / CUDA port of ``avdn_tpu`` for NVIDIA Hopper.

A package of its own beside the JAX reference: it imports ``torch`` and
never ``jax``, ``flax`` or ``avdn_tpu``. Its layout mirrors ``avdn_tpu``
module for module. Entry points run on the card unless the caller passes
``device="cpu"``; each hand-written kernel (``csrc/``) has a plain PyTorch
version beside it, used for CPU tensors only.
"""
