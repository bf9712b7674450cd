"""Torch counterpart of ``avdn_tpu/train``."""
