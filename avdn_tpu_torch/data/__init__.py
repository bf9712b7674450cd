"""Torch counterpart of ``avdn_tpu/data``."""
