"""Torch counterpart of ``avdn_tpu/models``."""
