"""Torch counterpart of ``avdn_tpu/utils``."""
