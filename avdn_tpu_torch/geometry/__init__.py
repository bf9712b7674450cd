"""Torch counterpart of ``avdn_tpu/geometry``."""
