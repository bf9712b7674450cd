"""Torch counterpart of ``avdn_tpu/compat``."""
