"""Torch counterpart of ``avdn_tpu/ops``."""
