"""Torch counterpart of ``avdn_tpu/cli``."""
