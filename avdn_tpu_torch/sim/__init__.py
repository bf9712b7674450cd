"""Torch counterpart of ``avdn_tpu/sim``."""
