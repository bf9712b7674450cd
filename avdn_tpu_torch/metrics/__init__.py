"""Torch counterpart of ``avdn_tpu/metrics``."""
