"""Torch counterpart of ``avdn_tpu/rollout``."""
