"""Frozen copy of ``check_family`` from ``avdn_tpu_torch/config.py`` (commit
d6443de)."""

FAMILIES = ("et", "lstm")


def check_family(family: str) -> None:
    """Raise ``ValueError`` for a ``--family`` that is not in :data:`FAMILIES`."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family: {family} (choose 'et' or 'lstm')")
