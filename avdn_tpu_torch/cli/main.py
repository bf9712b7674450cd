"""Unified CLI entry point (torch counterpart of ``avdn_tpu/cli/main.py``,
mirroring src/xview_et/main.py:290-314).

``--inference True`` runs the validation driver (``train.loop.valid``) on
the card; training is ROADMAP.md queue 1 item 10 and raises.
"""

from __future__ import annotations

import sys


def main(argv=None, family: str = "et", device=None):
    """Parse ``argv`` and run it. ``device`` (default: the card) is where
    the driver runs; the tests pass ``"cpu"``."""
    from avdn_tpu_torch.config import parse_args
    from avdn_tpu_torch.train.loop import valid

    args = parse_args(argv, family=family)
    if args.vision_only:
        print("!!! Vision only")
    if args.language_only:
        print("!!! Language only")
    if not args.inference:
        raise NotImplementedError(
            "training is ROADMAP.md queue 1 item 10; pass --inference True to "
            "validate a checkpoint")
    return valid(args, device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
