"""Unified CLI entry point (torch counterpart of ``avdn_tpu/cli/main.py``,
mirroring src/xview_et/main.py:290-314).

Without ``--inference`` it runs the train driver (``train.loop.train``);
``--inference True`` runs the validation driver (``train.loop.valid``). Both
run on the card unless the caller passes ``device``.
"""

from __future__ import annotations

import sys


def main(argv=None, family: str = "et", device=None):
    """Parse ``argv`` and run it. ``family`` is the entry point's model
    family; ``--family`` in ``argv`` overrides it, as in the JAX package.
    ``device`` (default: the card) is where the driver runs; the tests pass
    ``"cpu"``."""
    from avdn_tpu_torch.config import parse_args
    from avdn_tpu_torch.train.loop import train, valid

    args = parse_args(argv, family=family)
    if args.vision_only:
        print("!!! Vision only")
    if args.language_only:
        print("!!! Language only")
    if not args.inference:
        return train(args, device=device)
    return valid(args, device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
