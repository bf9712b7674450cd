"""The benchmark's own tests: the harness and the reference at tiny width
on the CPU (the port's plain paths), and, marked ``cuda``, on the card."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for p in (os.path.dirname(BENCH), BENCH, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)
