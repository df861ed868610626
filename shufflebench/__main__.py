"""``python3 -m shufflebench``: one run of one cell (``harness.py``)."""

import time

T0 = time.monotonic()  # the start of set-up

import sys  # noqa: E402

from shufflebench.harness import command  # noqa: E402

if __name__ == "__main__":
    sys.exit(command(sys.argv[1:], T0))
