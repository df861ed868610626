"""Each cell, briefly, on the card: ``python3 -m shufflebench`` at a
short window prints a correct result line.  Skips without enough
cards; run on the card with ``python -m pytest shufflebench/tests -m
gpu``."""

import json
import subprocess
import sys

import pytest

from shufflebench import common

CELLS = [(w["name"], w["chips"]) for w in common.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell,chips", CELLS)
def test_cell_runs_on_the_card(cell, chips):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} CUDA card(s)")
    r = subprocess.run(
        [sys.executable, "-m", "shufflebench", "--workload", cell, "--seed",
         str(2 ** 31 + 5), "--seconds", "2", "--trace", "1"],
        cwd=str(common.ROOT), capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == chips
    assert line["device"]["busy_s"] > 0
