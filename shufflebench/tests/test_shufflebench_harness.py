"""The harness on the CPU at tiny sizes: the result line's format, the
exits without a card or without the program, and that a cell's run
loads nothing of JAX or the JAX package and the references nothing of
the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from shufflebench import common, harness
from shufflebench.tests import sizes

ROOT = str(common.ROOT)
SEED = 2 ** 31 + 99


@pytest.mark.parametrize("cell", ["terasort.d1", "tpcds.d1"])
@pytest.mark.parametrize("traced", [False, True])
def test_result_line_format(cell, traced):
    line, notes, forbidden = harness.run_cell(
        cell, SEED, 0.3, traced, "cpu", overrides=sizes.CELLS[cell])
    assert forbidden == []
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    d = line["device"]
    assert d["count"] == 1 and d["memory_peak_bytes"] == 0
    want = {m["name"] for m in harness.metric_specs(
        common.benchmark(), harness.find_cell(common.benchmark(), cell),
        traced)}
    # the device readers find nothing on the CPU and are left out
    assert set(line["metrics"]) <= want
    if not traced:
        assert set(line["metrics"]) == {"shuffle_gbps", "step_p95_ms",
                                        "setup_s"}
    else:
        assert "host_ms" in line["metrics"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    ref = common.module("reference",
                        harness.find_cell(common.benchmark(), cell)["config"])
    assert line["checks"] == {k: {"value": 0, "limit": v}
                              for k, v in ref.LIMITS.items()}
    assert notes[0].startswith(f"# cell {cell} seed {SEED}")
    json.dumps(line)


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "shufflebench", "--workload", "terasort.d1",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {})))


def test_no_card_exits_without_a_result():
    r = _cli(ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr


def test_benchmark_files_alone_exit_without_a_result(tmp_path):
    shutil.copy(common.BENCHMARK_JSON, tmp_path / "BENCHMARK.json")
    shutil.copytree(common.BENCH_DIR, tmp_path / "shufflebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _cli(str(tmp_path), env={"PYTHONPATH": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_program_missing_is_refused(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(harness, "PROGRAM", "no_such_program_here")
    rc = harness.main(["--workload", "terasort.d1", "--seed", "1",
                       "--seconds", "1", "--trace", "0"], 0.0)
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""


def test_too_few_cards_is_refused(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = harness.main(["--workload", "terasort.d4", "--seed", "1",
                       "--seconds", "1", "--trace", "0"], 0.0)
    assert rc == 3 and capsys.readouterr().out == ""


CELL_RUN = """
import json, sys
from shufflebench import harness
from shufflebench.tests import sizes
for cell in ("terasort.d1", "tpcds.d1"):
    harness.run_cell(cell, 5, 0.2, True, "cpu", overrides=sizes.CELLS[cell])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE_RUN = """
import json, sys
from shufflebench import common
from shufflebench.tests import sizes
for name, small in (("hibench_terasort", sizes.TERASORT),
                    ("tpcds_sf100", sizes.TPCDS)):
    cfg = dict(common.data("configs", name), **small)
    ref = common.module("reference", name)
    n = cfg.get("records_per_card", 0)
    out = ref.control(cfg, 5, 1, 0, 0, n, n, "cpu")
    ref.combine([ref.judge(cfg, 5, 1, 0, out, 0, "cpu")], cfg, 1)
import shufflebench.kernels, shufflebench.peaks
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_modules(code):
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_cells_load_no_jax_and_references_no_program():
    loaded = _top_modules(CELL_RUN)
    assert "sparkrdma_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "sparkrdma_tpu"}
    loaded = _top_modules(REFERENCE_RUN)
    assert not loaded & {"sparkrdma_tpu_torch", "jax", "jaxlib", "flax",
                         "sparkrdma_tpu"}


WORLD_RUN = """
import json, signal
from shufflebench import harness
from shufflebench.tests import sizes
if __name__ == "__main__":
    harness._prctl(harness._PR_SET_CHILD_SUBREAPER, 1)
    line, _, _ = harness.run_cell("terasort.d4", 5, 0.2, False, "cpu",
                                  overrides=sizes.TERASORT,
                                  cell=sizes.D4_CELL)
    before = harness._child_pids()
    waited = harness.stop_children()
    print(json.dumps([line["correct"], before, waited,
                      harness._child_pids()]))
"""


def test_a_world_run_leaves_no_process(tmp_path):
    """A four-rank world leaves multiprocessing's resource tracker
    running until its parent exits; ``stop_children`` stops it and
    waits, so nothing of the run outlives the result."""
    script = tmp_path / "world_run.py"
    script.write_text(WORLD_RUN)
    r = subprocess.run([sys.executable, str(script)], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    correct, before, waited, after = json.loads(
        r.stdout.strip().splitlines()[-1])
    assert correct is True
    assert set(before) <= set(waited)
    assert after == []
