"""The port's bench (``sparkrdma_tpu_torch/bench.py``) and compile entry
(``sparkrdma_tpu_torch/entry.py``) on the CPU, at a tiny size.

Both run on the card unless the caller asks for the CPU, so every call
here passes ``device="cpu"``.  The bench's timing function runs at 2^12
records and its line is held to the repository root ``bench.py``'s
contract; a CPU time is no device number, so only the keys and the
arithmetic of the line are checked.  ``entry()``'s step, at D = 1, is
held against the JAX ``make_sort_step(make_mesh(1), 8192, capacity,
sample_size=256)`` that ``__graft_entry__.entry`` builds, on the same
seeded keys, values and validity mask: sorted keys, ``n_valid`` and
``max_fill`` bit for bit, values within equal keys (the JAX sort is not
stable).
"""

import ast
import json
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkrdma_tpu.models.terasort import make_sort_step as jmake_sort_step
from sparkrdma_tpu.parallel import make_mesh
from sparkrdma_tpu_torch import bench as tbench
from sparkrdma_tpu_torch import entry as tentry
from sparkrdma_tpu_torch.parallel.group import ExchangeGroup

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(n_records=1 << 12, n_wide=1 << 12, iters=2, warmup=1)


_OPS = {ast.LShift: lambda a, b: a << b, ast.Mult: lambda a, b: a * b}


def _const(node):
    """A number, or a shift or product of numbers; else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value,
                                                     (int, float)):
        return node.value
    if isinstance(node, ast.BinOp) and type(node.op) in _OPS:
        a, b = _const(node.left), _const(node.right)
        if a is not None and b is not None:
            return _OPS[type(node.op)](a, b)
    return None


def _root_bench_constants():
    """The module-level numeric constants of the root ``bench.py``, read
    without importing it."""
    tree = ast.parse((REPO / "bench.py").read_text())
    return {node.targets[0].id: _const(node.value) for node in tree.body
            if isinstance(node, ast.Assign) and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)}


def test_bench_shapes_are_the_root_bench_shapes():
    root = _root_bench_constants()
    assert tbench.BASELINE_GBPS == root["BASELINE_GBPS"] == 12.5
    assert tbench.N_RECORDS == root["N_RECORDS"] == 1 << 24
    assert tbench.N_WIDE == root["N_WIDE"] == 1 << 22
    assert tbench.WIDE_WORDS == root["WIDE_WORDS"] == 24
    assert (tbench.WARMUP, tbench.ITERS) == (root["WARMUP"], root["ITERS"])


def test_bench_line_keeps_the_contract():
    comment, record = tbench.run(device="cpu", **TINY)
    assert comment.startswith(
        "# terasort 8B-record shape (4096 records, 1 card(s) cpu")
    line = json.loads(json.dumps(record))
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"].startswith(
        "terasort shuffle+sort throughput per chip, HiBench 100B records "
        "(4096 records, 1 card(s) cpu")
    assert line["unit"] == "GB/s/chip"
    assert line["value"] > 0
    assert line["vs_baseline"] == line["value"] / 12.5


def test_bench_wide_retries_with_more_capacity(monkeypatch):
    """A bucket overflow at factor 1.3 re-runs the wide step at 2.0."""
    seen = []

    def overflowed(sorter, max_fill, cap):
        seen.append(cap)
        return len(seen) == 1

    monkeypatch.setattr(tbench.TeraSorter, "_overflowed", overflowed)
    gbps, factor = tbench.bench_wide(ExchangeGroup(device="cpu"), 1 << 10,
                                     3, iters=1, warmup=1)
    assert factor == 2.0 and gbps > 0 and len(seen) == 2
    assert seen[1] > seen[0]


def test_bench_raises_when_the_wide_path_fails(monkeypatch, capsys):
    """No fallback record: an overflow at every factor raises and prints
    nothing."""
    monkeypatch.setattr(tbench.TeraSorter, "_overflowed", lambda *a: True)
    with pytest.raises(RuntimeError, match="overflowed even at capacity"):
        tbench.run(device="cpu", **TINY)
    assert capsys.readouterr().out == ""


def test_bench_raises_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbench.main()
    assert capsys.readouterr().out == ""


def test_entry_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.entry()


def test_entry_args_are_the_graft_entry_draws():
    _fn, (keys, vals, valid) = tentry.entry(device="cpu")
    rng = np.random.default_rng(0)
    want_k = rng.integers(0, 1 << 31, size=8192, dtype=np.int32)
    want_v = rng.integers(0, 1 << 31, size=8192, dtype=np.int32)
    for t in (keys, vals, valid):
        assert t.device.type == "cpu" and t.dtype == torch.int32
    np.testing.assert_array_equal(keys.numpy(), want_k)
    np.testing.assert_array_equal(vals.numpy(), want_v)
    assert bool((valid == 1).all()) and valid.shape == (8192,)


def test_entry_step_matches_jax_sort_step():
    fn, args = tentry.entry(device="cpu")
    gk, gv, gn, gf = (x.numpy() for x in fn(*args))
    capacity = ((8192 // 1 * 2) + 7) // 8 * 8
    jfn = jmake_sort_step(make_mesh(1), 8192, capacity, sample_size=256)
    wk, wv, wn, wf = (np.asarray(x).reshape(-1) for x in jfn(
        *(jnp.asarray(a.numpy()) for a in args)))
    assert gk.shape == wk.shape == (capacity,)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(gf, wf)
    nv = int(gn[0])
    assert nv == 8192 and (np.diff(gk[:nv]) >= 0).all()
    got = sorted(zip(gk[:nv].tolist(), gv[:nv].tolist()))
    assert got == sorted(zip(wk[:nv].tolist(), wv[:nv].tolist()))


def test_bench_and_entry_load_neither_jax_nor_reference():
    code = (
        "import sys, sparkrdma_tpu_torch.bench, sparkrdma_tpu_torch.entry\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'sparkrdma_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(REPO))
    assert r.returncode == 0, r.stdout + r.stderr
