"""The port's compile entry (``sparkrdma_tpu_torch/entry.py``) on the
CPU, at its one size.

It runs on the card unless the caller asks for the CPU, so every call
here passes ``device="cpu"``.  ``entry()``'s step, at D = 1, is held
against the JAX ``make_sort_step(make_mesh(1), 8192, capacity,
sample_size=256)`` that ``__graft_entry__.entry`` builds, on the same
seeded keys, values and validity mask: sorted keys, ``n_valid`` and
``max_fill`` bit for bit, values within equal keys (the JAX sort is not
stable).
"""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkrdma_tpu.models.terasort import make_sort_step as jmake_sort_step
from sparkrdma_tpu.parallel import make_mesh
from sparkrdma_tpu_torch import entry as tentry

REPO = pathlib.Path(__file__).resolve().parent.parent


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


def test_entry_loads_neither_jax_nor_reference():
    code = (
        "import sys, sparkrdma_tpu_torch.entry\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'sparkrdma_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(REPO))
    assert r.returncode == 0, r.stdout + r.stderr
