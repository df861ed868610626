"""What every part of the benchmark shares: where its files are, how a
file of a configuration, traffic mix, driver, reference or metric is
found by name, and how a seed becomes the seed of one random stream.

Imports nothing of the program, so the plain references can use it.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
from types import ModuleType
from typing import Any, Dict

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
BENCHMARK_JSON = ROOT / "BENCHMARK.json"

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def load_json(path: pathlib.Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(BENCHMARK_JSON)


def data(kind: str, name: str) -> Dict[str, Any]:
    """``shufflebench/<kind>/<name>.json``: a configuration or a
    traffic mix."""
    return load_json(BENCH_DIR / kind / f"{name}.json")


def module(kind: str, name: str) -> ModuleType:
    """``shufflebench/<kind>/<name>.py`` as a module, loaded once per
    process.  Names may hold ``.`` and ``-``, so the file is loaded by
    its path, not by an import statement."""
    safe = name.replace(".", "_").replace("-", "_")
    modname = f"shufflebench.{kind}.{safe}"
    if modname in sys.modules:
        return sys.modules[modname]
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[modname]
        raise
    return mod


def _mix(z: int) -> int:
    """splitmix64's finalizer."""
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def stream_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed for the random stream named by ``parts`` (a rank,
    a table number) of the run seeded ``seed``: the seed and each part
    go through splitmix64's finalizer apart, so streams of one seed and
    seeds of one stream differ."""
    x = _mix(int(seed) + _GOLDEN)
    for p in parts:
        x = _mix((x ^ _mix(int(p) + 2 * _GOLDEN)) + _GOLDEN)
    return x >> 1


def generator(device, seed: int, *parts: int):
    """A ``torch.Generator`` on ``device`` seeded for one stream."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *parts))
    return g
