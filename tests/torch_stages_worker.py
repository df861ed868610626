"""One rank of a gloo world for tests/test_torch_stages.py.

Each rank runs one wide-record TeraSort step and one hash join step
over the world under ``torch.profiler`` (CPU activity), with the
metrics registry on, and writes ``OUT_DIR/rank<RANK>.json``: the
``sparkrdma.*`` ranges of each step's trace (name, start, duration, in
µs) and the ``exchange_bytes_total`` counters the TeraSort step added,
by ``op``.  Imports torch, numpy and ``sparkrdma_tpu_torch`` only.
"""

import json
import os
import tempfile

import numpy as np
import torch

N_LOCAL = 1 << 10
PAYLOAD_WORDS = 23
JOIN_FACT, JOIN_DIM = 256, 64


def _ranges(prof):
    """The ``sparkrdma.*`` ranges of a finished profile, by start."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return sorted([e["name"], float(e["ts"]), float(e["dur"])]
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and str(e.get("name", "")).startswith("sparkrdma."))


def run_rank(group, out_dir):
    from torch.profiler import ProfilerActivity, profile

    from sparkrdma_tpu_torch.metrics import GLOBAL_REGISTRY
    from sparkrdma_tpu_torch.models.join import make_hash_join_step
    from sparkrdma_tpu_torch.models.terasort import TeraSorter

    rng = np.random.default_rng(100 + group.rank)
    keys = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, N_LOCAL))
    payload = torch.from_numpy(rng.integers(
        0, 1 << 30, (N_LOCAL, PAYLOAD_WORDS), dtype=np.int32))
    sorter = TeraSorter(device="cpu", group=group)
    GLOBAL_REGISTRY.reset()
    GLOBAL_REGISTRY.enabled = True
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            (_sk, _sp, n_valid, _mf), cap = sorter.sort_device_wide(
                keys, payload)
        counters = {dict(c["labels"])["op"]: c["value"]
                    for c in GLOBAL_REGISTRY.snapshot()["counters"]
                    if c["name"] == "exchange_bytes_total"}
    finally:
        GLOBAL_REGISTRY.enabled = False
        GLOBAL_REGISTRY.reset()
    sort_ranges = _ranges(prof)

    cols = [torch.from_numpy(rng.integers(0, 200, JOIN_FACT,
                                          dtype=np.int32)),
            torch.from_numpy(rng.integers(0, 1000, JOIN_FACT,
                                          dtype=np.int32)),
            torch.ones(JOIN_FACT, dtype=torch.int32),
            torch.arange(JOIN_DIM, dtype=torch.int32) * group.size
            + group.rank,
            torch.arange(JOIN_DIM, dtype=torch.int32),
            torch.ones(JOIN_DIM, dtype=torch.int32)]
    step = make_hash_join_step(group.size, JOIN_FACT, JOIN_DIM,
                               2 * (JOIN_FACT + JOIN_DIM), group)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(*cols)
    out = {"rank": group.rank, "capacity": cap,
           "n_valid": int(n_valid.sum()), "counters": counters,
           "sort_ranges": sort_ranges, "join_ranges": _ranges(prof)}
    path = os.path.join(out_dir, f"rank{group.rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)
