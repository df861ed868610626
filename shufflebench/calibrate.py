"""The readings that the limits of ``correct`` are set from: the
program's and the control's, at a cell's own size, over many seeds in
one process (one world on four cards).

    python3 -m shufflebench.calibrate --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3]

For each seed the driver's job is set up as a run sets it up (the
capacity chosen by the warm-up step), one more step runs, the
program's state is freed and the reference judges that step's output:
the program's reading.  For each control seed the reference's control
(``reference/<config>.py``) is put in the program's place, on the same
slice of the answer, and judged the same way: the control's reading.
Prints one JSON line per seed and kind, then one line of the largest
program reading and the smallest control reading of each number.  The
benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

from shufflebench import common, harness


def calibrate_rank(group, spec) -> List[Dict[str, object]]:
    """Every seed's readings in one rank (see the module docstring)."""
    rank, world, device, config, _traffic, driver = harness._rank_setup(
        spec, group)
    ref = common.module("reference", spec["config"])
    rows = []
    for seed in spec["seeds"]:
        job, out, _retries = harness._new_job(driver, config, seed, rank,
                                              world, group, device)
        out = None
        out = job.step()
        harness._sync(device)
        job.release()
        del job
        rows_out = int(out[0].shape[0])
        nv = ref.n_valid(out)
        (offset,) = harness._offsets(ref, [out], world, rank)
        rows.append({"seed": seed, "kind": "program",
                     "readings": ref.judge(config, seed, world, rank, out,
                                           offset, device)})
        out = None
        if seed in spec["control_seeds"]:
            ctrl = ref.control(config, seed, world, rank, offset, nv,
                               rows_out, device)
            rows.append({"seed": seed, "kind": "control",
                         "readings": ref.judge(config, seed, world, rank,
                                               ctrl, offset, device)})
            del ctrl
    return rows


def _calibrate_entry(group, spec) -> None:
    import os

    rows = calibrate_rank(group, spec)
    path = os.path.join(spec["out_dir"], f"rank{group.rank}.json")
    with open(path, "w") as f:
        json.dump(rows, f)


def calibrate(name: str, seeds, control_seeds, device: str = "cuda",
              overrides=None, prepare=None,
              cell=None) -> List[Dict[str, object]]:
    """Combined readings, one dict per (seed, kind); ``cell`` as in
    :func:`harness.run_cell`."""
    cell = cell or harness.find_cell(common.benchmark(), name)
    world = int(cell["chips"])
    config = dict(common.data("configs", cell["config"]))
    config.update(overrides or {})
    spec = {"cell": name, "config": cell["config"],
            "traffic": cell["traffic"], "seeds": list(seeds),
            "control_seeds": list(control_seeds), "device": device,
            "overrides": overrides or {}, "prepare": prepare,
            "seconds": 60.0 * (len(seeds) + len(control_seeds))}
    if world == 1:
        per_rank = [calibrate_rank(None, spec)]
    else:
        per_rank = harness.run_world(_calibrate_entry, spec, world)
    ref = common.module("reference", cell["config"])
    out = []
    for i, row in enumerate(per_rank[0]):
        readings = ref.combine([rows[i]["readings"] for rows in per_rank],
                               config, world)
        out.append({"seed": row["seed"], "kind": row["kind"],
                    "readings": readings})
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="python3 -m shufflebench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    a = p.parse_args(argv)
    harness._cache_env()
    seeds = [int(s) for s in a.seeds.split(",") if s]
    ctrl = [int(s) for s in a.control_seeds.split(",") if s]
    t0 = time.monotonic()
    rows = calibrate(a.workload, seeds, ctrl)
    lower: Dict[str, int] = {}
    upper: Dict[str, int] = {}
    for row in rows:
        print(json.dumps(row), flush=True)
        for k, v in row["readings"].items():
            if row["kind"] == "program":
                lower[k] = max(lower.get(k, v), v)
            else:
                upper[k] = min(upper.get(k, v), v)
    print(json.dumps({"workload": a.workload, "program_max": lower,
                      "control_min": upper,
                      "seconds": time.monotonic() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
