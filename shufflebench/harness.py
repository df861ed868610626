"""Runs one cell of ``BENCHMARK.json`` once and prints its result.

    python3 -m shufflebench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``configs/<config>.json``, its driver
``drivers/<config>.py`` and its plain reference
``reference/<config>.py``), a traffic mix (``traffic/<mix>.json``: the
warm-up, the traced steps, the steps a sample is drawn from) and its
chips, one rank each.  Per-layer and end-to-end metrics are read by
``metrics/<metric>.py``.  Nothing here names a cell, a configuration
or a metric.

One run, in each rank of the cell's world (one process per card; at
one rank the harness's own process):

1. set-up: the driver makes the rank's inputs on the card from the
   seed; warm-up steps choose the capacity factor (the next of the
   driver's factors while any rank's bucket overflowed) and run every
   shape the window runs, holding one output as the window does;
2. the window: a closed loop of steps, each timed on the host from its
   call until ``torch.cuda.synchronize()`` returns, until ``--seconds``
   have passed (at D > 1 rank 0 decides, and the ranks agree after
   every step, with any overflow); with ``--trace 1``
   ``torch.profiler`` records a few steps early in the window;
3. after the window: the peak device memory is read, the program's
   state is freed, and the reference judges the output of one step
   drawn from the seed and of the last step.

Rank 0's clock gives the step times; the metrics, the device block,
the checks (each number compared beside its limit) and ``correct`` are
printed by the process that started the run, last on standard output
as one JSON line, the checks last on standard error.

Every process a run starts is stopped and waited for before it
prints, and on every way out (``stop_children``): the ranks, and the
resource tracker that ``multiprocessing`` leaves running until its
parent exits.  A rank dies with the process that started it.

Exit codes: 0 with a result; 3 without a card (or with fewer than the
cell asks for); 2 without the program; 4 if a module of JAX or of the
JAX package was loaded; 1 on any other failure.  Only 0 prints a
result.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

from shufflebench import common
from shufflebench import trace as tracing

PROGRAM = "sparkrdma_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "sparkrdma_tpu")
CACHE_DIR = common.ROOT / ".shufflebench_cache"
# a world's collectives and the world itself fail after the window
# and this long
WORLD_SLACK_S = 280.0


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole (the port's name starts with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def find_cell(bench, name: str):
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _agree(flags, world: int, device) -> List[bool]:
    """Each host flag set on any rank (one all-reduce over the world)."""
    if world == 1:
        return [bool(f) for f in flags]
    import torch
    import torch.distributed as dist

    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32,
                     device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return [bool(v) for v in t.tolist()]


def _prepare(spec) -> None:
    """Run the ``module:function`` the caller named (tests plant
    faults in the program this way) before the driver loads."""
    if spec.get("prepare"):
        mod, fn = spec["prepare"].split(":")
        getattr(importlib.import_module(mod), fn)()


def _rank_setup(spec, group):
    import torch

    torch.set_num_threads(1)
    _prepare(spec)
    rank, world = (0, 1) if group is None else (group.rank, group.size)
    device = group.device if group is not None else \
        torch.device(spec["device"])
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    config = dict(common.data("configs", spec["config"]))
    config.update(spec.get("overrides") or {})
    traffic = common.data("traffic", spec["traffic"])
    driver = common.module("drivers", spec["config"])
    return rank, world, device, config, traffic, driver


def _new_job(driver, config, seed, rank, world, group, device,
             phases=None, t0=0.0):
    """The driver's job for ``seed``, at the first capacity factor with
    which no rank's bucket overflowed; returns (job, first output,
    overflow retries).  ``phases`` gets the time the inputs were made."""
    job = driver.Job(config, seed, rank, world, group, device)
    if phases is not None:
        _sync(device)
        phases["inputs"] = time.monotonic() - t0
    for retries, factor in enumerate(job.factors):
        if retries:
            job.use_factor(factor)
        out = job.step()
        _sync(device)
        (over,) = _agree([job.overflowed(out)], world, device)
        if not over:
            return job, out, retries
        del out
    raise RuntimeError(f"bucket overflow at every capacity factor "
                       f"{list(job.factors)}")


def _process_age() -> Optional[float]:
    """Seconds since this process started (Linux ``/proc``), or None."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def run_rank(group, spec) -> Dict[str, object]:
    """One rank's run (module docstring); returns what the process
    that prints needs, all plain data."""
    import torch

    t0 = float(spec["t0"])
    phases = {"rank_start": time.monotonic() - t0}
    age = _process_age()
    if age is not None:
        phases["process_start"] = phases["rank_start"] - age
    if "spawn" in spec:
        phases["spawn"] = spec["spawn"]
    rank, world, device, config, traffic, driver = _rank_setup(spec, group)
    seed, seconds = int(spec["seed"]), float(spec["seconds"])
    ref = common.module("reference", spec["config"])
    job, held, retries = _new_job(driver, config, seed, rank, world, group,
                                  device, phases, t0)
    phases["first_step"] = time.monotonic() - t0
    for _ in range(int(traffic["warm_steps"]) - 1):
        out = None
        out = job.step()
        _sync(device)
    out = held = None
    tracer = None
    if spec["trace"]:
        tracer = tracing.StepTracer(int(traffic["trace_first_step"]),
                                    int(traffic["trace_warmup_steps"]),
                                    int(traffic["trace_active_steps"]),
                                    device.type == "cuda")
    sample_at = random.Random(common.stream_seed(seed, 0x5A)).randrange(
        int(traffic["sample_first_steps"]))
    steps: List[float] = []
    hosts: List[List[object]] = []
    failed = 0
    kept = None
    t_window = time.monotonic()
    setup_s = t_window - t0
    phases["warm"] = setup_s
    i = 0
    try:
        while True:
            if tracer:
                tracer.before(i)
            out = None
            t_call = time.monotonic()
            with tracing.annotate(tracing.STEP):
                out = job.step()
            t_ret = time.monotonic()
            with tracing.annotate(tracing.SYNC):
                _sync(device)
            t_done = time.monotonic()
            # a traced run goes on until its trace is taken
            stop, over = _agree([t_done - t_window >= seconds and not (
                tracer and tracer.needs(i + 1)), job.overflowed(out)], world,
                device)
            traced = bool(tracer and tracer.covers(i))
            if tracer:
                tracer.after(i)
            steps.append(t_done - t_call)
            hosts.append([t_ret - t_call, traced])
            failed += over
            if i == sample_at:
                kept = out
            i += 1
            if stop:
                break
    finally:
        if tracer:
            tracer.close()
    window_s = t_done - t_window
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    info = job.info()
    job.release()
    del job
    outputs = [out] if kept is None or kept is out else [kept, out]
    kept = out = None
    readings = _judge(ref, config, seed, world, rank, outputs, device)
    return {
        "rank": rank, "world": world, "steps_s": steps, "host_s": hosts,
        "failed": failed, "window_s": window_s, "setup_s": setup_s,
        "peak_bytes": peak, "info": dict(info, overflow_retries=retries),
        "setup_phases_s": phases,
        "readings": readings, "trace": tracer.summary if tracer else None,
        "forbidden": forbidden_modules(),
        "card": torch.cuda.get_device_name(device)
        if device.type == "cuda" else "cpu",
        "bytes_per_step": int(config["bytes_per_step_per_card"]),
    }


def _offsets(ref, outputs, world: int, rank: int) -> List[int]:
    """Per output, the valid rows of the ranks before this one."""
    nvs = [ref.n_valid(o) for o in outputs]
    if world == 1:
        return [0] * len(nvs)
    import torch.distributed as dist

    every: List[Optional[List[int]]] = [None] * world
    dist.all_gather_object(every, nvs)
    return [sum(every[r][k] for r in range(rank)) for k in range(len(nvs))]


def _judge(ref, config, seed, world, rank, outputs, device):
    offsets = _offsets(ref, outputs, world, rank)
    readings = []
    for k in range(len(outputs)):
        readings.append(ref.judge(config, seed, world, rank, outputs[k],
                                  offsets[k], device))
        outputs[k] = None
    return readings


_PR_SET_PDEATHSIG = 1
_PR_SET_CHILD_SUBREAPER = 36


def _prctl(option: int, arg: int) -> None:
    """Linux ``prctl(option, arg)``; nothing where there is none."""
    try:
        import ctypes

        ctypes.CDLL(None, use_errno=True).prctl(option, arg, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def _child_pids() -> List[int]:
    """The pids whose parent is this process (Linux ``/proc``)."""
    me, pids = os.getpid(), []
    try:
        names = os.listdir("/proc")
    except OSError:
        return pids
    for name in names:
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        if ppid == me:
            pids.append(int(name))
    return pids


def stop_children() -> List[int]:
    """Stop every process this one started, and those orphaned under
    it (it is their subreaper, ``command``), and wait for each to end:
    ``multiprocessing``'s resource tracker as ``multiprocessing`` stops
    it (it unlinks what it tracks), then any other child killed.
    Returns the pids waited for."""
    import gc

    gc.collect()  # a queue's semaphores unregister when collected
    waited: List[int] = []
    rt = sys.modules.get("multiprocessing.resource_tracker")
    tracker = getattr(rt, "_resource_tracker", None)
    pid = getattr(tracker, "_pid", None)
    if pid is not None:
        try:
            tracker._stop()
            waited.append(pid)
        except (AttributeError, OSError):
            pass
    for _ in range(100):
        pids = _child_pids()
        if not pids:
            break
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            try:
                os.waitpid(pid, 0)
            except ChildProcessError:
                pass
            waited.append(pid)
    return waited


def _rank_entry(group, spec) -> None:
    """A rank of a world: run and leave the result for the parent.  The
    rank is killed if its parent dies first."""
    import multiprocessing

    _prctl(_PR_SET_PDEATHSIG, signal.SIGKILL)
    parent = multiprocessing.parent_process()
    if parent is not None and os.getppid() != parent.pid:
        os._exit(1)  # the parent died before the line above
    res = run_rank(group, spec)
    path = os.path.join(spec["out_dir"], f"rank{group.rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(res, f)
    os.replace(path + ".tmp", path)


def run_world(target, spec, world: int) -> List[Dict[str, object]]:
    """``target(group, spec)`` in each rank of a new world of ``world``
    processes (the port's ``spawn_world``: NCCL on cards 0 .. world - 1,
    gloo on the CPU); returns what each rank left in its file."""
    from sparkrdma_tpu_torch.entry import spawn_world

    out_dir = tempfile.mkdtemp(prefix="shufflebench_world_")
    try:
        spec = dict(spec, out_dir=out_dir)
        if "t0" in spec:
            spec["spawn"] = time.monotonic() - float(spec["t0"])
        timeout = float(spec.get("seconds", 0)) + WORLD_SLACK_S
        spawn_world(target, world, spec["device"], timeout, args=(spec,))
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                results.append(json.load(f))
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


class Run:
    """What a metric reader reads: rank 0's window and the merged
    trace."""

    def __init__(self, results, config, cell, trace):
        r0 = results[0]
        self.config, self.cell = config, cell
        self.world = len(results)
        self.steps_s = r0["steps_s"]
        self.host_s = r0["host_s"]
        self.window_s = r0["window_s"]
        self.setup_s = r0["setup_s"]
        self.failed = max(r["failed"] for r in results)
        self.ok_steps = len(self.steps_s) - self.failed
        self.bytes_per_step = r0["bytes_per_step"]
        self.info = r0["info"]
        self.trace = trace


def metric_specs(bench, cell, traced: bool):
    """The metrics a run of ``cell`` reports: the end-to-end ones, or
    with a trace the per-layer ones that list the cell."""
    if traced:
        return [m for m in bench["per_layer"]
                if cell["name"] in m["workloads"]]
    return list(bench["end_to_end"])


def card_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e.__class__.__name__})"
    return "; ".join(r.stdout.strip().splitlines()) or "not read"


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: Optional[float] = None,
             overrides=None, prepare: Optional[str] = None, cell=None):
    """Run cell ``name`` once; returns (result line dict, '#' lines,
    forbidden modules loaded).  ``overrides`` (sizes for the CPU tests)
    update the configuration; ``prepare`` is a ``module:function`` each
    rank runs first; ``cell``, a workload entry, stands in for the one
    ``BENCHMARK.json`` names ``name``."""
    bench = common.benchmark()
    cell = cell or find_cell(bench, name)
    world = int(cell["chips"])
    config = dict(common.data("configs", cell["config"]))
    config.update(overrides or {})
    spec = {"cell": name, "config": cell["config"],
            "traffic": cell["traffic"], "seed": int(seed),
            "seconds": float(seconds), "trace": bool(trace),
            "device": device, "overrides": overrides or {},
            "t0": time.monotonic() if t0 is None else t0,
            "prepare": prepare}
    if world == 1:
        results = [run_rank(None, spec)]
    else:
        results = run_world(_rank_entry, spec, world)
    ref = common.module("reference", cell["config"])
    checks: Dict[str, int] = {}
    for k in range(len(results[0]["readings"])):
        got = ref.combine([r["readings"][k] for r in results], config,
                          world)
        for key, v in got.items():
            checks[key] = max(checks.get(key, v), v)
    merged = tracing.merge([r["trace"] for r in results]) if trace \
        else None
    run = Run(results, config, cell, merged)
    metrics = {}
    for m in metric_specs(bench, cell, trace):
        value = common.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = run.failed == 0 and all(
        checks[key] <= limit for key, limit in ref.LIMITS.items())
    line: Dict[str, object] = {
        "correct": correct,
        "attempted": len(run.steps_s),
        "failed": run.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device == "cuda" else device,
            "kind": results[0]["card"],
            "count": world,
            "memory_peak_bytes": max(r["peak_bytes"] for r in results),
        },
    }
    if merged is not None:
        line["device"]["busy_s"] = merged["busy_s"]
        line["device"]["window_s"] = merged["window_s"]
        line["breakdown"] = tracing.breakdown(merged)
    line["checks"] = {key: {"value": checks[key], "limit": limit}
                      for key, limit in ref.LIMITS.items()}
    notes = [f"# cell {name} seed {seed} ranks {world} steps "
             f"{len(run.steps_s)} failed {run.failed} window_s "
             f"{run.window_s}"]
    for r in results:
        notes.append(f"# rank {r['rank']} card {r['card']} peak_bytes "
                     f"{r['peak_bytes']} " + " ".join(
                         f"{k} {v}" for k, v in r["info"].items()))
        notes.append(f"# rank {r['rank']} set-up seconds after start: "
                     + " ".join(f"{k} {v}" for k, v in
                                r["setup_phases_s"].items()))
    forbidden = sorted({m for r in results for m in r["forbidden"]}
                       | set(forbidden_modules()))
    return line, notes, forbidden


def _parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m shufflebench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _cache_env() -> None:
    """Every kernel cache inside the checkout, at fixed paths.  The
    program's own kernel library builds into its ``_build/``."""
    for var, sub in (("CUDA_CACHE_PATH", "nv"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE_DIR / sub)


def _exit_on_term(signum, frame) -> None:
    raise SystemExit(128 + signum)


def command(argv, t0: float) -> int:
    """``main`` as the entry of its own process (``__main__.py``): this
    process becomes the subreaper of all it starts, a SIGTERM unwinds
    it, and every child is stopped and waited for on the way out."""
    signal.signal(signal.SIGTERM, _exit_on_term)
    _prctl(_PR_SET_CHILD_SUBREAPER, 1)
    try:
        return main(argv, t0)
    finally:
        stop_children()


def main(argv, t0: float) -> int:
    args = _parse(argv)
    try:
        cell = find_cell(common.benchmark(), args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"shufflebench: {e}", file=sys.stderr)
        return 1
    _cache_env()
    import torch

    if not torch.cuda.is_available():
        print("shufflebench: no CUDA device; nothing measured",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"shufflebench: {args.workload} needs {cell['chips']} cards, "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    try:
        importlib.import_module(PROGRAM)
    except ImportError as e:
        print(f"shufflebench: the program {PROGRAM} does not import: {e}",
              file=sys.stderr)
        return 2
    line, notes, forbidden = run_cell(args.workload, args.seed, args.seconds,
                                      bool(args.trace), "cuda", t0)
    stop_children()
    if forbidden:
        print(f"shufflebench: modules of JAX or the JAX package were "
              f"loaded: {forbidden}", file=sys.stderr)
        return 4
    print(f"# card {card_limit()}", flush=True)
    for n in notes:
        print(n, flush=True)
    for key, c in line["checks"].items():
        print(f"check {key} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
