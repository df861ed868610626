#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N]

Builds the hand-written kernels of ``sparkrdma_tpu_torch/csrc`` with
nvcc, holds each kernel against its plain PyTorch version on the card,
drives the port's main paths at full size through their user entry
points (TeraSort 8 B and 100 B records, the port's compile entry
``entry()``, the two-phase block sort engine, WordCount and aggregateByKey over Zipf
keys, the SQL-exchange models: hash and broadcast joins, the TPC-DS
q64/q72-shaped pipeline with and without the fused join+aggregate,
grouped top-k, hash partitioning and the external sort, the rank-local
stages of one rank
of a D = 8 exchange (TeraSort's map side and merge, the keyed map side
and reduction), and causal sequence-parallel attention through
``ring_attention`` and ``ulysses_attention`` on a group of one, 8 heads
x 8192 and x 32768, d_head 128, bfloat16), checks every result against
an independent torch oracle, and shows through the launch counters
that the main paths ran the kernels.  Kernel 3 is also held against
its plain version in float32, bfloat16 and float16 at d_head 32 to 576,
and timed at d 256 and 512 (bfloat16) and d 128 (float16).  Kernel 4,
the merge of sorted runs, is held against its plain version at D = 2,
3, 4 and 8 and timed at the block a rank of the four-card TeraSort
receives.  The byte
data plane (``TileExchange``, ``DeviceArena``) runs at a 1 GiB row and
256 MiB of tile rounds on one card, its bytes checked and its rates
set beside the host link's.  The record-level shuffle runs through
``TpuShuffleContext`` on the host read plane and on the bulk and
windowed device read planes (the co-located exchange on the card),
each result held against the host plane's and an oracle.  With two or
more cards it also runs TeraSort, WordCount, the hash join, the
external sort, the byte plane, ring and Ulysses attention and the
windowed read plane (one executor per card) over NCCL on up to four of
them; with one it prints that this did not run.  With three or more
cards the port's dry run (``entry.dryrun_multichip``: every data-plane
program of the JAX dry run, one process per card) runs over up to
eight; with fewer, its record-plane half runs alone on card 0.
float32 matrix products run without TF32 throughout, so the plain
versions and oracles are full float32.

Each phase prints one JSON line with its times (CUDA events) and the
card's name and power limit.  Then one line lists the kernels, one line
gives ``nvidia-smi``'s name and power limit, and the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
that line; so does a host without CUDA or a directory without the
package.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import pathlib
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
# int32 ALU work: 64 int32 lanes per SM (against 128 float32 lanes), 132
# SMs at the 1.98 GHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# instructions of one compare-exchange of (key, value) pairs: at least
# one compare and four selects
CMPEX_OPS = 5
SORT_N = 1 << 24            # bench.py's 8 B TeraSort shape
WIDE_N = 1 << 25            # HiBench TeraSort "large": 32 M 100 B records
WIDE_WORDS = 24             # 4 B key + 96 B payload
KEYED_N = 1 << 26
VOCAB = 1 << 20
ZIPF_S = 1.1
SCAN_RAGGED_N = 3_000_017
JOIN_DIM = KEYED_N >> 6     # benchmarks/bench_join.py:33-42 at 2^26
JOIN_HOST_N = 1 << 22       # HashJoiner.join, host in and out
TPCDS_DIM1 = KEYED_N >> 6   # benchmarks/bench_tpcds.py:49-66 at 2^26
TPCDS_DIM2 = KEYED_N >> 8
TPCDS_GROUPS = 1024         # stage 3 groups by join key % 1024
TOPK_K = 100                # TPC-DS q67: rank <= 100 per group
PARTS = 8                   # the D = 8 join's map side
EXT_CHUNKS = 16             # external sort: 16 chunks of 2^22 records
EXT_BUCKETS = 64
STAGE_RANKS = 8             # exchange_stages: one rank of a D = 8 world
STAGE_WIDE_N = WIDE_N // STAGE_RANKS
MULTI_SORT_N = 1 << 24      # multi_gpu, per rank
MULTI_FACT_N = 1 << 22
MULTI_DIM_N = 1 << 16
MULTI_EXT_N = 1 << 22       # multi_gpu external sort, per rank
MULTI_EXT_CHUNKS = 4
MULTI_EXT_BUCKETS = 16
MULTI_TIMEOUT_S = 600       # multi_gpu: each collective and the whole world
# the dry run's kernel shapes (entry.dryrun_multichip): scans of about
# 512 rows per rank under the heads of 50 (WordCount) and 9 (the keyed
# aggregator) sorted keys; kernel 3 in float32 at d 8 on H = D heads of
# 16 rows per rank (ring) and on one head of the whole 16 D rows
# (Ulysses), D up to 8
DRYRUN_SCAN_N = 512
DRYRUN_SCAN_GROUPS = (50, 9)
DRYRUN_ATTN_D = 8
DRYRUN_ATTN_S = 16
DRYRUN_RANKS = 8
U32 = (1 << 32) - 1
# the byte data plane on one card (D = 1)
BYTE_ROW = 1 << 30          # exchange_padded: one 1 GiB source row
BYTE_STAGED = 256 << 20     # exchange_into / exchange_bytes tile rounds
BYTE_TILE = 4 << 20         # conf exchangeTileBytes default
BYTE_WINDOW = 2             # conf deviceExchangeWindowRounds default
ARENA_BYTES = 1 << 30       # DeviceArena, filled by ARENA_SPAN writes
ARENA_SPAN = 4 << 20
BYTE_REPS = 3               # timed calls of each byte-plane path
HOST_LINK_BYTES_PER_S = 64e9  # PCIe 5.0 x16, each direction
MULTI_PAIR_BYTES = 64 << 20   # multi_gpu byte plane, per (source, dest)
# multi_gpu windowed plane: one executor per rank over TCP at this port
# (driver) and PORT + 10 + rank (executors), 2 maps per rank, windows of
# one map per rank
MULTI_PLANE_PORT = 29600
# the record-level shuffle on the host read plane (TpuShuffleContext over
# LoopbackNetwork, map outputs staged in the card's memory).  Config 2:
# benchmarks/bench_reduce_loopback.py:44-45,760-766 (reduceByKey of
# (int, 1) records, 2 executors, 4 slices, 4 partitions); config 1:
# benchmarks/bench_local_baseline.py:33-36,40-56,72-90 (columnar
# groupByKey of 64 B payloads over 512 keys, narrow and wide-range keys,
# 4 executors, 8 slices, 8 partitions) at the 1 GB it states
REC2_N, REC2_KEYS, REC2_EXEC, REC2_SLICES, REC2_PARTS = (
    300_000, 1024, 2, 4, 4)
REC1_N, REC1_PAYLOAD, REC1_KEYS = 1 << 24, 64, 512
REC1_EXEC, REC1_SLICES, REC1_PARTS, REC1_TASKS = 4, 8, 8, 2
REC_REPS = 2                # timed jobs of each (config, staging) pair
# the bulk and windowed device read planes (shuffle/bulk.py over the
# co-located exchange, readPlane=bulk | windowed): configs 1 (narrow
# keys) and 2 above, each through both planes with the padded device
# path (deviceExchangeEnabled) on and off; the windowed plane plans
# windows of 2 maps (bulkWindowMaps)
DRP_WINDOW_MAPS = 2
# the host plane's features (phase_host_features).  The conf matrix of
# tests/test_conf_matrix.py (serializer x compress x spill x directIO):
# columnar cells at config 1's widths (groupByKey and sortByKey of 64 B
# payloads, reduceByKey of int64 values, over 512 keys, 4 executors, 8
# slices, 8 partitions) but HF_COL_N records, a quarter of its 2^24: at
# 2^24 the 16 cells took 497 s on an H100 80GB HBM3 at 700 W, mostly
# sortByKey's 2^24 Python tuples, and the script must stay inside half
# its time limit; pickle cells at config 2's 300 000 records over 1024 keys; a spilling
# map task spills about four times.  Then push, skew and the tiered
# store on one reduceByKey of config 1's 2^24 records (int64 values)
# over Zipf(1.1) keys: 8 map tasks of HF_BATCHES batches each (a frame
# per batch and partition, where a split may cut), HF_PARTS partitions
# so that the Zipf head stands out of the median, hot partitions split
# above HF_SPLIT, and a hot tier of a quarter of the map outputs' bytes
HF_COL_N = 1 << 22
HF_COL_SPILL = 1 << 17      # records a columnar map task buffers
HF_PICKLE_SPILL = 1 << 14   # records a pickle map task buffers
HF_MAPS, HF_BATCHES, HF_PARTS = 8, 8, 64
HF_SPLIT = "1m"             # skewSplitThreshold
# float32 "add" sums in another order in the kernel (sequential per
# thread, then a tree) than in the log-step plain version; segments
# average 1000 values of magnitude <= 1, so the two sums differ by far
# less than this
F32_ADD_ATOL = 1e-3
# the network transport plane (phase_network_plane): config 1 (narrow
# keys) through TpuShuffleContext over TcpNetwork, four jobs (staged and
# on the host on the async engine, staged on the threaded engine, staged
# over one stripe), and config 2 staged; then a ProcessCluster of
# NET_CLUSTER_EXEC executor processes on card 0 over HiBench TeraSort
# "small" (conf/workloads/micro/terasort.conf: hibench.terasort.small.
# datasize 3 200 000 records of 100 B; the cluster's "terasort"
# generator: 10 B key, 90 B value), NET_CLUSTER_MAPS maps and
# NET_CLUSTER_PARTS partitions.  Every listener binds in 65300-65535,
# above the kernel's ephemeral range: config 1's job j at NET_BASE + j
# (j < 5; its executors at + 100 + 10 i), config 2's at NET_BASE + 6,
# the cluster at NET_BASE + 5 (executors at + 100 + 40 i), the scrape
# endpoint at NET_BASE + 99
NET_BASE = 65300
NET_CLUSTER_N, NET_CLUSTER_EXEC = 3_200_000, 4
NET_CLUSTER_MAPS, NET_CLUSTER_PARTS = 8, 16
NET_KILL_BOUND_S = 30.0     # a read of a SIGKILLed executor's blocks fails
TENSOR_OPS_PER_S = 989e12   # bf16 dense tensor-core rate, H100 SXM
ATTN_N = 8                  # benchmarks/bench_attention.py: H = 8,
ATTN_S = 8192               # S = 8192, d_head = 128, bf16, causal
ATTN_D = 128
ATTN_LONG_S = 32768         # long context on one card
ORACLE_ROWS = 4096          # q rows per chunk of the attention oracle
NEG_INF = -1e30
# Kernel 3 against its plain version (both on the card):
# - m: float32 sums of d products in another order: atol and rtol 1e-5;
#   rows masked throughout must be NEG_INF exactly;
# - l: the kernel's fast exponential and order of summation: rtol 1e-4;
# - o: float32 within 1e-4 of its largest magnitude; bfloat16 within
#   2^-7 of it, since the kernel rounds p to bfloat16 against the running
#   max of each K tile and the plain version against the row max (one
#   bfloat16 rounding, 2^-9 relative, per term of the sum); float16
#   within 2^-10 of it (one float16 rounding, 2^-11 relative, per term).
ATTN_M_TOL = 1e-5
ATTN_L_RTOL = 1e-4
ATTN_O_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
# kernel 3's tensor-core instantiations (element type, compiled d_head),
# and past d_head 256 its slab kernel (element type, o columns a CTA);
# the wrapper pads any other d_head to the next size the kernel runs
ATTN_TC_TYPES = ("Bf16", "F16")
ATTN_TC_D = (64, 128, 256)
ATTN_WIDE_SW = (64, 128, 256)
ATTN_DTYPES = ("bfloat16", "float16", "float32")
ATTN_CHECK_D = (32, 64, 96, 128, 256, 320, 512, 576)
# extra attention_time shapes at 8 x 8192, causal: (d_head, dtype)
ATTN_TIME_EXTRA = ((256, "bfloat16"), (128, "float16"), (512, "bfloat16"))
# Attention outputs in bfloat16 against the float32 oracle (or each
# other): the output's own rounding (2^-9 relative) plus p's rounding
# before p . v (2^-9 per term).
ATTN_OUT_TOL = dict(rtol=1e-2, atol=1e-2)

CARD = {}


def out(obj) -> None:
    print(json.dumps(obj), flush=True)


def phase(name: str, **fields) -> None:
    out({"phase": name, **fields, "card": CARD["smi"]})


class SmokeError(RuntimeError):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def cuda_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    """Mean milliseconds per call, from CUDA events around ``iters``
    calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_int32_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_int32_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile(torch, label: str, fn, top: int = 6, warm: bool = True) -> None:
    """One call of ``fn`` under torch.profiler: device time by kernel
    and the device's idle share of the profiled wall time.  Prints
    "not measured" where the profiler reports no device time.  ``warm``
    first calls ``fn`` once outside the profile."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    if warm:
        fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with tprofile(activities=acts) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6

    def dev_us(e):
        # kernels and copies only: an aten:: op also reports the device
        # time of the kernels it launched
        if "CUDA" not in str(getattr(e, "device_type", "")):
            return 0
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    rows = [(e.key, dev_us(e)) for e in prof.key_averages() if dev_us(e)]
    busy = sum(t for _k, t in rows)
    if not busy:
        phase("profile", path=label, device_time="not measured")
        return
    rows.sort(key=lambda r: -r[1])
    phase("profile", path=label, wall_us=wall_us, device_busy_us=busy,
          idle_share=max(0.0, 1 - busy / wall_us),
          top=[[k[:60], t, t / busy] for k, t in rows[:top]])


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def _demangle(names):
    try:
        r = subprocess.run(["c++filt"], input="\n".join(names),
                           capture_output=True, text=True, timeout=60)
        got = r.stdout.splitlines()
        if r.returncode == 0 and len(got) == len(names):
            return [g.replace("(anonymous namespace)::", "")
                    .removeprefix("void ").split("(")[0] for g in got]
    except OSError:
        pass
    return list(names)


def _ptxas_rows(log: str):
    """(source, kernel, registers and shared memory, spills) for each
    kernel that nvcc compiled, from the build log."""
    rows, src, name, spill = [], "", "", ""
    for ln in log.splitlines():
        ln = ln.strip()
        if ln.startswith("== "):
            src = ln[3:]
        elif "Compiling entry function" in ln:
            name, spill = ln.split("'")[1], ""
        elif "spill" in ln:
            spill = ln
        elif "Used" in ln and "registers" in ln:
            rows.append([src, name, ln.split(": ", 1)[-1], spill])
    for row, pretty in zip(rows, _demangle([r[1] for r in rows])):
        row[1] = pretty
    return rows


def _sass_counts(_build, ops=("HGMMA", "UTMALDG", "HMMA")):
    """Per kernel of the built library, how many SASS lines name each
    of ``ops`` (cuobjdump, next to nvcc)."""
    lib = _build.BUILD_DIR / _build.source_hash() / _build.LIB_NAME
    tool = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    r = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                       text=True, timeout=300)
    require(r.returncode == 0, f"cuobjdump failed: {r.stderr.strip()}")
    counts, cur = {}, None
    for ln in r.stdout.splitlines():
        if "Function :" in ln:
            cur = ln.split("Function :", 1)[1].strip()
            counts[cur] = dict.fromkeys(ops, 0)
        elif cur is not None:
            for op in ops:
                if op in ln:
                    counts[cur][op] += 1
    names = list(counts)
    return dict(zip(_demangle(names), (counts[n] for n in names)))


def phase_build(_build):
    """Build the kernels, print the ptxas lines of kernels 1, 2 and 3
    (registers, shared memory, spills) and any note that ptxas
    serialised wgmma, and check in the SASS that each of kernel 3's
    tensor-core instantiations (bfloat16 and float16 at d 64, 128 and
    256, and the slab kernel at 64, 128 and 256 columns, with the q
    tile resident or streamed) runs on wgmma
    (HGMMA) fed by TMA (UTMALDG), with no mma.sync (HMMA) left."""
    import threading

    from sparkrdma_tpu_torch.memory import staging

    # the native staging library (g++, host code of the record plane)
    # builds beside nvcc
    st_err = []

    def build_staging():
        try:
            staging._lib()
        except Exception as e:  # reported and failed below
            st_err.append(e)

    st = threading.Thread(target=build_staging)
    t0 = time.monotonic()
    st.start()
    _build.load()
    secs = time.monotonic() - t0
    st.join()
    require(not st_err, f"staging library build failed: {st_err}")
    for src, name, used, spill in _ptxas_rows(_build.build_log()):
        if src in ("flagged_scan.cu", "bitonic_block_sort.cu",
                   "block_attention.cu", "merge_runs.cu"):
            print(f"# ptxas {src} {name}: {used} | {spill}")
    serial = [ln.strip() for ln in _build.build_log().splitlines()
              if "C7514" in ln or "C7515" in ln or "serializ" in ln]
    for ln in serial:
        print(f"# ptxas note: {ln}")
    sass = {k: v for k, v in _sass_counts(_build).items()
            if "attention_tc" in k or "attention_wide" in k}
    want = [f"attention_tc<{ty}, {d}>" for ty in ATTN_TC_TYPES
            for d in ATTN_TC_D] + [f"attention_wide<{ty}, {sw}, {q}>"
                                   for ty in ATTN_TC_TYPES
                                   for sw in ATTN_WIDE_SW
                                   for q in ("true", "false")]
    require(len(sass) == len(want),
            f"expected {len(want)} tensor-core attention kernels: {sass}")
    for name in want:
        require(any(name in k for k in sass),
                f"{name} is not in the library: {list(sass)}")
    for name, c in sass.items():
        require(c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == 0,
                f"{name}: SASS {c} lacks wgmma or TMA, or has mma.sync")
    phase("build", seconds=secs, sources=[p.name for p in _build.sources()],
          sass_attention_tc=sass, wgmma_serialised_notes=len(serial),
          staging_seconds=staging.BUILD_INFO.get("seconds"),
          staging_cached=staging.BUILD_INFO["cached"],
          staging_source=str(staging.SOURCE.relative_to(
              pathlib.Path(__file__).resolve().parent)))


def _adversarial(torch, case, n, gen, dev):
    i32 = torch.iinfo(torch.int32)
    if case == "random":
        return torch.randint(i32.min, i32.max, (n,), generator=gen,
                             device=dev, dtype=torch.int32)
    if case == "all_equal":
        return torch.full((n,), 7, dtype=torch.int32, device=dev)
    if case == "int32_extremes":
        pick = torch.randint(0, 2, (n,), generator=gen, device=dev)
        return torch.where(pick > 0, i32.max, i32.min).to(torch.int32)
    if case == "reversed":
        return torch.arange(n, 0, -1, device=dev).to(torch.int32)
    return torch.randint(0, 5, (n,), generator=gen, device=dev,
                         dtype=torch.int32)  # few distinct keys


def device_kernels(torch, fn):
    """Names of the device kernels that one call of ``fn`` launches
    (torch.profiler; copies and memsets left out), or None where the
    profiler reports no device activity."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if "CUDA" in str(getattr(e, "device_type", ""))]
    if not names:
        return None
    return [n for n in names if not n.startswith(("Memcpy", "Memset"))]


def _block_sort_bounds(n, block_rows):
    """Kernel 2's least time on n pairs: bytes (8 B read and 8 B
    written per pair) and operations (B/2 * L(L+1)/2 compare-exchanges
    per block of B = 2^L pairs, CMPEX_OPS int32 instructions each)."""
    log_b = (block_rows * 128).bit_length() - 1
    compares = n // 2 * log_b * (log_b + 1) // 2
    t_bytes = 16 * n / HBM_BYTES_PER_S * 1e3
    t_ops = CMPEX_OPS * compares / INT32_OPS_PER_S * 1e3
    return t_bytes, t_ops


def phase_block_sort(torch, sk_mod, gen, dev):
    """Kernel 2 against its plain version, bit for bit: one CTA with the
    tile cut to the block (block_rows 1), clusters of 8 and 16 (512,
    1024), a cluster of 16 with global passes beyond it (2048); its
    launch shape, its device kernels per call, and its time beside both
    bounds and torch.sort per block."""
    worst = 0
    cases = [("random", SORT_N, 512)] + [
        (c, 1 << 22, br)
        for c in ("all_equal", "int32_extremes", "reversed", "few_distinct")
        for br in (512, 1024)
    ] + [(c, 1 << 22, br) for c in ("random", "few_distinct")
         for br in (1, 2048)]
    for case, n, br in cases:
        k = _adversarial(torch, case, n, gen, dev)
        v = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=gen,
                          device=dev, dtype=torch.int32)
        gk, gv = sk_mod.sort_pairs_blocks(k, v, block_rows=br)
        wk, wv = sk_mod.block_sort_plain(k, v, block_rows=br)
        torch.cuda.synchronize()
        B = br * 128
        require(torch.equal(gk, wk) and torch.equal(gv, wv),
                f"block sort differs from plain ({case}, n={n}, B={B})")
        ref = torch.sort(k.view(-1, B), dim=1).values.reshape(-1)
        require(torch.equal(gk, ref), f"block sort unsorted ({case})")
        err = int((gk.long() - wk.long()).abs().max())
        worst = max(worst, err, int((gv.long() - wv.long()).abs().max()))
        phase("block_sort_check", case=case, n=n, block_rows=br,
              bit_exact=True)
    k = _adversarial(torch, "random", SORT_N, gen, dev)
    v = torch.arange(SORT_N, dtype=torch.int32, device=dev)
    for br in (512, 1024, 2048):
        shape = sk_mod.cluster_shape(br)
        names = device_kernels(
            torch, lambda: sk_mod.sort_pairs_blocks(k, v, block_rows=br))
        if br <= 1024:
            require(names is not None and len(names) == 1,
                    f"sort_pairs_blocks at block_rows {br} launched "
                    f"{names} on the device, not one kernel")
        phase("block_sort_shape", block_rows=br, **shape,
              device_kernels_per_call=(len(names) if names is not None
                                       else "not measured"),
              kernels=sorted(set(names or []))[:4])
    result = None
    for br in (512, 1024):
        B = br * 128
        ms = cuda_ms(lambda: sk_mod.sort_pairs_blocks(k, v, block_rows=br),
                     iters=10)
        plain = cuda_ms(lambda: sk_mod.block_sort_plain(k, v, block_rows=br),
                        iters=2)
        lib = cuda_ms(lambda: torch.sort(k.view(-1, B), dim=1), iters=10)
        t_bytes, t_ops = _block_sort_bounds(SORT_N, br)
        b_ms, b_by = max((t_bytes, "bytes"), (t_ops, "operations"))
        phase("block_sort_time", n=SORT_N, block_rows=br, ms=ms,
              plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
              bytes_bound_ms=t_bytes, ops_bound_ms=t_ops,
              vs_library=lib / ms, gb_per_s=16 * SORT_N / ms / 1e6)
        if result is None:
            result = dict(max_abs_err=worst, ms=ms, plain_ms=plain,
                          library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                          bytes_bound_ms=t_bytes, ops_bound_ms=t_ops)
    return result


def _scan_err(torch, g, w, what):
    """Largest difference of two scan outputs (0 required)."""
    err = int((g.long() - w.long()).abs().max()) if g.numel() else 0
    require(err == 0 and torch.equal(g, w), what)
    return err


def _scan_sql_checks(torch, scan, gen, dev, n, flag):
    """Kernel 1 on the SQL paths' column sets, bit for bit against its
    plain version: the join probe's fill over two uint32 columns (the
    4-byte transport) and over two int64 columns (the 8-byte one), and
    the join+aggregate's min and max scans of one int32 column under
    group-key heads."""
    worst = 0
    words = torch.randint(-(1 << 31), (1 << 31) - 1, (2, n), generator=gen,
                          device=dev, dtype=torch.int32)
    sets = (("uint32", [w.view(torch.uint32) for w in words]),
            ("int64", [words[0].long() << 17, words[1].long() * -3]))
    for dt, cols in sets:
        gf, gx = scan.scan_flagged("fill", flag, cols)
        wf, wx = scan.scan_flagged_plain("fill", flag, cols)
        torch.cuda.synchronize()
        require(torch.equal(gf, wf), f"fill flag differs ({dt}, n={n})")
        for g, w in zip(gx, wx):
            require(g.dtype == w.dtype, f"fill changed the dtype ({dt})")
            if g.dtype == torch.uint32:  # CUDA cannot index uint32
                g, w = g.view(torch.int32), w.view(torch.int32)
            worst = max(worst, _scan_err(torch, g[wf], w[wf],
                                         f"fill differs ({dt}, n={n})"))
        phase("scan_check", kind="fill", n_cols=2, n=n, dtype=dt,
              bit_exact=True)
    gk = torch.sort(torch.randint(0, TPCDS_GROUPS, (n,), generator=gen,
                                  device=dev)).values
    heads = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       gk[1:] != gk[:-1]])
    for kind in ("min", "max"):
        gf, (g,) = scan.scan_flagged(kind, heads, [words[0]])
        wf, (w,) = scan.scan_flagged_plain(kind, heads, [words[0]])
        require(torch.equal(gf, wf), f"{kind} flag differs (n={n})")
        worst = max(worst, _scan_err(torch, g, w,
                                     f"{kind} scan differs (n={n})"))
        phase("scan_check", kind=kind, n_cols=1, n=n, dtype="int32",
              heads=f"{TPCDS_GROUPS} group-key runs", bit_exact=True)
    return worst


def _scan_dryrun_checks(torch, scan, gen, dev):
    """Kernel 1 at the dry run's shapes, bit for bit against its plain
    version: ``ops/segment.py``'s add, min and max scans of one int32
    or int64 column and its fill of both from run ends, under the heads
    of sorted keys, and ``cumsum_1d``."""
    worst = 0
    n = DRYRUN_SCAN_N
    for groups in DRYRUN_SCAN_GROUPS:
        gk = torch.sort(torch.randint(0, groups, (n,), generator=gen,
                                      device=dev)).values
        heads = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           gk[1:] != gk[:-1]])
        ends = torch.cat([gk[1:] != gk[:-1],
                          torch.ones(1, dtype=torch.bool, device=dev)])
        c32 = torch.randint(-1000, 1000, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        cols = (c32, c32.long() << 20)
        for kind in ("add", "min", "max"):
            for c in cols:
                gf, (g,) = scan.scan_flagged(kind, heads, [c])
                wf, (w,) = scan.scan_flagged_plain(kind, heads, [c])
                require(torch.equal(gf, wf), f"{kind} flag differs (n={n})")
                worst = max(worst, _scan_err(
                    torch, g, w, f"{kind} scan differs ({c.dtype}, n={n})"))
        gf, gx = scan.scan_flagged("fill", ends, list(cols))
        wf, wx = scan.scan_flagged_plain("fill", ends, list(cols))
        require(torch.equal(gf, wf), f"fill flag differs (n={n})")
        for g, w in zip(gx, wx):
            worst = max(worst, _scan_err(torch, g[wf], w[wf],
                                         f"fill differs (n={n})"))
        zero = torch.zeros(n, dtype=torch.bool, device=dev)
        _f, (want,) = scan.scan_flagged_plain("add", zero, [c32])
        worst = max(worst, _scan_err(torch, scan.cumsum_1d(c32), want,
                                     f"cumsum_1d differs (n={n})"))
        phase("scan_check", what="dry run shape", n=n, groups=groups,
              kinds=["add", "min", "max", "fill", "cumsum_1d"],
              dtype="int32,int64", bit_exact=True)
    return worst


def phase_scan(torch, scan, gen, dev):
    """Kernel 1 against its plain version: all kinds, 1-3 columns, and
    at the dry run's shapes."""
    worst = _scan_dryrun_checks(torch, scan, gen, dev)
    for n in (KEYED_N, SCAN_RAGGED_N):
        flag = torch.rand(n, generator=gen, device=dev) < 1e-3
        cols = [torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=gen,
                              device=dev, dtype=torch.int32)
                for _ in range(3)]
        for kind in ("fill", "add", "min", "max"):
            for n_cols in (1, 2, 3):
                gf, gx = scan.scan_flagged(kind, flag, cols[:n_cols])
                wf, wx = scan.scan_flagged_plain(kind, flag, cols[:n_cols])
                torch.cuda.synchronize()
                require(torch.equal(gf, wf), f"scan flag differs ({kind})")
                for g, w in zip(gx, wx):
                    if kind == "fill":
                        g, w = g[wf], w[wf]
                    err = int((g.long() - w.long()).abs().max()) \
                        if g.numel() else 0
                    worst = max(worst, err)
                    require(err == 0 and torch.equal(g, w),
                            f"scan differs ({kind}, {n_cols} cols, n={n})")
                phase("scan_check", kind=kind, n_cols=n_cols, n=n,
                      dtype="int32", bit_exact=True)
        mixed = [cols[0], cols[1].long() << 20, cols[2]]
        for kind in ("fill", "add", "max"):
            gf, gx = scan.scan_flagged(kind, flag, mixed)
            wf, wx = scan.scan_flagged_plain(kind, flag, mixed)
            m = wf if kind == "fill" else torch.ones_like(wf)
            require(all(torch.equal(g[m], w[m]) for g, w in zip(gx, wx)),
                    f"mixed int32/int64 scan differs ({kind}, n={n})")
        phase("scan_check", kinds=["fill", "add", "max"], n=n,
              dtype="int32,int64,int32", bit_exact=True)
        xf = torch.rand(n, generator=gen, device=dev) * 2 - 1
        _f, (gfl,) = scan.scan_flagged("add", flag, [xf])
        _f, (wfl,) = scan.scan_flagged_plain("add", flag, [xf])
        ferr = float((gfl - wfl).abs().max())
        require(ferr <= F32_ADD_ATOL, f"float32 add scan error {ferr}")
        phase("scan_check", kind="add", n=n, dtype="float32",
              max_abs_err=ferr, atol=F32_ADD_ATOL)
        worst = max(worst, _scan_sql_checks(torch, scan, gen, dev, n, flag))
    for n in (KEYED_N, SCAN_RAGGED_N):
        # cumsum_1d passes the kernel no flags: its own path
        x = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=gen,
                          device=dev, dtype=torch.int32)
        got = scan.cumsum_1d(x)
        zero = torch.zeros(n, dtype=torch.bool, device=dev)
        _f, (want,) = scan.scan_flagged_plain("add", zero, [x])
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        require(err == 0 and torch.equal(got, want), f"cumsum_1d differs, n={n}")
        phase("scan_check", what="cumsum_1d", n=n, dtype="int32",
              bit_exact=True)
    x = torch.randint(-1000, 1000, (KEYED_N,), generator=gen, device=dev,
                      dtype=torch.int32)
    ms = cuda_ms(lambda: scan.cumsum_1d(x))
    zero = torch.zeros(KEYED_N, dtype=torch.bool, device=dev)
    plain = cuda_ms(lambda: scan.scan_flagged_plain("add", zero, [x]),
                    iters=2)
    lib = cuda_ms(lambda: torch.cumsum(x, 0, dtype=torch.int32))
    # int32 in, int32 out: 8 B and one add per element
    b_ms, b_by = bound_ms(8 * KEYED_N, KEYED_N)
    phase("scan_time", what="cumsum_1d", n=KEYED_N, ms=ms, plain_ms=plain,
          library_ms=lib, bound_ms=b_ms, bound_by=b_by)
    flag = torch.rand(KEYED_N, generator=gen, device=dev) < 1e-3
    three = [x, x.clone(), x.clone()]
    fill_ms = cuda_ms(lambda: scan.scan_flagged("fill", flag, three))
    fb_ms, _ = bound_ms(2 * KEYED_N + 24 * KEYED_N, 3 * KEYED_N)
    phase("scan_time", what="fill, 3 int32 columns", n=KEYED_N, ms=fill_ms,
          bound_ms=fb_ms, bound_by="bytes")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by)


def _merge_block(torch, gen, dev, n_runs, cap, n_valid, dtype):
    """A received [D, cap] block as the four-card TeraSort delivers it:
    row s holds ``n_valid[s]`` sorted random keys, then the dtype's
    max."""
    info = torch.iinfo(dtype)
    rk = torch.randint(info.min, info.max, (n_runs, cap), generator=gen,
                       device=dev, dtype=dtype)
    rk = torch.sort(rk, dim=1).values
    rvalid = torch.tensor(n_valid, dtype=torch.int32, device=dev)
    pad = torch.arange(cap, device=dev)[None, :] >= rvalid[:, None].long()
    return rk.masked_fill_(pad, info.max), rvalid


def phase_merge_runs(torch, mk, _build, gen, dev):
    """Kernel 4 against its plain version, bit for bit: D = 2, 3, 4 and
    8 over int32 and int64 keys, then timed at the main path's shape,
    the block a rank of ``terasort.d4`` receives: 4 x 21,810,384 int64
    slots (the capacity of 2^26 records a card at factor 1.3), 77%
    real."""
    for n_runs in (2, 3, 4, 8):
        for dtype in (torch.int32, torch.int64):
            cap = (1 << 22) // n_runs + 3
            n_valid = [cap, 0] + [cap * (s + 1) // (n_runs + 1)
                                  for s in range(n_runs - 2)]
            rk, rvalid = _merge_block(torch, gen, dev, n_runs, cap, n_valid,
                                      dtype)
            rk[0, : cap // 2] = torch.iinfo(dtype).max  # real max keys
            rk[0] = torch.sort(rk[0]).values
            gk, gs = mk.merge_runs(rk, rvalid)
            wk, ws = mk.merge_runs_plain(rk, rvalid)
            torch.cuda.synchronize()
            require(torch.equal(gk, wk) and torch.equal(gs, ws),
                    f"merge_runs differs (D={n_runs}, {dtype})")
            phase("merge_runs_check", n_runs=n_runs, cap=cap,
                  dtype=str(dtype).split(".")[-1], bit_exact=True)
            del rk, rvalid, gk, gs, wk, ws
    n_runs, n_local = 4, 1 << 26
    cap = max(8, -(-math.ceil(n_local / n_runs * 1.3) // 8) * 8)
    n_valid = [n_local // n_runs] * n_runs
    rk, rvalid = _merge_block(torch, gen, dev, n_runs, cap, n_valid,
                              torch.int64)
    gk, gs = mk.merge_runs(rk, rvalid)
    wk, ws = mk.merge_runs_plain(rk, rvalid)
    torch.cuda.synchronize()
    require(torch.equal(gk, wk) and torch.equal(gs, ws),
            "merge_runs differs at the main path's shape")
    del wk, ws
    # the library's one stable sort of the flat block gives the merge's
    # order only where no real key equals the dtype's max, as here
    # (randint excludes it)
    lk, li = torch.sort(rk.reshape(-1), stable=True)
    require(torch.equal(lk, gk) and torch.equal(li.to(torch.int32), gs),
            "torch.sort(stable=True) differs from merge_runs")
    del gk, gs, lk, li
    ms = cuda_ms(lambda: mk.merge_runs(rk, rvalid), iters=10)
    plain = cuda_ms(lambda: mk.merge_runs_plain(rk, rvalid), iters=3)
    library = cuda_ms(lambda: torch.sort(rk.reshape(-1), stable=True),
                      iters=3)
    slots, real = n_runs * cap, sum(n_valid)
    # each real key read once; every slot's key and int32 src written
    # once (the padding's keys are known: the dtype's max)
    b_ms, b_by = bound_ms(real * 8 + slots * 12, 0)
    profile(torch, "merge_runs", lambda: mk.merge_runs(rk, rvalid))
    phase("merge_runs_time", n_runs=n_runs, cap=cap, slots=slots,
          real=real, dtype="int64", ms=ms, plain_ms=plain,
          library_ms=library, bound_ms=b_ms, bound_by=b_by,
          rounds=_build.load().sr_merge_runs_rounds(n_runs))
    del rk, rvalid
    return dict(max_abs_err=0, ms=ms, plain_ms=plain, library_ms=library,
                bound_ms=b_ms, bound_by=b_by,
                library="torch.sort(stable=True) of the flat block: the "
                        "same order where no real key is the dtype's max")


def _check_pairs_sorted(torch, keys, vals, sk, sv, what):
    """Keys in order, and the (key, value) pairs a permutation of the
    input's."""
    require(sk.numel() == keys.numel() and bool((sk[1:] >= sk[:-1]).all()),
            f"{what}: unsorted")

    def packed(k, v):
        return torch.sort((k.long() << 32) | (v.long() & 0xFFFFFFFF)).values

    require(torch.equal(packed(sk, sv), packed(keys, vals)),
            f"{what}: pairs are not a permutation of the input")


def phase_terasort(torch, ts, gen, dev):
    keys = torch.randint(0, 1 << 31, (SORT_N,), generator=gen, device=dev,
                         dtype=torch.int32)
    vals = torch.randint(0, 1 << 31, (SORT_N,), generator=gen, device=dev,
                         dtype=torch.int32)
    sorter = ts.TeraSorter(device="cuda")
    (sk, sv, n_valid, max_fill), cap = sorter.sort_device(keys, vals)
    torch.cuda.synchronize()
    require(int(n_valid[0]) == SORT_N, "terasort lost records")
    _check_pairs_sorted(torch, keys, vals, sk[:SORT_N], sv[:SORT_N],
                        "terasort 8B")
    require(bool((sk[SORT_N:] == torch.iinfo(torch.int32).max).all()),
            "terasort padding is not the sentinel")
    ms = cuda_ms(lambda: sorter.sort_device(keys, vals), iters=5)
    profile(torch, "terasort_8B", lambda: sorter.sort_device(keys, vals))
    phase("terasort_8B", n=SORT_N, capacity=cap, ms=ms,
          gb_per_s=SORT_N * 8 / ms / 1e6, correct=True)
    return keys, vals


def phase_terasort_wide(torch, ts, gen, dev):
    keys = torch.randint(0, 1 << 31, (WIDE_N,), generator=gen, device=dev,
                         dtype=torch.int32)
    payload = torch.randint(-(1 << 31), (1 << 31) - 1, (WIDE_N, WIDE_WORDS),
                            generator=gen, device=dev, dtype=torch.int32)
    payload[:, 0] = torch.arange(WIDE_N, device=dev, dtype=torch.int32)
    sorter = ts.TeraSorter(device="cuda")
    (sk, sp, n_valid, _mf), cap = sorter.sort_device_wide(keys, payload)
    torch.cuda.synchronize()
    require(int(n_valid[0]) == WIDE_N, "wide terasort lost records")
    sk, sp = sk[:WIDE_N], sp[:WIDE_N]
    require(bool((sk[1:] >= sk[:-1]).all()), "wide: unsorted")
    rows = sp[:, 0].long()
    require(bool((torch.bincount(rows, minlength=WIDE_N) == 1).all()),
            "wide: rows are not a permutation of the input")
    require(torch.equal(keys[rows], sk), "wide: keys left their rows")
    require(torch.equal(payload[rows], sp), "wide: payload rows changed")
    del sk, sp, rows
    ms = cuda_ms(lambda: sorter.sort_device_wide(keys, payload), iters=3)
    profile(torch, "terasort_wide",
            lambda: sorter.sort_device_wide(keys, payload))
    rec = 4 + 4 * WIDE_WORDS
    phase("terasort_wide", n=WIDE_N, record_bytes=rec, capacity=cap,
          total_gb=WIDE_N * rec / 1e9, ms=ms,
          gb_per_s=WIDE_N * rec / ms / 1e6, correct=True)


def phase_entry(torch):
    """``sparkrdma_tpu_torch.entry.entry()``: its step on its args on the
    card, the output a sorted permutation of the input pairs with the
    padding after it."""
    from sparkrdma_tpu_torch.entry import entry

    fn, args = entry()
    require(all(a.is_cuda for a in args), "entry() args are not on the card")
    keys, vals, _valid = args
    sk, sv, n_valid, max_fill = fn(*args)
    torch.cuda.synchronize()
    nv = int(n_valid[0])
    require(nv == keys.numel(), f"entry step kept {nv} of {keys.numel()}")
    _check_pairs_sorted(torch, keys, vals, sk[:nv], sv[:nv], "entry step")
    require(bool((sk[nv:] == torch.iinfo(torch.int32).max).all()),
            "entry step padding is not the sentinel")
    ms = cuda_ms(lambda: fn(*args), iters=10)
    phase("entry", n_local=keys.numel(), capacity=sk.numel(), n_valid=nv,
          max_fill=int(max_fill[0]), ms=ms, correct=True)


def phase_sort_engine(torch, sk_mod, _build, keys, vals):
    _build.reset_launch_counts()
    ok, ov, valid, fn, overflow = sk_mod.sort_pairs_full_checked(
        keys, vals, block_rows=512, n_buckets=16)
    torch.cuda.synchronize()
    launches = _build.launch_counts()["bitonic_block_sort"]
    require(launches > 0, "sort_pairs_full did not launch the block sort")
    m = valid > 0
    require(int(m.sum()) == SORT_N, "sort engine lost records")
    _check_pairs_sorted(torch, keys, vals, ok[m], ov[m], "sort engine")
    ms = cuda_ms(lambda: sk_mod.sort_pairs_full_checked(
        keys, vals, block_rows=512, n_buckets=16), iters=5)
    profile(torch, "sort_pairs_full", lambda: sk_mod.sort_pairs_full_checked(
        keys, vals, block_rows=512, n_buckets=16))
    phase("sort_pairs_full", n=SORT_N, block_rows=512, n_buckets=16,
          max_bucket_fill=int(overflow), ms=ms,
          gb_per_s=SORT_N * 8 / ms / 1e6, launches=launches, correct=True)
    return launches


def zipf_keys(torch, n, gen, dev):
    ranks = torch.arange(1, VOCAB + 1, device=dev, dtype=torch.float64)
    cdf = torch.cumsum(ranks.pow(-ZIPF_S), 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
    idx = torch.searchsorted(cdf, u).clamp_(max=VOCAB - 1)
    ids = torch.randperm(VOCAB, generator=gen, device=dev).to(torch.int32)
    return ids[idx]


def _wrap32(x):
    return ((x + (1 << 31)) % (1 << 32)) - (1 << 31)


def keyed_oracle(torch, keys, vals):
    uk, inv, cnt = torch.unique(keys, return_inverse=True,
                                return_counts=True)
    v64 = vals.long()

    def red(how, init):
        base = torch.full((uk.numel(),), init, dtype=torch.int64,
                          device=keys.device)
        return base.scatter_reduce(0, inv, v64, how, include_self=False)

    return dict(keys=uk, counts=cnt, sums=_wrap32(red("sum", 0)),
                mins=red("amin", 0), maxs=red("amax", 0))


def _check_keyed(torch, res, oracle, what, with_minmax):
    real = res["counts"] > 0
    require(torch.equal(res["uniq"][real].long(), oracle["keys"].long()),
            f"{what}: keys differ")
    require(torch.equal(res["counts"][real].long(), oracle["counts"]),
            f"{what}: counts differ")
    require(torch.equal(res["sums"][real].long(), oracle["sums"]),
            f"{what}: sums differ")
    if with_minmax:
        require(torch.equal(res["mins"][real].long(), oracle["mins"]),
                f"{what}: mins differ")
        require(torch.equal(res["maxs"][real].long(), oracle["maxs"]),
                f"{what}: maxs differ")


def phase_keyed(torch, models, base, _build, gen, dev):
    keys = zipf_keys(torch, KEYED_N, gen, dev)
    vals = torch.randint(-1000, 1000, (KEYED_N,), generator=gen, device=dev,
                         dtype=torch.int32)
    wc = models.WordCounter(device="cuda")
    agg = models.KeyedAggregator(device="cuda")
    ragged = KEYED_N - 4097
    padded = base.quantize_padded_length(ragged, 1)
    valid = (torch.arange(padded, device=dev) < ragged).to(torch.int32)
    kp = torch.zeros(padded, dtype=torch.int32, device=dev)
    vp = torch.zeros(padded, dtype=torch.int32, device=dev)
    kp[:ragged], vp[:ragged] = keys[:ragged], vals[:ragged]
    runs = [("full", KEYED_N, keys, vals, None),
            ("ragged", ragged, kp, vp, valid)]
    launches = 0
    for label, n, k, v, m in runs:
        oracle = keyed_oracle(torch, k[:n], v[:n])
        _build.reset_launch_counts()
        (uniq, sums, counts, n_unique, _mf), _cap = wc.count_device(k, v, m)
        torch.cuda.synchronize()
        got = _build.launch_counts()["flagged_scan"]
        require(got > 0, "count_device did not launch the flagged scan")
        launches += got
        _check_keyed(torch, dict(uniq=uniq, sums=sums, counts=counts),
                     oracle, f"wordcount {label}", False)
        require(int(n_unique[0]) == oracle["keys"].numel(), "n_unique")
        _build.reset_launch_counts()
        (uniq, sums, counts, mins, maxs, n_unique, _mf), _cap = \
            agg.aggregate_device(k, v, m)
        torch.cuda.synchronize()
        got_a = _build.launch_counts()["flagged_scan"]
        require(got_a > 0, "aggregate_device did not launch the scan")
        launches += got_a
        _check_keyed(torch, dict(uniq=uniq, sums=sums, counts=counts,
                                 mins=mins, maxs=maxs),
                     oracle, f"aggregate {label}", True)
        wc_ms = cuda_ms(lambda: wc.count_device(k, v, m), iters=3)
        agg_ms = cuda_ms(lambda: agg.aggregate_device(k, v, m), iters=3)
        profile(torch, f"wordcount_{label}", lambda: wc.count_device(k, v, m))
        profile(torch, f"aggregate_{label}",
                lambda: agg.aggregate_device(k, v, m))
        phase("keyed", case=label, n=n, padded=k.numel(), vocab=VOCAB,
              zipf_s=ZIPF_S, distinct=oracle["keys"].numel(),
              wordcount_ms=wc_ms, wordcount_mrec_per_s=n / wc_ms / 1e3,
              aggregate_ms=agg_ms, aggregate_mrec_per_s=n / agg_ms / 1e3,
              scan_launches=[got, got_a], correct=True)
    return launches


def _randn(torch, shape, dtype, gen, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _check_partials(torch, got, want, dtype, what):
    """Kernel 3's partials against its plain version's (tolerances at
    ATTN_M_TOL); returns the largest error of m, l (relative) and o."""
    (m, l, o), (wm, wl, wo) = got, want
    masked = wm == NEG_INF
    require(torch.equal(m[masked], wm[masked]),
            f"{what}: masked rows' m is not NEG_INF")
    m_err = float((m - wm)[~masked].abs().max()) if (~masked).any() else 0.0
    m_lim = ATTN_M_TOL * (1 + float(wm[~masked].abs().max())) \
        if (~masked).any() else 0.0
    require(m_err <= m_lim, f"{what}: m differs by {m_err}")
    l_err = float(((l - wl).abs() / wl.abs()).max())
    require(l_err <= ATTN_L_RTOL, f"{what}: l differs by {l_err} (rel)")
    o_err = float((o - wo).abs().max())
    o_lim = ATTN_O_TOL[dtype] * float(wo.abs().max())
    require(o_err <= o_lim, f"{what}: o differs by {o_err} > {o_lim}")
    return m_err, l_err, o_err, o_lim


def phase_attention_check(torch, attn, gen, dev):
    """Kernel 3 against its plain version: every dtype (float32,
    bfloat16, float16), d_head at each compiled size (64, 128, 256),
    padded ones (32, 96) and past 256 (320 and 576: a full slab and a
    narrower one; 512: two full slabs), causal and not, a ragged shape,
    rows masked fully and partly; and the dry run's float32 d 8 blocks."""
    worst = 0.0
    cases = [(dt, d, causal, n, s_q, s_k, qo, ko)
             for dt in ATTN_DTYPES for d in ATTN_CHECK_D
             for causal in (False, True)
             for n, s_q, s_k, qo, ko in ((4, 2048, 2048, 0, 0),
                                         (3, 1000, 1500, 500, 0))]
    cases += [(dt, 128, True, 3, 1000, 1500, qo, ko)
              for dt in ATTN_DTYPES
              for qo, ko in ((0, 1000), (0, 300))]
    # 128-row q tiles straddling the diagonal at nonzero offsets, rows
    # masked throughout, a K block wholly in the future, a ring hop
    cases += [(dt, d, True, n, s_q, s_k, qo, ko)
              for dt in ATTN_DTYPES for d in ATTN_CHECK_D
              for n, s_q, s_k, qo, ko in ((2, 300, 500, 200, 0),
                                          (2, 300, 500, 0, 70),
                                          (2, 300, 500, 0, 400),
                                          (4, 1024, 1536, 1024, 512))]
    # the dry run's: ring hops of 16-row shards on D = 8 heads (the
    # diagonal, one in the past, one in the future), Ulysses on one head
    # of all 128 rows
    s, D = DRYRUN_ATTN_S, DRYRUN_RANKS
    cases += [("float32", DRYRUN_ATTN_D, True, n, s_q, s_k, qo, ko)
              for n, s_q, s_k, qo, ko in ((D, s, s, 0, 0),
                                          (D, s, s, 3 * s, 3 * s),
                                          (D, s, s, (D - 1) * s, 0),
                                          (D, s, s, s, 2 * s),
                                          (1, D * s, D * s, 0, 0))]
    per = {}
    for dt, d, causal, n, s_q, s_k, qo, ko in cases:
        dtype = getattr(torch, dt)
        q = _randn(torch, (n, s_q, d), dtype, gen, dev)
        k = _randn(torch, (n, s_k, d), dtype, gen, dev)
        v = _randn(torch, (n, s_k, d), dtype, gen, dev)
        got = attn.block_attention(q, k, v, qo, ko, causal)
        want = attn.block_attention_plain(q, k, v, qo, ko, causal,
                                          1.0 / math.sqrt(d))
        torch.cuda.synchronize()
        what = f"attention {dt} d={d} causal={causal} {n}x{s_q}x{s_k} " \
               f"offsets {qo},{ko}"
        if causal and qo + s_q <= ko:  # every row masked throughout
            require(bool((got[0] == NEG_INF).all())
                    and bool((got[1] == s_k).all()),
                    f"{what}: fully masked rows need m == NEG_INF, l == s_k")
        m_err, l_err, o_err, o_lim = _check_partials(torch, got, want, dt,
                                                     what)
        worst = max(worst, o_err)
        row = per.setdefault((dt, d), dict(cases=0, m_err=0.0,
                                           l_rel_err=0.0, o_err_over_tol=0.0))
        row["cases"] += 1
        row["m_err"] = max(row["m_err"], m_err)
        row["l_rel_err"] = max(row["l_rel_err"], l_err)
        row["o_err_over_tol"] = max(row["o_err_over_tol"], o_err / o_lim)
    # one line per (dtype, d_head): the worst of its cases
    for (dt, d), row in per.items():
        phase("attention_check", dtype=dt, d_head=d,
              kernel_d_head=attn.kernel_d_head(d), tf32=False,
              o_tol_rel=ATTN_O_TOL[dt], **row)
    return worst


def _attention_bound(n, s, d, itemsize):
    """Least time of kernel 3 at offsets 0, causal: 4 d operations per
    unmasked (row, key) pair at the tensor-core rate, against q, k, v
    read once and m, l, o (float32) written once."""
    ops = 4 * d * n * (s * (s + 1) // 2)
    n_bytes = 3 * n * s * d * itemsize + 2 * n * s * 4 + n * s * d * 4
    t_ops = ops / TENSOR_OPS_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _sdpa_ms(torch, q, k, v, iters):
    """Milliseconds of causal SDPA on ``[N, s, d]`` inputs through each
    of its fused backends (flash, cuDNN, memory-efficient) that takes
    them, or else the math one: the fastest time, its backend's name,
    and every backend's time."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        if backend == SDPBackend.MATH and times:
            break
        with sdpa_kernel(backend), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                sdpa(q[None], k[None], v[None], is_causal=True)
            except RuntimeError:
                continue
            times[backend.name] = cuda_ms(
                lambda: sdpa(q[None], k[None], v[None], is_causal=True),
                iters=iters)
    require(times, "no SDPA backend takes these inputs")
    best = min(times, key=times.get)
    return times[best], best, times


def _attention_time(torch, attn, gen, dev, d, dt):
    """Kernel 3 at 8 x 8192, causal, head size ``d`` in ``dt``: held
    against its plain version, timed beside it and SDPA (the fastest
    backend that takes it); prints its ``attention_time`` line and
    returns its numbers."""
    dtype = getattr(torch, dt)
    q, k, v = (_randn(torch, (ATTN_N, ATTN_S, d), dtype, gen, dev)
               for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    got = attn.block_attention(q, k, v, 0, 0, True)
    want = attn.block_attention_plain(q, k, v, 0, 0, True, scale)
    _m, _l, err, _lim = _check_partials(torch, got, want, dt,
                                        f"attention {dt} d={d} at 8 x 8192")
    del got, want
    ms = cuda_ms(lambda: attn.block_attention(q, k, v, 0, 0, True),
                 iters=10)
    plain = cuda_ms(lambda: attn.block_attention_plain(
        q, k, v, 0, 0, True, scale), iters=2)
    lib, backend, backends = _sdpa_ms(torch, q, k, v, iters=10)
    b_ms, b_by = _attention_bound(ATTN_N, ATTN_S, d, 2)
    unmasked = 4 * d * ATTN_N * (ATTN_S * (ATTN_S + 1) // 2)
    phase("attention_time", n=ATTN_N, seq=ATTN_S, d_head=d, dtype=dt,
          causal=True, ms=ms, plain_ms=plain, library_ms=lib,
          library="scaled_dot_product_attention (normalises)",
          library_backend=backend, library_backends_ms=backends,
          bound_ms=b_ms, bound_by=b_by,
          unmasked_tflop_per_s=unmasked / ms / 1e9, max_abs_err=err)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by)


def phase_attention_time(torch, attn, gen, dev):
    """Kernel 3 at the bench shape (8 x 8192, d 128, bfloat16, causal),
    with its plain version and SDPA; at 8 x 8192 also at d 256 and 512
    in bfloat16 and d 128 in float16; and at 8 x 32768 beside SDPA.
    Returns the bench shape's numbers, with the largest error of all."""
    main = _attention_time(torch, attn, gen, dev, ATTN_D, "bfloat16")
    for d, dt in ATTN_TIME_EXTRA:
        err = _attention_time(torch, attn, gen, dev, d, dt)["max_abs_err"]
        main["max_abs_err"] = max(main["max_abs_err"], err)
    # long context: the plain version's score matrix (34 GB) does not
    # fit, so the kernel runs beside SDPA alone; phase_ring checks it
    # against the oracle at this length
    shape = (ATTN_N, ATTN_LONG_S, ATTN_D)
    q, k, v = (_randn(torch, shape, torch.bfloat16, gen, dev)
               for _ in range(3))
    long_ms = cuda_ms(lambda: attn.block_attention(q, k, v, 0, 0, True),
                      iters=3)
    long_lib, long_backend, _ = _sdpa_ms(torch, q, k, v, iters=3)
    lb_ms, lb_by = _attention_bound(ATTN_N, ATTN_LONG_S, ATTN_D, 2)
    unmasked = 4 * ATTN_D * ATTN_N * (ATTN_LONG_S * (ATTN_LONG_S + 1) // 2)
    phase("attention_time", n=ATTN_N, seq=ATTN_LONG_S, d_head=ATTN_D,
          dtype="bfloat16", causal=True, ms=long_ms, plain_ms="not measured",
          library_ms=long_lib, library="scaled_dot_product_attention "
          "(normalises)", library_backend=long_backend, bound_ms=lb_ms,
          bound_by=lb_by,
          unmasked_tflop_per_s=unmasked / long_ms / 1e9)
    return main


def _attention_oracle_err(torch, q, k, v, out):
    """Largest error of ``out`` against causal softmax attention in
    float32 (per head, ORACLE_ROWS query rows at a time); fails past
    ATTN_OUT_TOL."""
    n, s, d = q.shape
    worst = 0.0
    for h in range(n):
        for r0 in range(0, s, ORACLE_ROWS):
            r1 = min(s, r0 + ORACLE_ROWS)
            kk, vv = k[h, :r1].float(), v[h, :r1].float()
            sc = torch.matmul(q[h, r0:r1].float(), kk.T) / math.sqrt(d)
            rows = torch.arange(r0, r1, device=q.device)[:, None]
            cols = torch.arange(r1, device=q.device)[None, :]
            sc.masked_fill_(cols > rows, float("-inf"))
            ref = torch.matmul(torch.softmax(sc, dim=-1), vv)
            got = out[h, r0:r1].float()
            require(torch.allclose(got, ref, **ATTN_OUT_TOL),
                    f"attention differs from the oracle (head {h}, rows "
                    f"{r0}:{r1})")
            worst = max(worst, float((got - ref).abs().max()))
    return worst


def phase_ring(torch, ring_mod, _build, gen, dev):
    """The main path: ``ring_attention`` on a group of one, causal."""
    launches = 0
    kept = None
    for seq, iters in ((ATTN_S, 5), (ATTN_LONG_S, 2)):
        shape = (ATTN_N, seq, ATTN_D)
        q, k, v = (_randn(torch, shape, torch.bfloat16, gen, dev)
                   for _ in range(3))
        _build.reset_launch_counts()
        out = ring_mod.ring_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        got = _build.launch_counts()["block_attention"]
        require(got > 0, "ring_attention did not launch block_attention")
        launches += got
        require(out.shape == q.shape and out.dtype == q.dtype
                and bool(torch.isfinite(out).all()),
                "ring_attention output has the wrong shape or non-finite "
                "values")
        err = _attention_oracle_err(torch, q, k, v, out)
        ms = cuda_ms(lambda: ring_mod.ring_attention(q, k, v, causal=True),
                     iters=iters)
        profile(torch, f"ring_attention_{seq}",
                lambda: ring_mod.ring_attention(q, k, v, causal=True))
        flops = 2 * 2 * ATTN_N * (seq * seq / 2) * ATTN_D
        phase("ring_attention_1gpu", n_heads=ATTN_N, seq=seq,
              d_head=ATTN_D, dtype="bfloat16", causal=True, group_size=1,
              ms=ms, tflop_per_s_per_card=flops / ms / 1e9,
              launches=got, max_abs_err_vs_oracle=err,
              oracle_tol=ATTN_OUT_TOL, correct=True)
        if seq == ATTN_S:
            kept = (q, k, v, out)
        else:
            del q, k, v, out
    return kept, launches


def phase_ulysses(torch, ring_mod, _build, q, k, v, ring_out):
    _build.reset_launch_counts()
    out = ring_mod.ulysses_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    launches = _build.launch_counts()["block_attention"]
    require(launches > 0, "ulysses_attention did not launch the kernel")
    require(torch.allclose(out.float(), ring_out.float(), **ATTN_OUT_TOL),
            "ulysses and ring attention disagree")
    err = float((out.float() - ring_out.float()).abs().max())
    ms = cuda_ms(lambda: ring_mod.ulysses_attention(q, k, v, causal=True))
    profile(torch, "ulysses_attention",
            lambda: ring_mod.ulysses_attention(q, k, v, causal=True))
    phase("ulysses_attention_1gpu", n_heads=ATTN_N, seq=ATTN_S,
          d_head=ATTN_D, dtype="bfloat16", causal=True, group_size=1,
          ms=ms, launches=launches, max_abs_err_vs_ring=err, correct=True)


def phase_ring_fold(torch, attn, ring_mod, q, k, v, ring_out, shards=4):
    """The ring's fold and nonzero k_offset on one card: each q shard
    folds the partials of the K/V shards in the ring's hop order."""
    s_local = ATTN_S // shards
    scale = 1.0 / math.sqrt(ATTN_D)
    worst = 0.0
    for my in range(shards):
        rows = slice(my * s_local, (my + 1) * s_local)
        acc = None
        for j in range(shards):
            src = (my - j) % shards
            cols = slice(src * s_local, (src + 1) * s_local)
            part = attn.block_attention(
                q[:, rows], k[:, cols], v[:, cols], q_offset=my * s_local,
                k_offset=src * s_local, causal=True, scale=scale)
            acc = part if acc is None else ring_mod.fold_partials(*acc, *part)
        out = ring_mod.normalize(acc[2], acc[1], q.dtype).float()
        want = ring_out[:, rows].float()
        require(torch.allclose(out, want, **ATTN_OUT_TOL),
                f"ring fold differs from ring_attention (shard {my})")
        worst = max(worst, float((out - want).abs().max()))
    phase("ring_fold_1gpu", shards=shards, s_local=s_local,
          n_heads=ATTN_N, d_head=ATTN_D, dtype="bfloat16", causal=True,
          max_abs_err_vs_ring=worst, correct=True)


def _host_ms(torch, fn, reps=BYTE_REPS):
    """Host milliseconds of each of ``reps`` calls of ``fn``, the
    device's queue drained before and after each."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
    return times


def _copy_ms(torch, n, dev):
    """Host milliseconds of one ``n``-byte ``copy_`` each way between
    the card and pinned, then pageable, host memory (the best of
    BYTE_REPS)."""
    d = torch.empty(n, dtype=torch.uint8, device=dev)
    res = {}
    for kind in ("pinned", "pageable"):
        h = torch.ones(n, dtype=torch.uint8, pin_memory=kind == "pinned")
        res[f"h2d_{kind}_ms"] = min(_host_ms(
            torch, lambda: d.copy_(h, non_blocking=True)))
        res[f"d2h_{kind}_ms"] = min(_host_ms(
            torch, lambda: h.copy_(d, non_blocking=True)))
        del h
    return res


def _byte_line(path, n, ms, copies, dirs=("h2d", "d2h"), **fields):
    """One ``byte_plane`` line: ``n`` payload bytes in each direction of
    ``dirs`` in the best of ``ms``, beside the host-link bound (the link
    runs both directions at once) and the copies of the same bytes
    (``library_ms``: a pinned copy_ in each of ``dirs``, one after the
    other)."""
    best = min(ms)
    phase("byte_plane", path=path, payload_bytes=n, directions=list(dirs),
          ms=ms, ms_min=best, gb_per_s=n / best / 1e6,
          bound_ms=n / HOST_LINK_BYTES_PER_S * 1e3,
          bound_by="bytes each way over the host link (64 GB/s)",
          library_ms=sum(copies[f"{d}_pinned_ms"] for d in dirs),
          library="copy_ " + " then ".join(dirs) + ", pinned", **copies,
          **fields, correct=True)


def phase_byte_plane(torch, dev):
    """The byte data plane on one card (D = 1): ``exchange_padded`` of
    a 1 GiB pinned source row, full shot and windowed at the conf
    defaults (4 MiB tiles, 2 rounds in flight: 256 rounds);
    ``exchange_into`` and ``exchange_bytes`` (host-staged tile rounds) at
    256 MiB; a 1 GiB ``DeviceArena`` filled by 4 MiB span writes and
    read back.  Each path runs once with integrity on, its received
    bytes held against the sent ones, then is timed on the host clock
    beside its bound (its bytes each way over a 64 GB/s host link) and
    pinned and pageable copies of the same bytes.  The path runs no
    kernel: its device work is copies (and the identity all_to_all of a
    group of one)."""
    import numpy as np

    from sparkrdma_tpu_torch.memory.device_arena import (
        DeviceArena,
        DeviceStagingBridge,
    )
    from sparkrdma_tpu_torch.parallel.exchange import (
        PaddedSourceRow,
        TileExchange,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)

    def rand_bytes(n):
        return torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                             generator=gen)

    copies = _copy_ms(torch, BYTE_ROW, dev)
    phase("host_link", bytes=BYTE_ROW, **copies,
          gb_per_s={k: BYTE_ROW / v / 1e6 for k, v in copies.items()})

    # exchange_padded of one pinned 1 GiB row, the stream ragged
    n_row = BYTE_ROW - 12345
    lengths = np.array([[n_row]], np.int64)
    ex = TileExchange(device=dev, tile_bytes=BYTE_TILE, verify_integrity=True)
    plan = ex.plan(lengths)
    row = DeviceStagingBridge(dev).alloc_row(plan.total_cols)
    sent = rand_bytes(plan.total_cols)
    sent[n_row:] = 0
    torch.from_numpy(row).copy_(sent)
    del sent
    src = {0: PaddedSourceRow(row, plan.total_cols)}
    for name, window in (("full", 0), ("windowed", BYTE_WINDOW)):
        ex.verify_integrity = True
        landed = []
        got = ex.exchange_padded(
            lengths, src, window_rounds=window,
            on_round=lambda r, lo, hi, rows: landed.append(r))[0][0]
        require(landed == list(range(1 if window == 0 else plan.rounds)),
                f"exchange_padded {name}: rounds landed {landed[:4]}...")
        require(np.array_equal(got, row[:n_row]),
                f"exchange_padded {name}: received bytes differ")
        del got
        ex.verify_integrity = False
        ms = _host_ms(torch, lambda: ex.exchange_padded(
            lengths, src, window_rounds=window))
        _byte_line(f"exchange_padded_{name}", n_row, ms, copies,
                   tile_bytes=plan.tile_bytes, rounds=plan.rounds,
                   window_rounds=window, source="pinned")
    profile(torch, "exchange_padded_windowed", lambda: ex.exchange_padded(
        lengths, src, window_rounds=BYTE_WINDOW))
    del row, src
    staged = _copy_ms(torch, BYTE_STAGED, dev)

    # host-staged tile rounds at 256 MiB, from a pageable row
    n_st = BYTE_STAGED - 777
    lengths = np.array([[n_st]], np.int64)
    contig = rand_bytes(n_st).cpu().numpy()
    ex = TileExchange(device=dev, tile_bytes=BYTE_TILE,
                      max_rounds_in_flight=BYTE_WINDOW, verify_integrity=True)
    got = ex.exchange_into(lengths, {0: contig})[0][0]
    require(np.array_equal(got, contig), "exchange_into: bytes differ")
    streams = [[contig.tobytes()]]
    require(ex.exchange_bytes(streams)[0][0] == streams[0][0],
            "exchange_bytes: bytes differ")
    del got
    ex.verify_integrity = False
    rounds = ex.plan(lengths).rounds
    _byte_line("exchange_into", n_st, _host_ms(
        torch, lambda: ex.exchange_into(lengths, {0: contig})), staged,
        tile_bytes=BYTE_TILE, rounds=rounds, window_rounds=BYTE_WINDOW,
        source="pageable")
    _byte_line("exchange_bytes", n_st, _host_ms(
        torch, lambda: ex.exchange_bytes(streams)), staged,
        tile_bytes=BYTE_TILE, rounds=rounds, window_rounds=BYTE_WINDOW,
        source="bytes")
    profile(torch, "exchange_into", lambda: ex.exchange_into(
        lengths, {0: contig}))
    del contig, streams

    # the arena: 1 GiB of 4 MiB spans, written, read back, freed
    arena = DeviceArena(ARENA_BYTES, device=dev)
    data = rand_bytes(ARENA_BYTES).cpu().numpy()
    spans = [arena.alloc(ARENA_SPAN) for _ in range(ARENA_BYTES // ARENA_SPAN)]
    require([sp.offset for sp in spans]
            == list(range(0, ARENA_BYTES, ARENA_SPAN)),
            "arena: spans not first-fit in order")

    def write_all():
        for i, sp in enumerate(spans):
            arena.write(sp, data[i * ARENA_SPAN:(i + 1) * ARENA_SPAN])

    def read_all():
        return [arena.read(sp.offset, ARENA_SPAN) for sp in spans]

    write_ms = _host_ms(torch, write_all)
    back = read_all()
    require(all(b == data[i * ARENA_SPAN:(i + 1) * ARENA_SPAN].tobytes()
                for i, b in enumerate(back)), "arena: read-back differs")
    del back
    read_ms = _host_ms(torch, read_all)
    full = arena.stats()
    for sp in spans:
        sp.free()
    empty = arena.stats()
    require(full["allocated_bytes"] == ARENA_BYTES
            and empty["allocated_bytes"] == 0
            and empty["free_extents"] == 1,
            f"arena stats: {full} then {empty}")
    _byte_line("arena_write", ARENA_BYTES, write_ms, copies, ("h2d",),
               span_bytes=ARENA_SPAN, spans=len(spans),
               writes=full["writes"])
    _byte_line("arena_read", ARENA_BYTES, read_ms, copies, ("d2h",),
               span_bytes=ARENA_SPAN, spans=len(spans))
    del arena, data


def _counters():
    """The record plane's always-on counters, summed over labels:
    staged bytes and segments, device-to-host read bytes, and the
    commits that fell back to host memory, by reason."""
    from sparkrdma_tpu_torch.metrics import get_registry

    got = {"h2d_bytes": 0, "d2h_bytes": 0, "device_segments": 0,
           "pool_exhausted": 0, "arena_full": 0}
    names = {"staging_h2d_bytes_total": "h2d_bytes",
             "arena_device_read_bytes_total": "d2h_bytes",
             "staging_device_segments_total": "device_segments"}
    for c in get_registry().snapshot()["counters"]:
        if c["name"] in names:
            got[names[c["name"]]] += c["value"]
        elif c["name"] == "staging_commit_fallbacks_total":
            got[c["labels"]["reason"]] += c["value"]
    return got


def _record_job(torch, dev, stage, make_ctx, job, check, reps=REC_REPS,
                label=None):
    """One record-plane configuration on a fresh context: a checked
    first job, then ``reps`` timed jobs (host clock); with ``label``
    one more job runs under the profiler.  Returns the line's fields:
    times, the staging counters' deltas, every staged segment's
    placement, the pools' kind and the device memory before, at peak and
    after ``stop()``."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    c0 = _counters()
    ctx = make_ctx(stage)
    placed = []
    for ex in ctx.executors:
        stage_fn = ex.resolver._to_device

        def spy(host, stage_fn=stage_fn):
            t = stage_fn(host)
            placed.append(bool(t.is_cuda))
            return t

        ex.resolver._to_device = spy
    try:
        require(all(ex.staging_pool.is_native for ex in ctx.executors),
                "an executor's staging pool is not native")
        t0 = time.monotonic()
        check(job(ctx))
        first_s = time.monotonic() - t0
        secs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            job(ctx)
            torch.cuda.synchronize()
            secs.append(time.monotonic() - t0)
        if label:
            profile(torch, label, lambda: job(ctx), warm=False)
        peak = torch.cuda.max_memory_allocated()
    finally:
        ctx.stop()
    del ctx
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    c1 = _counters()
    delta = {k: c1[k] - c0[k] for k in c0}
    jobs = 1 + reps + (1 if label else 0)
    if stage:
        require(placed and all(placed),
                f"staged segments not all on the card: {placed.count(False)}"
                f" of {len(placed)} on the host")
        require(delta["device_segments"] == len(placed),
                "segment counter disagrees with the staged segments")
        require(delta["h2d_bytes"] > 0 and delta["d2h_bytes"] > 0,
                f"staged run copied nothing: {delta}")
    else:
        require(not placed and delta["h2d_bytes"] == 0,
                f"host run staged to the device: {delta}")
    require(delta["pool_exhausted"] == 0 and delta["arena_full"] == 0,
            f"commits fell back to host memory: {delta}")
    require(after == base,
            f"device memory {after} B after stop(), {base} B before")
    return dict(first_s=first_s, seconds=secs, seconds_min=min(secs),
                jobs=jobs, h2d_bytes_per_job=delta["h2d_bytes"] / jobs,
                d2h_bytes_per_job=delta["d2h_bytes"] / jobs,
                device_segments_per_job=delta["device_segments"] / jobs,
                segments_on_card=placed.count(True),
                segments_on_host=placed.count(False),
                fallbacks={"pool_exhausted": delta["pool_exhausted"],
                           "arena_full": delta["arena_full"]},
                max_memory_allocated=peak, memory_allocated_before=base,
                memory_allocated_after_stop=after)


def _record_line(torch, dev, config, payload_bytes, n, staged, host,
                 **fields):
    """One ``record_plane`` line: the staged run beside the same job
    with map outputs on the host, the host-link bound (the payload, and
    the staged bytes with keys and framing, once each way over 64 GB/s)
    and pinned and pageable copies of the staged bytes."""
    nb = int(staged["h2d_bytes_per_job"])
    copies = _copy_ms(torch, nb, dev)
    phase("record_plane", config=config, n_records=n,
          payload_bytes=payload_bytes, **fields,
          seconds=staged["seconds_min"], seconds_host=host["seconds_min"],
          mrec_per_s=n / staged["seconds_min"] / 1e6,
          mrec_per_s_host=n / host["seconds_min"] / 1e6,
          gb_per_s=payload_bytes / staged["seconds_min"] / 1e9,
          gb_per_s_host=payload_bytes / host["seconds_min"] / 1e9,
          staged=staged, host=host,
          bound_ms_per_direction=payload_bytes / HOST_LINK_BYTES_PER_S * 1e3,
          bound_by="payload bytes each way over the host link (64 GB/s)",
          staged_bytes_bound_ms_per_direction=nb / HOST_LINK_BYTES_PER_S
          * 1e3, copies_of_staged_bytes=copies, correct=True)


def _config2():
    """Config 2's records, its reduceByKey job and the job's check
    against a Python dict sum."""
    import numpy as np

    rng = np.random.default_rng(1)
    records = [(int(k), 1) for k in rng.integers(0, REC2_KEYS, REC2_N)]
    want = {}
    for k, v in records:
        want[k] = want.get(k, 0) + v

    def job(ctx):
        return ctx.parallelize(records, num_slices=REC2_SLICES) \
            .reduce_by_key(lambda a, b: a + b,
                           num_partitions=REC2_PARTS).collect()

    def check(res):
        got = dict(res)
        require(len(res) == len(got) == REC2_KEYS and got == want
                and sum(got.values()) == REC2_N,
                "config 2: reduceByKey differs from the dict sum")

    return job, check


def _config1_data(np):
    """Config 1's narrow and wide-range keys and its 64 B payloads (with
    their 64-bit words)."""
    rng = np.random.default_rng(0)
    narrow = rng.integers(0, REC1_KEYS, REC1_N).astype(np.int64)
    choices = rng.integers(0, 1 << 60, REC1_KEYS, dtype=np.int64)
    wide = choices[rng.integers(0, REC1_KEYS, REC1_N)]
    vals = np.frombuffer(np.random.default_rng(1).bytes(
        REC1_N * REC1_PAYLOAD), dtype=f"S{REC1_PAYLOAD}")
    words = vals.view(np.uint64).reshape(REC1_N, REC1_PAYLOAD // 8)
    return narrow, wide, vals, words


def _config1_job(np, shape, keys, vals, words):
    """Config 1's groupByKey job over ``keys`` and its check against
    numpy: group sizes (by ``np.bincount`` for the narrow keys) and each
    group's payload by an order-independent sum of its 64-bit words."""
    order = np.argsort(keys, kind="stable")
    uk, heads, sizes = np.unique(keys[order], return_index=True,
                                 return_counts=True)
    sums = np.add.reduceat(words[order], heads, axis=0)
    del order
    oracle = {int(k): (int(s), row.tobytes())
              for k, s, row in zip(uk, sizes, sums)}

    def job(ctx):
        return ctx.parallelize_columns(keys, vals, num_slices=REC1_SLICES) \
            .group_by_key(num_partitions=REC1_PARTS).collect()

    def check(res):
        require(len(res) == REC1_KEYS == len(oracle),
                f"config 1 {shape}: {len(res)} groups")
        for k, grp in res:
            g = np.ascontiguousarray(grp).view(np.uint64) \
                .reshape(-1, REC1_PAYLOAD // 8)
            size, s = oracle[int(k)]
            require(g.shape[0] == size,
                    f"config 1 {shape}: group {k} size {g.shape[0]}")
            require(g.sum(axis=0, dtype=np.uint64).tobytes() == s,
                    f"config 1 {shape}: group {k} payload differs")
        if shape == "narrow":
            require(np.array_equal(np.bincount(keys, minlength=REC1_KEYS),
                                   np.array([oracle[k][0] for k in
                                             range(REC1_KEYS)])),
                    "config 1: np.bincount disagrees")

    return job, check


def phase_record_plane(torch, dev):
    """The record-level shuffle through ``TpuShuffleContext`` on the host
    read plane: write, commit (each map output copied into a uint8
    tensor on the card), publish, resolve, fetch (device-to-host reads
    over ``LoopbackNetwork``) and read.  Config 2: reduceByKey of
    300 000 (int, 1) records over 1024 keys, checked against a Python
    dict sum.  Config 1: columnar groupByKey of 2^24 records of 64 B
    over 512 keys, narrow and wide-range, checked against numpy (group
    sizes by ``np.bincount``, each group's payload by an
    order-independent sum of its 64-bit words).  Each runs with map
    outputs staged on the card and, beside it, kept on the host.
    Returns the staged and host-only seconds of config 2 and of config 1
    with narrow keys (``network_plane`` sets its TCP jobs beside them)."""
    import numpy as np

    from sparkrdma_tpu_torch.api import TpuShuffleContext
    from sparkrdma_tpu_torch.conf import TpuShuffleConf

    loopback = {}
    c2_job, c2_check = _config2()

    def c2_ctx(stage):
        return TpuShuffleContext(num_executors=REC2_EXEC, device=dev,
                                 stage_to_device=stage)

    staged = _record_job(torch, dev, True, c2_ctx, c2_job, c2_check,
                         label="record_plane_config2")
    host = _record_job(torch, dev, False, c2_ctx, c2_job, c2_check)
    loopback["2"] = (staged["seconds_min"], host["seconds_min"])
    _record_line(torch, dev, "2: reduceByKey loopback", REC2_N * 16,
                 REC2_N, staged, host, payload="2 x int64 per record",
                 keys=REC2_KEYS, executors=REC2_EXEC,
                 slices=REC2_SLICES, partitions=REC2_PARTS,
                 serializer="pickle")
    del c2_job, c2_check

    narrow, wide, vals, words = _config1_data(np)
    conf = {"spark.shuffle.tpu.serializer": "columnar"}

    def c1_ctx(stage):
        return TpuShuffleContext(num_executors=REC1_EXEC,
                                 conf=TpuShuffleConf(dict(conf)),
                                 tasks_per_executor=REC1_TASKS, device=dev,
                                 stage_to_device=stage)

    for shape, keys in (("narrow", narrow), ("wide-range", wide)):
        c1_job, c1_check = _config1_job(np, shape, keys, vals, words)
        staged = _record_job(torch, dev, True, c1_ctx, c1_job, c1_check,
                             label=f"record_plane_config1_{shape}")
        host = _record_job(torch, dev, False, c1_ctx, c1_job, c1_check)
        if shape == "narrow":
            loopback["1"] = (staged["seconds_min"], host["seconds_min"])
        _record_line(torch, dev, f"1: groupByKey columnar, {shape} keys",
                     REC1_N * REC1_PAYLOAD, REC1_N, staged, host,
                     key_bytes=REC1_N * 8, keys=REC1_KEYS,
                     executors=REC1_EXEC, slices=REC1_SLICES,
                     partitions=REC1_PARTS, serializer="columnar")
        del c1_job, c1_check
    return loopback


def _key_digests(np, keys, rows):
    """Per key: (records, the 64-bit word sums, the 64-bit word xors) of
    its rows, an order-independent digest of a group (``rows`` is ``[n,
    words]`` uint64)."""
    order = np.argsort(keys, kind="stable")
    uk, heads, sizes = np.unique(keys[order], return_index=True,
                                 return_counts=True)
    sums = np.add.reduceat(rows[order], heads, axis=0)
    xors = np.bitwise_xor.reduceat(rows[order], heads, axis=0)
    return {int(k): (int(n), a.tobytes(), x.tobytes())
            for k, n, a, x in zip(uk, sizes, sums, xors)}


def _groups_digests(np, res, words):
    """:func:`_key_digests` of a columnar groupByKey result."""
    out = {}
    for k, grp in res:
        g = np.ascontiguousarray(grp).view(np.uint64).reshape(-1, words)
        out[int(k)] = (g.shape[0],
                       g.sum(axis=0, dtype=np.uint64).tobytes(),
                       np.bitwise_xor.reduce(g, axis=0).tobytes())
    return out


def _read_plane_job(torch, dev, make_ctx, job, digest, want, device_path,
                    reps=REC_REPS, label=None):
    """One (config, plane, path) of :func:`phase_device_read_plane` on a
    fresh context: a checked first job, then ``reps`` timed jobs (host
    clock); with ``label`` one more job runs under the profiler.  Every
    job's exchange counters (summed over the sessions the context made)
    and the bytes of the blocks it committed are kept per job."""
    import gc

    from sparkrdma_tpu_torch.api import TpuShuffleContext
    from sparkrdma_tpu_torch.metrics import get_registry

    def fallbacks():
        return sum(c["value"] for c in get_registry().snapshot()["counters"]
                   if c["name"] == "exchange_row_pool_fallbacks_total")

    keys = ("rounds_executed", "payload_bytes_moved", "padded_bytes_moved",
            "device_exchanges")
    sessions = []
    orig = TpuShuffleContext._session

    def spy(self):
        sessions.append(orig(self))
        return sessions[-1]

    def totals():
        return {k: sum(x.exchange.stats()[k] for x in sessions)
                for k in keys}

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fb0 = fallbacks()
    TpuShuffleContext._session = spy
    try:
        ctx = make_ctx()  # the windowed plane's session
    finally:
        TpuShuffleContext._session = orig
    ctx._session = lambda: spy(ctx)  # the bulk plane's, one per job
    blocks, windows = [], []
    for ex in ctx.executors:
        def unregister(sid, ex=ex, orig_un=ex.unregister_shuffle):
            r = ex.resolver
            n = 0
            for m in r.map_ids(sid):
                n += sum(len(b) for b in r.get_local_blocks(
                    sid, m, range(r.num_partitions(sid))))
            blocks.append(n)
            if ex.windowed_plane is not None:
                windows.append(len(ex.windowed_plane.window_events(sid)))
            return orig_un(sid)
        ex.unregister_shuffle = unregister
    per_job = []

    def run():
        s0, nb0 = totals(), len(blocks)
        res = job(ctx)
        s1 = totals()
        per_job.append(dict({k: s1[k] - s0[k] for k in keys},
                            block_bytes=sum(blocks[nb0:])))
        return res

    try:
        t0 = time.monotonic()
        res = run()
        first_s = time.monotonic() - t0
        got = digest(res)
        require(got == want, f"{label}: result differs from the host plane")
        del res, got
        secs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            run()
            torch.cuda.synchronize()
            secs.append(time.monotonic() - t0)
        if label:
            profile(torch, label, run, warm=False)
        peak = torch.cuda.max_memory_allocated()
    finally:
        ctx.stop()
    del ctx, sessions[:]
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    for j in per_job:
        require((j["device_exchanges"] > 0) == device_path,
                f"{label}: device_exchanges {j['device_exchanges']} with "
                f"the device path {'on' if device_path else 'off'}")
        require(j["payload_bytes_moved"] == j["block_bytes"] > 0,
                f"{label}: exchange moved {j['payload_bytes_moved']} B of "
                f"{j['block_bytes']} B of blocks")
    require(after == base,
            f"{label}: device memory {after} B after stop(), {base} B "
            "before")
    return dict(first_s=first_s, seconds=secs, seconds_min=min(secs),
                per_job=per_job[0], jobs=len(per_job),
                window_events_per_job=sum(windows) / len(per_job),
                exchange_row_pool_fallbacks_total=fallbacks() - fb0,
                max_memory_allocated=peak, memory_allocated_before=base,
                memory_allocated_after_stop=after)


def _row_copies(torch, n, dev):
    """Milliseconds (best of BYTE_REPS, host clock) of one ``n``-byte
    copy each way between the card and a source row as the read planes
    allocate it: a pinned row (what they use on a card) and a row of the
    native ``StagingPool`` (pageable; what the JAX package uses)."""
    from sparkrdma_tpu_torch.memory.device_arena import host_bytes
    from sparkrdma_tpu_torch.memory.staging import StagingPool

    d = torch.empty(n, dtype=torch.uint8, device=dev)
    pool = StagingPool(max_bytes=2 * n)
    res = {}
    for kind in ("pinned", "pool"):
        h = host_bytes(dev, n) if kind == "pinned" else \
            torch.from_numpy(pool.alloc_gc(n)[:n])
        h.fill_(1)
        res[f"h2d_{kind}_ms"] = min(_host_ms(torch, lambda: d.copy_(h)))
        res[f"d2h_{kind}_ms"] = min(_host_ms(torch, lambda: h.copy_(d)))
        del h
    pool.close()
    return res


def phase_device_read_plane(torch, dev):
    """The bulk and windowed device read planes through
    ``TpuShuffleContext`` (``readPlane=bulk`` and ``windowed`` with
    ``bulkWindowMaps=2``): write, publish, the plan barrier, the
    exchange over the co-located ``TileExchange`` on the card (the
    padded device path, ``deviceExchangeEnabled=true``, and host-staged
    tile rounds, ``false``) and the read.  Config 1 (columnar groupByKey
    of 2^24 x 64 B over 512 narrow keys, 4 executors) and config 2
    (pickle reduceByKey of 300 000 (int, 1) records over 1024 keys, 2
    executors), each result equal to the same job on ``readPlane=host``
    and to an independent oracle (config 1: per key the record count
    and the sum and xor of its 64-bit words, by numpy; config 2: a dict
    sum); each line also gives the host plane's best time of two.  Per
    (config, plane, path) one ``device_read_plane`` line and, on the
    device path, a ``profile`` line; then a ``row_memory`` line:
    the source rows pinned (as the planes run them) against the staging
    pool's pageable rows, end to end and per copy."""
    import numpy as np

    from sparkrdma_tpu_torch.api import TpuShuffleContext
    from sparkrdma_tpu_torch.conf import TpuShuffleConf
    from sparkrdma_tpu_torch.shuffle import bulk as bulk_mod

    def conf_for(base, plane, device_path):
        c = dict(base)
        c["spark.shuffle.tpu.readPlane"] = plane
        c["spark.shuffle.tpu.deviceExchangeEnabled"] = str(device_path)
        if plane == "windowed":
            c["spark.shuffle.tpu.bulkWindowMaps"] = str(DRP_WINDOW_MAPS)
        return TpuShuffleConf(c)

    # config 2
    rng = np.random.default_rng(1)
    records = [(int(k), 1) for k in rng.integers(0, REC2_KEYS, REC2_N)]
    oracle2 = {}
    for k, v in records:
        oracle2[k] = oracle2.get(k, 0) + v

    def c2_job(ctx):
        return ctx.parallelize(records, num_slices=REC2_SLICES) \
            .reduce_by_key(lambda a, b: a + b,
                           num_partitions=REC2_PARTS).collect()

    # config 1, narrow keys
    rng = np.random.default_rng(0)
    keys1 = rng.integers(0, REC1_KEYS, REC1_N).astype(np.int64)
    vals1 = np.frombuffer(np.random.default_rng(1).bytes(
        REC1_N * REC1_PAYLOAD), dtype=f"S{REC1_PAYLOAD}")
    words = REC1_PAYLOAD // 8
    oracle1 = _key_digests(np, keys1, vals1.view(np.uint64)
                           .reshape(REC1_N, words))

    def c1_job(ctx):
        return ctx.parallelize_columns(keys1, vals1,
                                       num_slices=REC1_SLICES) \
            .group_by_key(num_partitions=REC1_PARTS).collect()

    configs = [
        ("2: reduceByKey loopback", c2_job, lambda r: dict(r), oracle2,
         REC2_N, REC2_N * 16, {}, REC2_EXEC, 4,
         dict(keys=REC2_KEYS, slices=REC2_SLICES, partitions=REC2_PARTS,
              serializer="pickle")),
        ("1: groupByKey columnar, narrow keys", c1_job,
         lambda r: _groups_digests(np, r, words), oracle1, REC1_N,
         REC1_N * REC1_PAYLOAD,
         {"spark.shuffle.tpu.serializer": "columnar"}, REC1_EXEC,
         REC1_TASKS,
         dict(keys=REC1_KEYS, slices=REC1_SLICES, partitions=REC1_PARTS,
              serializer="columnar", key_bytes=REC1_N * 8)),
    ]
    for (config, job, digest, oracle, n, payload, base_conf, execs,
         tasks, fields) in configs:
        def make(plane, device_path=False, base_conf=base_conf,
                 execs=execs, tasks=tasks):
            return lambda: TpuShuffleContext(
                num_executors=execs, conf=conf_for(base_conf, plane,
                                                   device_path),
                tasks_per_executor=tasks, device=dev)

        host_ctx = make("host")()
        try:
            want = digest(job(host_ctx))
            host_s = []
            for _ in range(REC_REPS):
                t0 = time.monotonic()
                job(host_ctx)
                host_s.append(time.monotonic() - t0)
        finally:
            host_ctx.stop()
        require(want == oracle, f"config {config}: the host plane differs "
                "from the oracle")
        short = config.split(":")[0]
        runs = {}
        for plane in ("bulk", "windowed"):
            for device_path in (True, False):
                path = "device" if device_path else "host_staged"
                r = _read_plane_job(
                    torch, dev, make(plane, device_path), job, digest,
                    want, device_path,
                    label=f"device_read_plane_config{short}_{plane}_{path}"
                    if device_path else None)
                runs[(plane, path)] = r
                pj = r["per_job"]
                phase("device_read_plane", config=config, plane=plane,
                      path=path, n_records=n, payload_bytes=payload,
                      executors=execs, **fields,
                      window_maps=DRP_WINDOW_MAPS if plane == "windowed"
                      else None, seconds_best=r["seconds_min"],
                      host_plane_seconds_best=min(host_s),
                      mrec_per_s=n / r["seconds_min"] / 1e6,
                      gb_per_s=payload / r["seconds_min"] / 1e9,
                      exchange_per_job={k: pj[k] for k in (
                          "rounds_executed", "payload_bytes_moved",
                          "padded_bytes_moved", "device_exchanges")},
                      block_bytes_per_job=pj["block_bytes"],
                      link_bound_ms_per_direction=pj["padded_bytes_moved"]
                      / HOST_LINK_BYTES_PER_S * 1e3,
                      bound_by="padded exchange bytes each way over the "
                               "host link (64 GB/s)", **r,
                      equal_to_host_plane=True, correct=True)

        if short == "1":
            # source rows from the staging pool (pageable, as the JAX
            # package allocates them) against the pinned rows the planes
            # use on a card: the device path copies each row to the card
            # as it is
            orig = bulk_mod.source_row_alloc
            bulk_mod.source_row_alloc = lambda m: \
                bulk_mod.DeviceStagingBridge(m.device,
                                             pool=m.staging_pool).alloc_row
            try:
                pool_rows = _read_plane_job(
                    torch, dev, make("bulk", True), job, digest, want, True)
            finally:
                bulk_mod.source_row_alloc = orig
            row = payload // execs
            phase("row_memory", config=config, plane="bulk",
                  path="device", source_rows="staging pool (pageable)",
                  seconds_pool_rows=pool_rows["seconds_min"],
                  seconds_pinned_rows=runs[("bulk", "device")]
                  ["seconds_min"],
                  seconds=pool_rows["seconds"], row_bytes=row,
                  copies_of_one_row=_row_copies(torch, row, dev),
                  correct=True)
    del records, keys1, vals1


HF_COUNTERS = (
    "staging_h2d_bytes_total", "staging_commit_fallbacks_total",
    "shuffle_spills_total", "shuffle_spill_bytes_total",
    "push_sub_blocks_total", "push_merged_blocks_total",
    "push_merged_bytes_total", "skew_partitions_split_total",
    "skew_sub_blocks_total", "tier_promotes_total", "tier_demotes_total",
    "tier_commit_bytes_total", "tier_cold_read_bytes_total")


def _feature_counters():
    """The features' counters, summed over labels (the registry is on
    for the phase), and the merged spans served (``push`` reads)."""
    from sparkrdma_tpu_torch.metrics import get_registry

    got = dict.fromkeys(HF_COUNTERS + ("push_reads",), 0)
    for c in get_registry().snapshot()["counters"]:
        if c["name"] in got:
            got[c["name"]] += c["value"]
        elif (c["name"] == "shuffle_fetch_rpcs_total"
              and c["labels"].get("mode") == "push"):
            got["push_reads"] += c["value"]
    return got


def _hf_run(torch, dev, make_ctx, stage, body, label=None):
    """``body(ctx)`` on a fresh context with map outputs staged on the
    card or kept on the host: its result, the seconds it took (host
    clock), the counters' deltas, and the device memory at peak and
    after ``stop()``, which must equal the memory before.  With
    ``label`` the body runs a second time under the profiler."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    c0 = _feature_counters()
    ctx = make_ctx(stage)
    try:
        t0 = time.monotonic()
        res = body(ctx)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        c1 = _feature_counters()
        if label:
            profile(torch, label, lambda: body(ctx), warm=False)
        peak = torch.cuda.max_memory_allocated()
    finally:
        ctx.stop()
    del ctx
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    d = {k: c1[k] - c0[k] for k in c0}
    require(after == base,
            f"device memory {after} B after stop(), {base} B before")
    require(d["staging_commit_fallbacks_total"] == 0,
            f"commits fell back to host memory: {d}")
    require(stage or d["staging_h2d_bytes_total"] == 0,
            f"a host run staged to the device: {d}")
    return res, dict(seconds=secs, counters=d, max_memory_allocated=peak,
                     memory_allocated_before=base,
                     memory_allocated_after_stop=after)


def _hf_columnar_ops(np, ctx, keys, payload, ivals):
    """groupByKey and sortByKey of (key, 64 B payload), reduceByKey of
    (key, int64): each group's digest, the sorted records' keys and
    digests, and the sums."""
    w = REC1_PAYLOAD // 8
    res = {"group": {}}
    t0 = time.monotonic()
    for k, grp in ctx.parallelize_columns(keys, payload,
                                          num_slices=REC1_SLICES) \
            .group_by_key(num_partitions=REC1_PARTS).collect():
        g = np.ascontiguousarray(grp).view(np.uint64).reshape(-1, w)
        res["group"][int(k)] = (g.shape[0],
                                g.sum(axis=0, dtype=np.uint64).tobytes(),
                                np.bitwise_xor.reduce(g, axis=0).tobytes())
    res["seconds"] = {"group": time.monotonic() - t0}
    t0 = time.monotonic()
    out = ctx.parallelize_columns(keys, payload, num_slices=REC1_SLICES) \
        .sort_by_key(num_partitions=REC1_PARTS).collect()
    res["seconds"]["sort"] = time.monotonic() - t0
    sk = np.fromiter((k for k, _v in out), np.int64, count=len(out))
    sw = np.frombuffer(b"".join(v for _k, v in out), np.uint64) \
        .reshape(-1, w)
    del out
    res["sort"] = (sk.tobytes(), _key_digests(np, sk, sw))
    t0 = time.monotonic()
    res["reduce"] = {int(k): int(v) for k, v in ctx.parallelize_columns(
        keys, ivals, num_slices=REC1_SLICES).reduce_by_key(
        "sum", num_partitions=REC1_PARTS).collect()}
    res["seconds"]["reduce"] = time.monotonic() - t0
    return res


def _hf_pickle_ops(ctx, records):
    """groupByKey, sortByKey and reduceByKey of (int, int) records:
    each key's sorted values, the key sequence with each key's sorted
    values, and the sums."""
    def ds():
        return ctx.parallelize(records, num_slices=REC2_SLICES)

    t0 = time.monotonic()
    res = {"group": {k: sorted(v) for k, v in ds().group_by_key(
        num_partitions=REC2_PARTS).collect()}}
    res["seconds"] = {"group": time.monotonic() - t0}
    t0 = time.monotonic()
    out = ds().sort_by_key(num_partitions=REC2_PARTS).collect()
    res["seconds"]["sort"] = time.monotonic() - t0
    by = {}
    for k, v in out:
        by.setdefault(k, []).append(v)
    res["sort"] = ([k for k, _v in out],
                   {k: sorted(v) for k, v in by.items()})
    t0 = time.monotonic()
    res["reduce"] = dict(ds().reduce_by_key(
        lambda a, b: a + b, num_partitions=REC2_PARTS).collect())
    res["seconds"]["reduce"] = time.monotonic() - t0
    return res


def _hf_pst_job(np, keys, vals):
    """reduceByKey("sum") of (key, int64) columns through the context's
    driver and executors, each of ``HF_MAPS`` map tasks writing its
    slice as ``HF_BATCHES`` batches (the frames a hot partition splits
    at), no map-side combine (the skew must reach the reducers): the
    sums by key."""
    from sparkrdma_tpu_torch.shuffle.manager import ColumnarAggregator
    from sparkrdma_tpu_torch.shuffle.partitioner import HashPartitioner
    from sparkrdma_tpu_torch.utils.columns import ColumnBatch

    ids = iter(range(1 << 20))

    def body(ctx):
        sid = 1000 + next(ids)
        E = len(ctx.executors)
        handle = ctx.driver.register_shuffle(
            sid, HF_MAPS, HashPartitioner(HF_PARTS),
            aggregator=ColumnarAggregator.reduce("sum"))
        cuts = np.linspace(0, len(keys), HF_MAPS * HF_BATCHES + 1,
                           dtype=np.int64)
        mbh = {}

        def map_task(m):
            ex = ctx.executors[m % E]
            w = ex.get_writer(handle, m)
            for b in range(m * HF_BATCHES, (m + 1) * HF_BATCHES):
                lo, hi = cuts[b], cuts[b + 1]
                w.write_columns(ColumnBatch(keys[lo:hi], vals[lo:hi]))
            w.stop(True)
            return ex.local_smid, m

        for smid, m in ctx._run_tasks([(m % E, (lambda m=m: map_task(m)))
                                       for m in range(HF_MAPS)]):
            mbh.setdefault(smid, []).append(m)

        def reduce_task(p):
            return list(ctx.executors[p % E].get_reader(
                handle, p, p + 1, mbh).read())

        parts = ctx._run_tasks([(p % E, (lambda p=p: reduce_task(p)))
                                for p in range(HF_PARTS)])
        ctx.driver.unregister_shuffle(sid)
        for ex in ctx.executors:
            ex.unregister_shuffle(sid)
        return {int(k): int(v) for part in parts for k, v in part}

    return body


def _hf_conf_cell(torch, dev, cell, body, want, n, spill_dir, o_direct):
    """One conf-matrix cell ``(serializer, compress, spill, directIO)``:
    ``body`` on a context with map outputs staged on the card, then on
    one with them on the host, each result against ``want``; no spill or
    shuffle file may be left behind, and a spilling cell must spill the
    same in both modes.  Prints the cell's ``host_features`` line."""
    from sparkrdma_tpu_torch.api import TpuShuffleContext
    from sparkrdma_tpu_torch.conf import TpuShuffleConf

    serializer, compress, spill, direct_io = cell
    columnar = serializer == "columnar"
    conf = {"spark.shuffle.tpu.serializer": serializer,
            "spark.shuffle.tpu.compress": compress,
            "spark.shuffle.tpu.directIO": direct_io,
            "spark.shuffle.tpu.spillDir": spill_dir}
    if spill:
        conf["spark.shuffle.tpu.shuffleSpillRecordThreshold"] = (
            HF_COL_SPILL if columnar else HF_PICKLE_SPILL)

    def make_ctx(stage):
        return TpuShuffleContext(
            num_executors=REC1_EXEC if columnar else REC2_EXEC,
            conf=TpuShuffleConf(dict(conf)),
            tasks_per_executor=REC1_TASKS if columnar else 4,
            device=dev, stage_to_device=stage)

    runs = {}
    for stage in (True, False):
        res, runs[stage] = _hf_run(torch, dev, make_ctx, stage, body)
        runs[stage]["op_seconds"] = res["seconds"]
        for op in ("group", "sort", "reduce"):
            require(res[op] == want[op], f"host_features {cell} staged="
                    f"{stage}: {op} differs from the oracle")
        del res
        left = [f for f in os.listdir(spill_dir) if f.startswith("sparkrdma")]
        require(not left,
                f"host_features {cell}: {len(left)} files left behind")
        spills = runs[stage]["counters"]["shuffle_spills_total"]
        require((spills > 0) == spill, f"host_features {cell}: {spills} "
                "spills")
    require(runs[True]["counters"]["shuffle_spills_total"]
            == runs[False]["counters"]["shuffle_spills_total"],
            f"host_features {cell}: spills differ between staging modes")
    require(spill or runs[True]["counters"]["staging_h2d_bytes_total"] > 0,
            f"host_features {cell}: nothing staged")
    phase("host_features", part="conf_matrix", serializer=serializer,
          compress=compress, spill=spill, direct_io=direct_io,
          o_direct=o_direct and direct_io == "auto", n_records=n,
          seconds=runs[True]["seconds"], seconds_host=runs[False]["seconds"],
          staged=runs[True], host=runs[False], correct=True)


def phase_host_features(torch, _build, gen, dev):
    """The record-level shuffle's storage, fetch and admission features
    through ``TpuShuffleContext``, with map outputs staged on the card
    and kept on the host.  First the conf matrix (serializer x compress
    x spill x directIO; groupByKey, sortByKey and reduceByKey in each
    cell), each result held against the other staging mode's and a
    numpy or Python oracle, with no spill or shuffle file left behind.
    Then push merge, skew split and the tiered store together on one
    reduceByKey of 2^24 Zipf-keyed records, staged and on the host,
    each against the oracle; then ``ctx.device_aggregate`` (kernel 1)
    over the same keys against the job's sums.  Returns kernel 1's
    launches."""
    import gc
    import itertools
    import shutil
    import tempfile

    import numpy as np

    from sparkrdma_tpu_torch.api import TpuShuffleContext
    from sparkrdma_tpu_torch.conf import TpuShuffleConf
    from sparkrdma_tpu_torch.memory.direct_io import direct_supported
    from sparkrdma_tpu_torch.metrics import get_registry

    registry = get_registry()
    was_on, registry.enabled = registry.enabled, True
    spill_dir = tempfile.mkdtemp(prefix="host_features_")
    o_direct = direct_supported(spill_dir)
    try:
        rng = np.random.default_rng(3)
        keys1 = rng.integers(0, REC1_KEYS, HF_COL_N).astype(np.int64)
        payload = np.frombuffer(rng.bytes(HF_COL_N * REC1_PAYLOAD),
                                dtype=f"S{REC1_PAYLOAD}")
        ivals = rng.integers(0, 1000, HF_COL_N).astype(np.int64)
        words = payload.view(np.uint64).reshape(HF_COL_N,
                                                REC1_PAYLOAD // 8)
        digests = _key_digests(np, keys1, words)
        want1 = {"group": digests,
                 "sort": (np.sort(keys1, kind="stable").tobytes(), digests),
                 "reduce": {k: int(s) for k, s in enumerate(np.bincount(
                     keys1, weights=ivals, minlength=REC1_KEYS)
                     .astype(np.int64))}}
        del words
        keys2 = rng.integers(0, REC2_KEYS, REC2_N).tolist()
        records = list(zip(keys2, rng.integers(0, 1000, REC2_N).tolist()))
        want2 = {"group": {}, "reduce": {}}
        for k, v in records:
            want2["group"].setdefault(k, []).append(v)
            want2["reduce"][k] = want2["reduce"].get(k, 0) + v
        want2["group"] = {k: sorted(v) for k, v in want2["group"].items()}
        want2["sort"] = (sorted(keys2), want2["group"])
        for cell in itertools.product(("columnar", "pickle"), (False, True),
                                      (False, True), ("auto", "off")):
            if cell[0] == "columnar":
                def body(ctx):
                    return _hf_columnar_ops(np, ctx, keys1, payload, ivals)
                _hf_conf_cell(torch, dev, cell, body, want1, HF_COL_N,
                              spill_dir, o_direct)
            else:
                def body(ctx):
                    return _hf_pickle_ops(ctx, records)
                _hf_conf_cell(torch, dev, cell, body, want2, REC2_N,
                              spill_dir, o_direct)
            gc.collect()
        del payload, keys1, ivals, records, want1, want2
        gc.collect()

        # push + skew + tier on one Zipf job
        zk = zipf_keys(torch, REC1_N, gen, dev).cpu().numpy() \
            .astype(np.int64)
        zv = rng.integers(0, 100, REC1_N).astype(np.int64)
        sums = np.bincount(zk, weights=zv)
        counts = np.bincount(zk)
        want = {int(k): int(sums[k]) for k in np.flatnonzero(counts)}
        out_bytes = REC1_N * 16
        conf = {"spark.shuffle.tpu.serializer": "columnar",
                "spark.shuffle.tpu.pushEnabled": True,
                "spark.shuffle.tpu.skewEnabled": True,
                "spark.shuffle.tpu.skewSplitThreshold": HF_SPLIT,
                "spark.shuffle.tpu.tierHotBytes": out_bytes // 4,
                "spark.shuffle.tpu.spillDir": spill_dir}
        body = _hf_pst_job(np, zk, zv)

        def make_ctx(stage):
            return TpuShuffleContext(
                num_executors=REC1_EXEC, conf=TpuShuffleConf(dict(conf)),
                tasks_per_executor=REC1_TASKS, device=dev,
                stage_to_device=stage)

        runs = {}
        for stage in (True, False):
            res, runs[stage] = _hf_run(
                torch, dev, make_ctx, stage, body,
                label="host_features_push_skew_tier" if stage else None)
            require(res == want, f"host_features push+skew+tier staged="
                    f"{stage}: reduceByKey differs from the oracle")
            c = runs[stage]["counters"]
            require(c["push_sub_blocks_total"] > 0 and c["push_reads"] > 0,
                    f"push merge did not engage: {c}")
            require(c["skew_partitions_split_total"] > 0,
                    f"no hot partition split: {c}")
            require(c["tier_commit_bytes_total"] > 0,
                    f"no merged span entered the tier: {c}")
            require(not stage or c["staging_h2d_bytes_total"] > 0,
                    f"nothing staged: {c}")
        with TpuShuffleContext(num_executors=1, device=dev) as ctx:
            _build.reset_launch_counts()
            t0 = time.monotonic()
            agg = ctx.device_aggregate(zk, zv)
            torch.cuda.synchronize()
            agg_s = time.monotonic() - t0
            launches = _build.launch_counts()["flagged_scan"]
        require(launches > 0, "ctx.device_aggregate launched no scan")
        require({k: st[0] for k, st in agg.items()} == res
                and all(agg[k][1] == int(counts[k]) for k in res),
                "ctx.device_aggregate differs from the job's reduceByKey")
        phase("host_features", part="push_skew_tier", n_records=REC1_N,
              record_bytes=16, keys="Zipf(1.1) over 2^20", distinct=len(res),
              executors=REC1_EXEC, maps=HF_MAPS, batches_per_map=HF_BATCHES,
              partitions=HF_PARTS, skew_split_threshold=HF_SPLIT,
              tier_hot_bytes=out_bytes // 4, o_direct=o_direct,
              seconds=runs[True]["seconds"],
              seconds_host=runs[False]["seconds"], staged=runs[True],
              host=runs[False], device_aggregate_s=agg_s,
              flagged_scan_launches=launches, correct=True)
    finally:
        registry.enabled = was_on
        shutil.rmtree(spill_dir, ignore_errors=True)
    return launches


def _terasort_map_digests(gen, map_id, parts):
    """One TeraSort map's records by partition: {partition: digest}.
    Runs in a pool process, beside the cluster."""
    from sparkrdma_tpu_torch.shuffle.partitioner import HashPartitioner
    from sparkrdma_tpu_torch.transport.simfleet import (
        _gen_records,
        records_digest,
    )

    part = HashPartitioner(parts)
    by = {}
    for rec in _gen_records(gen, map_id):
        by.setdefault(part.partition(rec[0]), []).append(rec)
    return {p: records_digest(r) for p, r in by.items()}


def _merge_digests(digests):
    """Digests of disjoint record sets, combined as ``records_digest``
    combines records: counts and sums add (mod 2^64), CRCs xor."""
    out = {"count": 0, "sum": 0, "xor": 0}
    for d in digests:
        out["count"] += d["count"]
        out["sum"] = (out["sum"] + d["sum"]) & 0xFFFFFFFFFFFFFFFF
        out["xor"] ^= d["xor"]
    return out


def _tcp_counters():
    """Bytes over sockets (sent and received, ``transport="tcp"``) and
    the payload bytes the readers fetched remotely, from the metrics
    registry."""
    from sparkrdma_tpu_torch.metrics import get_registry

    got = {"sent": 0, "received": 0, "remote_read": 0, "local_read": 0}
    for c in get_registry().snapshot()["counters"]:
        lab = c["labels"]
        if c["name"] == "transport_bytes_sent_total" \
                and lab.get("transport") == "tcp":
            got["sent"] += c["value"]
        elif c["name"] == "transport_bytes_received_total" \
                and lab.get("transport") == "tcp":
            got["received"] += c["value"]
        elif c["name"] == "shuffle_read_bytes_total" \
                and lab.get("source") in ("local", "remote"):
            got[lab["source"] + "_read"] += c["value"]
    return got


def _scrape_tcp_sent(url):
    """``transport_bytes_sent_total{transport="tcp"}`` from a live
    ``/metrics`` scrape."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as resp:
        text = resp.read().decode()
    total = 0.0
    for line in text.splitlines():
        if line.startswith("transport_bytes_sent_total{") \
                and 'transport="tcp"' in line:
            total += float(line.rpartition(" ")[2])
    return total


def _network_cluster(torch, seconds_bound):
    """A driver here and NET_CLUSTER_EXEC executor processes, all on card
    0 over real sockets: HiBench TeraSort "small" written by the
    executors, every partition's digest against the parent's
    recomputation (a process pool, while the cluster runs), the census,
    a SIGKILLed executor's blocks failing their read cleanly within
    ``seconds_bound``, and the fleet's flight-recorder dumps merged."""
    import concurrent.futures
    import multiprocessing
    import shutil
    import tempfile

    from sparkrdma_tpu_torch.transport.simfleet import (
        ExecutorCommandError,
        ProcessCluster,
    )

    per_map = NET_CLUSTER_N // NET_CLUSTER_MAPS
    gen = {"kind": "terasort", "records": per_map, "value_len": 90}
    workdir = tempfile.mkdtemp(prefix="network_plane_cluster_")
    base = NET_BASE + 5
    pool = concurrent.futures.ProcessPoolExecutor(
        4, mp_context=multiprocessing.get_context("spawn"))
    oracle = [pool.submit(_terasort_map_digests, gen, m, NET_CLUSTER_PARTS)
              for m in range(NET_CLUSTER_MAPS)]
    t0 = time.monotonic()
    cluster = ProcessCluster(
        NET_CLUSTER_EXEC, base, device="cuda:0", workdir=workdir,
        conf={"spark.shuffle.tpu.partitionLocationFetchTimeout": "60s",
              "spark.shuffle.tpu.connectTimeout": "10s",
              "spark.shuffle.tpu.fetchRetryWaitMs": "100ms"})
    try:
        start_s = time.monotonic() - t0
        want_ports = [base + 100 + 40 * i for i in range(NET_CLUSTER_EXEC)]
        got = {"driver_port": cluster.driver.node.address[1],
               "executor_ports": [ex.info["address"][1]
                                  for ex in cluster.executors],
               "executor_devices": [ex.info["device"]
                                    for ex in cluster.executors],
               "executor_current_cards": [ex.info["cuda_current"]
                                          for ex in cluster.executors]}
        require(got["driver_port"] == base
                and got["executor_ports"] == want_ports,
                f"cluster listeners moved: {got}")
        require(got["executor_devices"] == ["cuda:0"] * NET_CLUSTER_EXEC
                and got["executor_current_cards"]
                == [0] * NET_CLUSTER_EXEC,
                f"an executor is not on card 0: {got}")
        require(str(cluster.driver.device) == "cuda:0",
                f"the driver is on {cluster.driver.device}")
        sid = 21
        cluster.register(sid, num_maps=NET_CLUSTER_MAPS,
                         partitioner=("hash", NET_CLUSTER_PARTS))
        t1 = time.monotonic()
        for m in range(NET_CLUSTER_MAPS):
            cluster.executors[m % NET_CLUSTER_EXEC].send(
                "write", shuffle_id=sid, map_id=m, gen=gen)
        for m in range(NET_CLUSTER_MAPS):
            cluster.executors[m % NET_CLUSTER_EXEC].recv(300.0)
        mbh = cluster.wait_published(sid, NET_CLUSTER_MAPS)
        write_s = time.monotonic() - t1
        t1 = time.monotonic()
        digests = {}
        for lo in range(0, NET_CLUSTER_PARTS, NET_CLUSTER_EXEC):
            for i, ex in enumerate(cluster.executors):
                ex.send("read", shuffle_id=sid, start=lo + i,
                        end=lo + i + 1, maps_by_host=mbh, digest=True)
            for i, ex in enumerate(cluster.executors):
                digests[lo + i] = ex.recv(300.0)["digest"]
        read_s = time.monotonic() - t1
        per_part = [r.result(timeout=300) for r in oracle]
        want = {p: _merge_digests(d[p] for d in per_part if p in d)
                for p in range(NET_CLUSTER_PARTS)}
        bad = [p for p in range(NET_CLUSTER_PARTS) if digests[p] != want[p]]
        require(not bad, f"cluster partitions {bad} differ from the "
                "parent's recomputation")
        require(sum(d["count"] for d in digests.values()) == NET_CLUSTER_N,
                "cluster read a wrong record count")
        census = cluster.census()
        require(sorted(census["executors"]) == list(range(NET_CLUSTER_EXEC)),
                f"census misses executors: {sorted(census['executors'])}")
        # SIGKILL the last executor mid-stage: its blocks' reads fail
        victim = NET_CLUSTER_EXEC - 1
        cluster.kill(victim)
        require(not cluster.executors[victim].alive, "victim still alive")
        t1 = time.monotonic()
        kind = None
        try:
            cluster.call(0, "read", timeout=seconds_bound * 4,
                         shuffle_id=sid, start=0, end=1, maps_by_host=mbh,
                         digest=True)
        except ExecutorCommandError as e:
            kind = e.kind
        kill_s = time.monotonic() - t1
        require(kind == "FetchFailedError",
                f"read of a killed executor's blocks ended with {kind}")
        require(kill_s < seconds_bound,
                f"the failed read took {kill_s:.1f} s > {seconds_bound} s")
        survivors = {k: v for k, v in mbh.items()
                     if k.port != want_ports[victim]}
        part0 = cluster.call(0, "read", shuffle_id=sid, start=0, end=1,
                             maps_by_host=survivors, digest=True)
        require(part0["digest"] == _merge_digests(
            d[0] for m, d in enumerate(per_part)
            if m % NET_CLUSTER_EXEC != victim and 0 in d),
            "the survivors' blocks of partition 0 differ")
        cluster.stop()
        merged = cluster.collect()
        require(len(merged["dump_paths"]) >= NET_CLUSTER_EXEC
                and len(merged["processes"]) == len(merged["dump_paths"]),
                f"fleet dumps: {merged['dump_paths']}")
        return dict(
            records=NET_CLUSTER_N, record_bytes=100, maps=NET_CLUSTER_MAPS,
            partitions=NET_CLUSTER_PARTS, executors=NET_CLUSTER_EXEC,
            start_s=start_s, write_s=write_s, read_s=read_s,
            mrec_per_s_read=NET_CLUSTER_N / read_s / 1e6,
            gb_per_s_read=NET_CLUSTER_N * 100 / read_s / 1e9,
            kill_failed_in_s=kill_s, kill_bound_s=seconds_bound,
            kill_outcome=kind, census={
                "driver": census["driver"],
                "executors": {i: c["census"] for i, c in
                              census["executors"].items()}},
            dumps=len(merged["dump_paths"]),
            merged_processes=len(merged["processes"]), **got)
    finally:
        cluster.stop(graceful=False)
        pool.shutdown(cancel_futures=True)
        shutil.rmtree(workdir, ignore_errors=True)


def phase_network_plane(torch, _build, dev, loopback):
    """The record-level shuffle over real sockets: config 1 (narrow keys)
    through ``TpuShuffleContext(network=TcpNetwork())`` staged (and
    profiled) and on the host on the async engine, staged on the
    threaded engine, staged over one stripe, and staged with ``metrics``
    on, scraped over HTTP (``qos/http.py``) while it runs, its bytes
    over sockets at least the payload its readers fetched remotely;
    each against config 1's oracle and beside the loopback job's seconds
    (``loopback``, from ``record_plane``).  Config 2 staged against its
    dict sum; ``ctx.device_aggregate`` (kernel 1) over config 1's keys
    against the job's group sizes and sums; then a ``ProcessCluster``
    on the card (``_network_cluster``).  Returns kernel 1's
    launches."""
    import threading

    import numpy as np

    from sparkrdma_tpu_torch.api import TpuShuffleContext
    from sparkrdma_tpu_torch.conf import TpuShuffleConf
    from sparkrdma_tpu_torch.metrics import get_registry
    from sparkrdma_tpu_torch.qos.http import MetricsHttpServer
    from sparkrdma_tpu_torch.transport import TcpNetwork

    registry = get_registry()
    was_on = registry.enabled
    narrow, _wide, vals, words = _config1_data(np)
    del _wide
    c1_job, c1_check = _config1_job(np, "narrow", narrow, vals, words)
    groups = {}

    def keep_groups(res):
        c1_check(res)
        groups["res"] = res

    jobs = [  # (name, staged, conf); the last with metrics on
        ("async staged", True, {}),
        ("async host", False, {}),
        ("threaded staged", True,
         {"spark.shuffle.tpu.transportAsyncDispatcher": False}),
        ("one stripe staged", True,
         {"spark.shuffle.tpu.transportNumStripes": 1}),
        ("async staged, metrics on", True, {}),
    ]
    scrape = MetricsHttpServer(NET_BASE + 99)
    require(scrape.port == NET_BASE + 99, f"scrape bound {scrape.port}")
    scrapes = []

    def scraped(ctx):
        """The job in a thread, ``/metrics`` scraped while it runs and
        after it."""
        box = {}

        def run():
            try:
                box["res"] = c1_job(ctx)
            except BaseException as e:  # re-raised below
                box["err"] = e

        t = threading.Thread(target=run)
        sent0 = _scrape_tcp_sent(scrape.url())
        t.start()
        mid = []
        while t.is_alive():
            time.sleep(0.1)
            mid.append(_scrape_tcp_sent(scrape.url()))
        t.join()
        if "err" in box:
            raise box["err"]
        scrapes.append((sent0, mid, _scrape_tcp_sent(scrape.url())))
        return box["res"]

    try:
        for j, (name, stage, extra) in enumerate(jobs):
            metrics = j == len(jobs) - 1
            registry.enabled = metrics

            def make_ctx(stage, j=j, extra=extra, metrics=metrics):
                conf = {"spark.shuffle.tpu.serializer": "columnar",
                        "spark.shuffle.tpu.metrics": metrics, **extra}
                ctx = TpuShuffleContext(
                    num_executors=REC1_EXEC, conf=TpuShuffleConf(conf),
                    network=TcpNetwork(), base_port=NET_BASE + j,
                    tasks_per_executor=REC1_TASKS, device=dev,
                    stage_to_device=stage)
                ports = [m.node.address[1]
                         for m in [ctx.driver] + ctx.executors]
                want = [NET_BASE + j] + [NET_BASE + j + 100 + 10 * i
                                         for i in range(REC1_EXEC)]
                if ports != want:
                    ctx.stop()
                    raise SmokeError(f"{name}: listeners at {ports}")
                return ctx

            c0 = _tcp_counters()
            res = _record_job(
                torch, dev, stage, make_ctx,
                scraped if metrics else c1_job,
                keep_groups if metrics else c1_check,
                label="network_plane_async_staged" if j == 0 else None)
            c1 = _tcp_counters()
            registry.enabled = was_on
            d = {k: c1[k] - c0[k] for k in c0}
            secs = res["seconds_min"]
            line = dict(job=name, conf=extra, staged=stage,
                        n_records=REC1_N,
                        payload_bytes=REC1_N * REC1_PAYLOAD, seconds=secs,
                        mrec_per_s=REC1_N / secs / 1e6,
                        gb_per_s=REC1_N * REC1_PAYLOAD / secs / 1e9,
                        loopback_seconds=loopback["1"][0 if stage else 1],
                        tcp_over_loopback=secs / loopback["1"][
                            0 if stage else 1], run=res)
            if metrics:
                sent0, mid, end = scrapes[-1]
                jobs_run = res["jobs"]
                line.update(
                    bytes_over_sockets_sent=d["sent"] / jobs_run,
                    bytes_over_sockets_received=d["received"] / jobs_run,
                    remote_read_bytes=d["remote_read"] / jobs_run,
                    local_read_bytes=d["local_read"] / jobs_run,
                    scrape={"before": sent0, "during": len(mid),
                            "last_during": mid[-1] if mid else None,
                            "after": end})
                require(d["sent"] > 0 and d["received"] > 0,
                        f"no bytes crossed a socket: {d}")
                require(end - sent0 >= d["remote_read"] / jobs_run > 0,
                        f"the scrape saw {end - sent0} B sent, less than "
                        f"the {d['remote_read'] / jobs_run} B read remotely")
            phase("network_plane", part="config1_tcp", config="1: "
                  "groupByKey columnar, narrow keys", keys=REC1_KEYS,
                  executors=REC1_EXEC, slices=REC1_SLICES,
                  partitions=REC1_PARTS, **line, correct=True)

        c2_job, c2_check = _config2()

        def c2_ctx(stage):
            return TpuShuffleContext(num_executors=REC2_EXEC, device=dev,
                                     network=TcpNetwork(),
                                     base_port=NET_BASE + 6,
                                     stage_to_device=stage)

        res2 = _record_job(torch, dev, True, c2_ctx, c2_job, c2_check)
        phase("network_plane", part="config2_tcp",
              config="2: reduceByKey", n_records=REC2_N, keys=REC2_KEYS,
              executors=REC2_EXEC, staged=True, seconds=res2["seconds_min"],
              mrec_per_s=REC2_N / res2["seconds_min"] / 1e6,
              loopback_seconds=loopback["2"][0], run=res2, correct=True)
        del c2_job, c2_check

        # kernel 1 over the TCP job's keys: per key the group size and
        # the sum of each payload's first byte
        first = vals.view(np.uint8)[::REC1_PAYLOAD].astype(np.int64)
        want = {}
        for k, grp in groups["res"]:
            g = np.ascontiguousarray(grp).view(np.uint8) \
                .reshape(-1, REC1_PAYLOAD)
            want[int(k)] = (int(g[:, 0].astype(np.int64).sum()), g.shape[0])
        with TpuShuffleContext(num_executors=1, device=dev) as ctx:
            _build.reset_launch_counts()
            t0 = time.monotonic()
            agg = ctx.device_aggregate(narrow, first)
            torch.cuda.synchronize()
            agg_s = time.monotonic() - t0
            launches = _build.launch_counts()["flagged_scan"]
        require(launches > 0, "ctx.device_aggregate launched no scan")
        require({k: (st[0], st[1]) for k, st in agg.items()} == want,
                "ctx.device_aggregate differs from the TCP job's groups")
        phase("network_plane", part="device_aggregate", n=REC1_N,
              keys=REC1_KEYS, seconds=agg_s, flagged_scan_launches=launches,
              correct=True)
        del groups["res"], narrow, vals, words
    finally:
        registry.enabled = was_on
        scrape.stop()

    phase("network_plane", part="process_cluster",
          **_network_cluster(torch, NET_KILL_BOUND_S), correct=True)
    return launches


def phase_device_workloads(torch, _build, gen, dev):
    """``ctx.device_count`` and ``ctx.device_aggregate`` on KEYED_N Zipf
    keys through the shuffle context: each equals the direct
    ``WordCounter`` / ``KeyedAggregator`` result, and the flagged scan
    launched.  Returns the scan's launches."""
    from sparkrdma_tpu_torch import KeyedAggregator, WordCounter
    from sparkrdma_tpu_torch.api import TpuShuffleContext

    keys = zipf_keys(torch, KEYED_N, gen, dev).cpu().numpy()
    vals = torch.randint(-1000, 1000, (KEYED_N,), generator=gen, device=dev,
                         dtype=torch.int32).cpu().numpy()
    want_c = WordCounter(device=dev).count(keys)
    want_a = KeyedAggregator(device=dev).aggregate(keys, vals)
    with TpuShuffleContext(num_executors=1, device=dev) as ctx:
        _build.reset_launch_counts()
        t0 = time.monotonic()
        got_c = ctx.device_count(keys)
        torch.cuda.synchronize()
        count_s = time.monotonic() - t0
        launch_c = _build.launch_counts()["flagged_scan"]
        _build.reset_launch_counts()
        t0 = time.monotonic()
        got_a = ctx.device_aggregate(keys, vals)
        torch.cuda.synchronize()
        agg_s = time.monotonic() - t0
        launch_a = _build.launch_counts()["flagged_scan"]
    require(got_c == want_c and sum(got_c.values()) == KEYED_N,
            "ctx.device_count differs from WordCounter.count")
    require(got_a == want_a, "ctx.device_aggregate differs from "
            "KeyedAggregator.aggregate")
    require(launch_c > 0 and launch_a > 0,
            f"ctx.device_* launched the flagged scan {launch_c}, "
            f"{launch_a} times")
    phase("device_workloads", n=KEYED_N, vocab=VOCAB, zipf_s=ZIPF_S,
          distinct=len(got_c), device_count_s=count_s,
          device_aggregate_s=agg_s,
          flagged_scan_launches=[launch_c, launch_a], correct=True)
    return launch_c + launch_a


def _pattern(torch, s, d, n, dev):
    """Stream ``s -> d`` of the multi-GPU byte plane: ``n`` bytes of a
    hash of (s, d, position), made on the device."""
    i = torch.arange(n, dtype=torch.int64, device=dev)
    return (((i * 2654435761 + s * 40503 + d * 97) >> 13) & 0xFF).to(
        torch.uint8)


def _multi_gpu_byte_plane(torch, group, pair_bytes, timed):
    """``exchange_padded`` full and windowed and ``exchange_into`` over
    the group, about ``pair_bytes`` per (source, destination) pair
    (ragged), integrity on, against the transposed-streams oracle: rank
    r's row s must be stream s -> r."""
    import numpy as np

    from sparkrdma_tpu_torch.memory.device_arena import DeviceStagingBridge
    from sparkrdma_tpu_torch.parallel.exchange import (
        PaddedSourceRow,
        TileExchange,
        row_offsets,
    )

    rank, D, dev = group.rank, group.size, group.device
    lengths = np.array([[pair_bytes - 4096 * ((s + d) % 3) - s
                         for d in range(D)] for s in range(D)], np.int64)
    ex = TileExchange(group, tile_bytes=BYTE_TILE, verify_integrity=True)
    C = ex.plan(lengths).total_cols
    row = DeviceStagingBridge(dev).alloc_row(D * C)
    offs = row_offsets(lengths[rank])
    contig = np.empty(int(offs[-1]), np.uint8)
    for d in range(D):
        n = int(lengths[rank, d])
        stream = _pattern(torch, rank, d, n, dev).cpu().numpy()
        row[d * C:d * C + n] = stream
        row[d * C + n:(d + 1) * C] = 0
        contig[offs[d]:offs[d + 1]] = stream

    def check(out, what):
        for s in range(D):
            got = torch.from_numpy(np.ascontiguousarray(out[rank][s]))
            want = _pattern(torch, s, rank, int(lengths[s, rank]), dev)
            require(torch.equal(got.to(dev), want),
                    f"rank {rank}: {what} stream {s}->{rank} differs")

    src = {rank: PaddedSourceRow(row, C)}
    check(timed("byte_padded_full_s",
                lambda: ex.exchange_padded(lengths, src)),
          "exchange_padded full")
    check(timed("byte_padded_windowed_s",
                lambda: ex.exchange_padded(lengths, src,
                                           window_rounds=BYTE_WINDOW)),
          "exchange_padded windowed")
    check(timed("byte_into_s",
                lambda: ex.exchange_into(lengths, {rank: contig})),
          "exchange_into")


def _multi_gpu_attention(torch, group, seq, timed):
    """``ring_attention`` and ``ulysses_attention`` (heads permitting)
    over the group, causal, 8 heads x ``seq``, d 128, bfloat16: each
    rank's output shard against the same rows of the one-card result
    (every rank draws the whole input)."""
    from sparkrdma_tpu_torch.models import ring_attention, ulysses_attention

    rank, D, dev = group.rank, group.size, group.device
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    q, k, v = (_randn(torch, (ATTN_N, seq, ATTN_D), dtype, gen, dev)
               for _ in range(3))
    one = ring_attention(q, k, v, causal=True)
    mine = slice(rank * (seq // D), (rank + 1) * (seq // D))
    q, k, v = (x[:, mine].contiguous() for x in (q, k, v))
    scheds = [("ring", ring_attention)]
    if ATTN_N % D == 0:
        scheds.append(("ulysses", ulysses_attention))
    for name, fn in scheds:
        out = timed(f"{name}_attention_s",
                    lambda: fn(q, k, v, group=group, causal=True))
        require(out.shape == q.shape and torch.allclose(
            out.float(), one[:, mine].float(), **ATTN_OUT_TOL),
                f"rank {rank}: {name} attention over the group differs "
                "from the one-card result")


def _scan_launches(torch, _build, fn):
    """Run ``fn`` once with every count at 0; return its result and
    kernel 1's launches in that run."""
    _build.reset_launch_counts()
    res = fn()
    torch.cuda.synchronize()
    return res, _build.launch_counts()["flagged_scan"]


def _packed_rows(torch, k, v):
    """(key, value) rows as sorted int64 words: a multiset."""
    return torch.sort((k.long() << 32) | (v.long() & U32)).values


def phase_join(torch, jmod, _build, gen, dev):
    """``make_hash_join_step`` and ``make_broadcast_join_step`` at the
    bench_join.py shape (2^26 fact rows, 2^20 dimension rows), checked
    against ``torch.searchsorted`` of the fact keys in the dimension
    keys; then ``HashJoiner.join`` for all four variants at 2^22 fact
    rows, host in and out, checked against the same oracle."""
    n, nd = KEYED_N, JOIN_DIM
    i32 = dict(device=dev, dtype=torch.int32)
    dk = torch.arange(nd, **i32)
    dv = torch.randint(0, 1 << 31, (nd,), generator=gen, **i32)
    fk = torch.randint(0, nd, (n,), generator=gen, **i32)
    fv = torch.randint(0, 1 << 31, (n,), generator=gen, **i32)
    cols = (fk, fv, torch.ones(n, **i32), dk, dv, torch.ones(nd, **i32))
    idx = torch.searchsorted(dk, fk).clamp_(max=nd - 1)
    hit = dk[idx] == fk
    want = _packed_rows(torch, fk[hit], fv[hit])
    launches = 0
    cap = 2 * (n + nd)
    steps = (("hash", jmod.make_hash_join_step(1, n, nd, cap)),
             ("broadcast", jmod.make_broadcast_join_step(1, n, nd)))
    for kind, step in steps:
        outs, got = _scan_launches(torch, _build, lambda: step(*cols))
        require(got > 0, f"{kind} join did not launch the flagged scan")
        launches += got
        sk, spay, fval, found, is_fact = outs[:5]
        m = found > 0
        require(int(is_fact.sum()) == n and int(m.sum()) == int(hit.sum()),
                f"{kind} join: wrong fact or match count")
        require(bool((fval[~m] == 0).all()), f"{kind} join: stray dim value")
        rows = (sk[m].long() << 32) | (spay[m].long() & U32)
        rows, order = torch.sort(rows)
        require(torch.equal(rows, want), f"{kind} join: rows differ")
        require(torch.equal(fval[m][order], dv[sk[m][order].long()]),
                f"{kind} join: dimension values differ")
        del outs, sk, spay, fval, found, is_fact, m, rows, order
        ms = cuda_ms(lambda: step(*cols))
        profile(torch, f"{kind}_join", lambda: step(*cols))
        phase("join", kind=kind, n_fact=n, n_dim=nd, ms=ms,
              fact_rows_per_s=n / ms * 1e3,
              fact_gb_per_s=n * 8 / ms / 1e6, launches=got, correct=True)
    del cols, idx, hit, want
    torch.cuda.empty_cache()
    # the host path, with unmatched fact keys for the outer and anti joins
    nh, ndh = JOIN_HOST_N, JOIN_HOST_N >> 6
    fk = torch.randint(0, ndh + ndh // 14, (nh,), generator=gen, **i32)
    fv = torch.randint(-(1 << 31), (1 << 31) - 1, (nh,), generator=gen, **i32)
    dk = torch.arange(ndh, **i32)
    dv = torch.randint(-(1 << 31), (1 << 31) - 1, (ndh,), generator=gen,
                       **i32)
    hit = fk < ndh
    host = [t.cpu().numpy() for t in (fk, fv, dk, dv)]
    joiner = jmod.HashJoiner(device="cuda")
    for how in jmod.JOIN_HOWS:
        t0 = time.monotonic()
        res, got = _scan_launches(torch, _build, lambda: joiner.join(*host, how=how))
        secs = time.monotonic() - t0
        require(got > 0, f"HashJoiner.join({how}) did not launch the scan")
        launches += got
        res = [torch.from_numpy(r).to(dev) for r in res]
        sel = {"inner": hit, "semi": hit, "anti": ~hit,
               "left_outer": torch.ones_like(hit)}[how]
        rows, order = torch.sort(_packed_rows(torch, res[0], res[1]))
        require(torch.equal(rows, _packed_rows(torch, fk[sel], fv[sel])),
                f"HashJoiner.join({how}): rows differ")
        if how in ("inner", "left_outer"):
            k = res[0][order].long()
            matched = (res[3][order] if how == "left_outer"
                       else torch.ones_like(k, dtype=torch.bool))
            require(torch.equal(matched, k < ndh),
                    f"HashJoiner.join({how}): matched mask differs")
            want_v = torch.where(matched, dv[k.clamp(max=ndh - 1)], 0)
            require(torch.equal(res[2][order], want_v),
                    f"HashJoiner.join({how}): dimension values differ")
        phase("join_host", how=how, n_fact=nh, n_dim=ndh,
              rows_out=int(res[0].numel()), seconds=secs, launches=got,
              correct=True)
    profile(torch, "join_host_inner", lambda: joiner.join(*host))
    del fk, fv, dk, dv, hit
    return launches


def _tpcds_gk(ku):
    """bench_tpcds.py's group key: the stage-2 join key % 1024."""
    return ku % TPCDS_GROUPS


def _tpcds_val(ku, fact_pay_u, dim_val_u):
    """bench_tpcds.py's value: fact payload ^ dimension value, int32."""
    return (fact_pay_u ^ dim_val_u).int()


def _group_table(torch, keys, sums, counts, mins, maxs):
    """Run-end rows (counts > 0) as dense [TPCDS_GROUPS] int64 tables of
    (sums as uint32 words, counts, mins, maxs), keyed by group."""
    m = counts > 0
    g = keys[m].long() & U32
    require(bool((g < TPCDS_GROUPS).all()), "group key out of range")
    require(g.numel() == torch.unique(g).numel(), "a group appears twice")
    out = torch.zeros(4, TPCDS_GROUPS, dtype=torch.int64, device=keys.device)
    for i, x in enumerate((sums.long() & U32, counts, mins, maxs)):
        out[i, g] = x[m].long()
    return out


def phase_tpcds(torch, jmod, jamod, agg_mod, _build, gen, dev):
    """bench_tpcds.py:49-169 at 2^26 fact rows: the three-stage pipeline
    (hash join, broadcast join on the fk2 payload with stage 1's found
    mask as validity, aggregate over key % 1024) and the fused one (hash
    join, then the broadcast join + aggregate in one sort), against a
    torch oracle of two searchsorted lookups and scatter_reduce."""
    n, n1, n2 = KEYED_N, TPCDS_DIM1, TPCDS_DIM2
    i32 = dict(device=dev, dtype=torch.int32)
    span = int(n1 * 1.07)
    d1k = torch.sort(torch.randperm(span, generator=gen, device=dev)[:n1]
                     ).values.to(torch.int32)
    d1v = torch.randint(0, 1 << 31, (n1,), generator=gen, **i32)
    d2k = torch.arange(n2, **i32)
    d2v = torch.randint(0, 1 << 31, (n2,), generator=gen, **i32)
    fk1 = torch.randint(0, span, (n,), generator=gen, **i32)
    fk2 = torch.randint(0, n2, (n,), generator=gen, **i32)
    ones = [torch.ones(x, **i32) for x in (n, n1, n2)]
    m1, m2 = n + n1, n + n1 + n2
    step1 = jmod.make_hash_join_step(1, n, n1, 2 * m1)
    step2 = jmod.make_broadcast_join_step(1, m1, n2)
    step3 = agg_mod.make_aggregate_step(1, m2, 2 * m2)
    step23 = jamod.make_broadcast_join_aggregate_step(1, m1, n2, _tpcds_gk,
                                                      _tpcds_val)

    def staged():
        _sk1, spay1, fval1, found1, _f1, _fill1 = step1(
            fk1, fk2, ones[0], d1k, d1v, ones[1])
        sk2, spay2, fval2, found2, _f2 = step2(spay1, fval1, found1, d2k,
                                               d2v, ones[2])
        # int32 words: x & 1023 is the unsigned x % 1024
        return step3(sk2 & (TPCDS_GROUPS - 1), spay2 ^ fval2, found2)[:5]

    def fused():
        _sk1, spay1, fval1, found1, _f1, _fill1 = step1(
            fk1, fk2, ones[0], d1k, d1v, ones[1])
        return step23(spay1, fval1, found1, d2k, d2v, ones[2])[:5]

    idx = torch.searchsorted(d1k, fk1).clamp_(max=n1 - 1)
    hit = d1k[idx] == fk1
    g = (fk2[hit] & (TPCDS_GROUPS - 1)).long()
    v = (d1v[idx][hit] ^ d2v[fk2[hit].long()]).long()
    want = torch.zeros(4, TPCDS_GROUPS, dtype=torch.int64, device=dev)
    want[0].scatter_add_(0, g, v)
    want[0] &= U32
    want[1].scatter_add_(0, g, torch.ones_like(g))
    for i, how in ((2, "amin"), (3, "amax")):
        want[i] = torch.zeros(TPCDS_GROUPS, dtype=torch.int64,
                              device=dev).scatter_reduce(
            0, g, v, how, include_self=False)
    total = int(hit.sum())
    require(total > 0.9 * n, f"stage 1 kept {total} of {n} fact rows")
    launches, res = 0, {}
    for label, fn in (("staged", staged), ("fused", fused)):
        outs, got = _scan_launches(torch, _build, fn)
        require(got > 0, f"tpcds {label} did not launch the flagged scan")
        launches += got
        table = _group_table(torch, *outs)
        require(int(table[1].sum()) == total, f"tpcds {label}: total")
        require(torch.equal(table, want), f"tpcds {label}: groups differ")
        del outs
        ms = cuda_ms(fn, iters=3)
        profile(torch, f"tpcds_{label}", fn)
        res[label] = dict(ms=ms, launches=got)
    phase("tpcds_pipeline", n_fact=n, n_dim1=n1, n_dim2=n2,
          groups=TPCDS_GROUPS, matched=total, staged_ms=res["staged"]["ms"],
          staged_fact_gb_per_s=n * 8 / res["staged"]["ms"] / 1e6,
          fused_ms=res["fused"]["ms"],
          fused_fact_gb_per_s=n * 8 / res["fused"]["ms"] / 1e6,
          launches=[res["staged"]["launches"], res["fused"]["launches"]],
          correct=True)
    return launches


def phase_topk(torch, tkmod, _build, gen, dev):
    """Grouped top-k, k = 100 (the rank <= 100 of TPC-DS q67), over 2^26
    Zipf(1.1) keys, against a torch oracle: one sort by (key, value
    descending) and each row's rank from its run's start."""
    n = KEYED_N
    keys = zipf_keys(torch, n, gen, dev)
    vals = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=gen,
                         device=dev, dtype=torch.int32)
    valid = torch.ones(n, device=dev, dtype=torch.int32)
    step = tkmod.make_topk_step(1, n, n, TOPK_K)
    outs, launches = _scan_launches(torch, _build, lambda: step(keys, vals, valid))
    require(launches > 0, "top-k did not launch the flagged scan")
    ks, vs, keep, n_keep, _mf = outs
    desc = (keys.long() << 32) | ((~vals).long() + (1 << 31))
    order = torch.sort(desc).indices
    sk = keys[order]
    _u, inv, cnt = torch.unique_consecutive(sk, return_inverse=True,
                                            return_counts=True)
    start = torch.cumsum(cnt, 0) - cnt
    rank = torch.arange(n, device=dev) - start[inv]
    kept = rank < TOPK_K
    m = keep > 0
    require(int(n_keep[0]) == int(kept.sum()) == int(m.sum()),
            "top-k kept count differs")
    require(torch.equal(ks[m], sk[kept]) and torch.equal(vs[m],
                                                         vals[order][kept]),
            "top-k rows differ")
    del outs, ks, vs, keep, desc, order, sk, inv, rank, kept, m
    ms = cuda_ms(lambda: step(keys, vals, valid), iters=3)
    profile(torch, "topk", lambda: step(keys, vals, valid))
    phase("topk", n=n, k=TOPK_K, vocab=VOCAB, zipf_s=ZIPF_S,
          groups=int(cnt.numel()), ms=ms, mrec_per_s=n / ms / 1e3,
          launches=launches, correct=True)
    return launches


def _murmur_oracle(torch, keys, n_parts):
    """murmur3's finalizer on the keys' 32 bits, in wrapping int64
    products (the port's partition.py splits them instead)."""
    x = keys.long() & U32
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & U32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & U32
    return ((x ^ (x >> 16)) % n_parts).to(torch.int32)


def phase_partition(torch, part, gen, dev):
    """``hash_partition_ids`` and ``partition_to_buckets_dropping`` on
    2^26 keys into 8 parts plus the trash bucket (one device's map side
    of the D = 8 hash join; 10% of rows invalid), against a torch
    oracle: the murmur3 in int64 and per-part counts and contents as
    multisets."""
    n = KEYED_N
    keys = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=gen,
                         device=dev, dtype=torch.int32)
    vals = torch.arange(n, device=dev, dtype=torch.int32)
    keep = torch.rand(n, generator=gen, device=dev) < 0.9
    cap = -(-int(n / PARTS * 1.6) // 8) * 8
    ids = part.hash_partition_ids(keys, PARTS)
    require(torch.equal(ids, _murmur_oracle(torch, keys, PARTS)),
            "hash_partition_ids differs from the murmur3 oracle")
    (bk, bv), counts = part.partition_to_buckets_dropping(
        ids, keep, (keys, vals), PARTS, cap)
    torch.cuda.synchronize()
    want = torch.bincount(ids[keep].long(), minlength=PARTS)
    require(torch.equal(counts.long(), want), "partition counts differ")
    require(int(counts.max()) <= cap, "partition overflowed")
    for p in range(PARTS):
        c = int(counts[p])
        sel = keep & (ids == p)
        require(torch.equal(_packed_rows(torch, bk[p, :c], bv[p, :c]),
                            _packed_rows(torch, keys[sel], vals[sel])),
                f"bucket {p} rows differ")
        require(bool((bk[p, c:] == torch.iinfo(torch.int32).max).all())
                and bool((bv[p, c:] == 0).all()), f"bucket {p} padding")
    del bk, bv
    hash_ms = cuda_ms(lambda: part.hash_partition_ids(keys, PARTS))
    bucket_ms = cuda_ms(lambda: part.partition_to_buckets_dropping(
        ids, keep, (keys, vals), PARTS, cap), iters=3)
    profile(torch, "partition_to_buckets_dropping",
            lambda: part.partition_to_buckets_dropping(
                ids, keep, (keys, vals), PARTS, cap))
    phase("partition", n=n, n_parts=PARTS, capacity=cap,
          hash_ms=hash_ms, buckets_ms=bucket_ms,
          gb_per_s=n * 8 / (hash_ms + bucket_ms) / 1e6,
          max_bucket=int(counts.max()), correct=True)


def _stage_capacity(n_local, factor):
    """``ExchangeModel._capacity`` at D = STAGE_RANKS."""
    return max(8, -(-math.ceil(n_local / STAGE_RANKS * factor) // 8) * 8)


def _terasort_stages(torch, ts, part, keys, vals):
    """One rank's TeraSort stages: the map side (sort, sample, splitters
    from this rank's own sample, window fill) and the merge of the
    [D, cap] block a rank receives when every source sends it this
    rank's windows.  Returns (map_side, merge, capacity)."""
    n = keys.shape[0]
    cap = _stage_capacity(n, 1.3)  # TeraSorter's factor
    sample = min(1024, n)

    def map_side():
        k, perm, n_real, smp = ts.sort_and_sample(keys, None, sample)
        splitters = part.make_range_splitters(smp, STAGE_RANKS)
        return ts.fill_windows(k, perm, vals, n_real, splitters, cap)

    bk, bv, valid_counts, counts = map_side()
    require(int(counts.max()) <= cap, "a window overflowed its capacity")
    return map_side, lambda: ts.merge_received(bk, bv, valid_counts), cap


def phase_exchange_stages(torch, ts, part, wc_mod, seg, _build, gen, dev):
    """The rank-local stages of one rank of a D = 8 world, at that
    rank's full shape, on one card; collectives excluded.  A rank that
    receives its own [8, cap] block gets input of the shape and
    structure ``all_to_all`` delivers, so the merge and the keyed
    reduction run the port's functions on a valid received block.

    - 8 B TeraSort, n_local = 2^24 (the D = 1 cell's size);
    - 100 B TeraSort, n_local = 2^22 (HiBench "large", 2^25 records,
      over 8 ranks);
    - keyed: 2^26 Zipf(1.1) keys hashed into 8 buckets, then
      ``_premask`` and ``reduce_by_key_local`` (kernel 1).

    Returns kernel 1's launches in the keyed run and kernel 4's in the
    two TeraSort merges (one each)."""
    i32 = dict(device=dev, dtype=torch.int32)
    keys = torch.randint(0, 1 << 31, (SORT_N,), generator=gen, **i32)
    vals = torch.randint(0, 1 << 31, (SORT_N,), generator=gen, **i32)
    map_side, merge, cap = _terasort_stages(torch, ts, part, keys, vals)
    _build.reset_launch_counts()
    sk, sv, n_valid = merge()
    torch.cuda.synchronize()
    merge_launches = _build.launch_counts()["merge_runs"]
    require(merge_launches == 1,
            f"8 B merge_received launched merge_runs {merge_launches}x")
    require(int(n_valid[0]) == SORT_N, "8 B stages lost records")
    _check_pairs_sorted(torch, keys, vals, sk[:SORT_N], sv[:SORT_N],
                        "8 B stages")
    require(bool((sk[SORT_N:] == torch.iinfo(torch.int32).max).all()),
            "8 B stages: padding is not last")
    del sk, sv
    res = dict(map_ms=cuda_ms(map_side), merge_ms=cuda_ms(merge),
               total_ms=cuda_ms(lambda: (map_side(), merge())))
    profile(torch, "exchange_stages_8B", lambda: (map_side(), merge()))
    phase("exchange_stages", what="terasort_8B", ranks=STAGE_RANKS,
          n_local=SORT_N, capacity=cap, received=STAGE_RANKS * cap, **res,
          correct=True)
    del keys, vals, map_side, merge
    torch.cuda.empty_cache()

    n = STAGE_WIDE_N
    keys = torch.randint(0, 1 << 31, (n,), generator=gen, **i32)
    payload = torch.randint(-(1 << 31), (1 << 31) - 1, (n, WIDE_WORDS),
                            generator=gen, **i32)
    payload[:, 0] = torch.arange(n, **i32)
    map_side, merge, cap = _terasort_stages(torch, ts, part, keys, payload)
    _build.reset_launch_counts()
    sk, sp, n_valid = merge()
    torch.cuda.synchronize()
    got = _build.launch_counts()["merge_runs"]
    require(got == 1, f"100 B merge_received launched merge_runs {got}x")
    merge_launches += got
    require(int(n_valid[0]) == n, "100 B stages lost records")
    sk, sp = sk[:n], sp[:n]
    require(bool((sk[1:] >= sk[:-1]).all()), "100 B stages: unsorted")
    rows = sp[:, 0].long()
    require(bool((torch.bincount(rows, minlength=n) == 1).all()),
            "100 B stages: rows are not a permutation of the input")
    require(torch.equal(keys[rows], sk) and torch.equal(payload[rows], sp),
            "100 B stages: rows changed or left their keys")
    del sk, sp, rows
    res = dict(map_ms=cuda_ms(map_side, iters=3),
               merge_ms=cuda_ms(merge, iters=3),
               total_ms=cuda_ms(lambda: (map_side(), merge()), iters=3))
    profile(torch, "exchange_stages_100B", lambda: (map_side(), merge()))
    rec = 4 + 4 * WIDE_WORDS
    phase("exchange_stages", what="terasort_100B", ranks=STAGE_RANKS,
          n_local=n, record_bytes=rec, capacity=cap,
          received=STAGE_RANKS * cap, **res, correct=True)
    del keys, payload, map_side, merge
    torch.cuda.empty_cache()

    n = KEYED_N
    keys = zipf_keys(torch, n, gen, dev)
    vals = torch.randint(-1000, 1000, (n,), generator=gen, **i32)
    valid = torch.ones(n, **i32)
    factor = 2.0  # WordCounter's; doubled on overflow, as its driver does

    def map_side():
        ids = part.hash_partition_ids(keys, STAGE_RANKS)
        return part.partition_to_buckets_dropping(
            ids, valid > 0, (keys, vals, valid), STAGE_RANKS, cap,
            fill_values=(torch.iinfo(torch.int32).max, 0, 0))

    while True:
        cap = _stage_capacity(n, factor)
        (bk, bv, bm), counts = map_side()
        if int(counts.max()) <= cap:
            break
        require(factor < 64, "the keyed buckets overflow at any capacity")
        factor *= 2

    def reduce_side():
        k, v, m, _fill = wc_mod._premask(bk.reshape(-1), bv.reshape(-1),
                                         bm.reshape(-1), 1, cap)
        return seg.reduce_by_key_local(k, v, m)

    outs, launches = _scan_launches(torch, _build, reduce_side)
    require(launches > 0, "the keyed stages did not launch the flagged scan")
    uniq, sums, cnts, n_unique = outs
    oracle = keyed_oracle(torch, keys, vals)
    _check_keyed(torch, dict(uniq=uniq, sums=sums, counts=cnts), oracle,
                 "keyed stages", False)
    require(int(n_unique) == oracle["keys"].numel(), "keyed stages n_unique")
    del outs, uniq, sums, cnts
    res = dict(map_ms=cuda_ms(map_side, iters=3),
               reduce_ms=cuda_ms(reduce_side, iters=3))
    profile(torch, "exchange_stages_keyed", reduce_side)
    phase("exchange_stages", what="keyed", ranks=STAGE_RANKS, n_local=n,
          vocab=VOCAB, zipf_s=ZIPF_S, capacity_factor=factor, capacity=cap,
          received=STAGE_RANKS * cap, max_bucket=int(counts.max()),
          distinct=oracle["keys"].numel(), **res,
          total_ms=res["map_ms"] + res["reduce_ms"], launches=launches,
          correct=True)
    return launches, merge_launches


def _lengths(torch, group, n):
    """Every rank's ``n``, in rank order."""
    t = torch.tensor([n], dtype=torch.int64, device=group.device)
    return group.all_gather(t).reshape(-1).tolist()


def multi_gpu_cases(torch, group, n_sort, n_fact, n_dim, n_ext,
                    pair_bytes=MULTI_PAIR_BYTES, attn_seq=ATTN_S):
    """TeraSort (``n_sort`` records per rank), WordCount, the keyed
    aggregate and grouped top-k (``n_sort`` Zipf keys per rank), the hash
    join, the broadcast join and the fused join+aggregate (``n_fact``
    fact and ``n_dim`` dimension rows per rank) and the external sort
    (``n_ext`` records per rank in chunks) through their host drivers
    on this rank's shard of one seeded input, which every rank draws
    whole and checks its share of against a one-card oracle; the byte
    plane at ``pair_bytes`` per pair against the transposed streams;
    ring and Ulysses attention over ``attn_seq`` against the one-card
    result.  Returns the host seconds of each call."""
    import numpy as np

    from sparkrdma_tpu_torch import HashJoiner, TeraSorter, WordCounter

    import torch.distributed as dist

    rank, world, dev = group.rank, group.size, group.device
    times = {}

    def timed(name, fn):
        dist.barrier(group=group.group)
        t0 = time.monotonic()
        res = fn()
        times[name] = time.monotonic() - t0
        return res

    rng = np.random.default_rng(7)
    keys = rng.integers(0, 1 << 31, n_sort * world, dtype=np.int32)
    vals = rng.integers(0, 1 << 31, n_sort * world, dtype=np.int32)
    mine = slice(rank * n_sort, (rank + 1) * n_sort)
    sk, sv = timed("terasort_s", lambda: TeraSorter(group=group).sort(
        keys[mine], vals[mine]))
    # range partitioning keeps every key on one rank, so rank r's run is
    # the slice of the whole sort after the earlier ranks' runs
    runs = _lengths(torch, group, len(sk))
    require(sum(runs) == n_sort * world, "multi-GPU TeraSort lost records")
    lo = sum(runs[:rank])
    whole = torch.sort(_packed_rows(torch, torch.from_numpy(keys).to(dev),
                                    torch.from_numpy(vals).to(dev))).values
    # values within equal keys come in any order: compare sorted rows
    got = torch.sort(_packed_rows(torch, torch.from_numpy(sk).to(dev),
                                  torch.from_numpy(sv).to(dev))).values
    require(bool((torch.from_numpy(sk[1:]) >= torch.from_numpy(sk[:-1]))
                 .all()), f"rank {rank}: TeraSort run unsorted")
    require(torch.equal(got, whole[lo:lo + len(sk)]),
            f"rank {rank}: TeraSort run is not its slice of the sort")
    del whole, got

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    zk = zipf_keys(torch, n_sort * world, gen, dev)
    counts = timed("wordcount_s", lambda: WordCounter(group=group).count(
        zk[rank * n_sort:(rank + 1) * n_sort].cpu().numpy()))
    uk, uc = torch.unique(zk, return_counts=True)
    owned = torch.tensor(sorted(counts), dtype=torch.int32, device=dev)
    at = torch.searchsorted(uk, owned)
    require(torch.equal(uk[at], owned) and torch.equal(
        uc[at], torch.tensor([counts[k] for k in sorted(counts)],
                             device=dev)),
            f"rank {rank}: WordCount totals differ")
    require(sum(_lengths(torch, group, len(counts))) == uk.numel(),
            "multi-GPU WordCount: keys missing or owned twice")

    fk = rng.integers(0, n_dim * world * 15 // 14, n_fact * world,
                      dtype=np.int32)
    fv = rng.integers(0, 1 << 31, n_fact * world, dtype=np.int32)
    dk = np.arange(n_dim * world, dtype=np.int32)
    dv = rng.integers(0, 1 << 31, n_dim * world, dtype=np.int32)
    fm = slice(rank * n_fact, (rank + 1) * n_fact)
    dm = slice(rank * n_dim, (rank + 1) * n_dim)
    jk, jf, jd = timed("hash_join_s", lambda: HashJoiner(group=group).join(
        fk[fm], fv[fm], dk[dm], dv[dm]))
    require(np.array_equal(jd, dv[jk]), f"rank {rank}: join values differ")
    require(sum(_lengths(torch, group, len(jk)))
            == int((fk < n_dim * world).sum()), "multi-GPU join row count")
    _multi_gpu_sql(torch, group, zk, n_sort, fk, fv, dk, dv, fm, timed)

    _multi_gpu_external_sort(torch, group, n_ext, timed)
    _multi_gpu_byte_plane(torch, group, pair_bytes, timed)
    _multi_gpu_attention(torch, group, attn_seq, timed)
    return times


def _multi_gpu_sql(torch, group, zk, n_sort, fk, fv, dk, dv, fm, timed):
    """The keyed aggregate and grouped top-k on this rank's share of the
    Zipf keys, the broadcast join and the fused join+aggregate on its
    share of the fact rows (the whole dimension table on every rank),
    each against the same model on one card over the whole input."""
    import numpy as np

    from sparkrdma_tpu_torch import (
        BroadcastJoinAggregator,
        BroadcastJoiner,
        GroupedTopK,
        KeyedAggregator,
    )

    rank, world, dev = group.rank, group.size, group.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    zv = torch.randint(-1000, 1000, (zk.numel(),), generator=gen,
                       device=dev, dtype=torch.int32).cpu().numpy()
    zk = zk.cpu().numpy()
    mine = slice(rank * n_sort, (rank + 1) * n_sort)

    def owned_match(got, want, what):
        require(all(want.get(k) == v for k, v in got.items()),
                f"rank {rank}: {what} differs from the one-card result")
        require(sum(_lengths(torch, group, len(got))) == len(want),
                f"multi-GPU {what}: keys missing or owned twice")

    got = timed("aggregate_s", lambda: KeyedAggregator(group=group)
                .aggregate(zk[mine], zv[mine]))
    owned_match(got, KeyedAggregator(device=dev).aggregate(zk, zv),
                "keyed aggregate")
    got = timed("topk_s", lambda: GroupedTopK(group=group).top_k(
        zk[mine], zv[mine], TOPK_K))
    owned_match(got, GroupedTopK(device=dev).top_k(zk, zv, TOPK_K),
                "grouped top-k")
    del zk, zv

    def rows(res):
        return sorted(zip(*(np.asarray(c).tolist() for c in res)))

    got = timed("broadcast_join_s", lambda: BroadcastJoiner(group=group)
                .join(fk[fm], fv[fm], dk, dv))
    require(rows(got) == rows(BroadcastJoiner(device=dev).join(
        fk[fm], fv[fm], dk, dv)),
        f"rank {rank}: broadcast join differs from the one-card join")
    require(sum(_lengths(torch, group, len(got[0])))
            == int((fk < len(dk)).sum()), "multi-GPU broadcast join rows")
    got = timed("join_aggregate_s", lambda: BroadcastJoinAggregator(
        group=group).join_aggregate(fk[fm], fv[fm], dk, dv))
    want = BroadcastJoinAggregator(device=dev).join_aggregate(fk, fv, dk, dv)

    def wrapped(res):
        # one card sums in int32 and wraps; at D > 1 the host merge of
        # the ranks' partials adds unbounded ints (as the JAX package
        # does): compare the sums modulo 2^32
        return {k: (_wrap32(s.sum), s.count, s.min, s.max)
                for k, s in res.items()}

    require(wrapped(got) == wrapped(want), f"rank {rank}: fused "
            "join+aggregate differs from the one-card result")


def _multi_gpu_external_sort(torch, group, n_ext, timed):
    """``ExternalTeraSorter`` over the group: each rank feeds its own
    stream of MULTI_EXT_CHUNKS chunks of its ``n_ext`` records, and
    yields its owned range of each non-empty bucket.  Bucket b of rank r
    must be the slice of the whole sort after buckets < b of every rank
    and bucket b of ranks < r (compared as sorted rows: values within
    equal keys come in any order)."""
    import shutil
    import tempfile

    import numpy as np

    from sparkrdma_tpu_torch import ExternalTeraSorter

    rank, world, dev = group.rank, group.size, group.device
    rng = np.random.default_rng(13)
    keys = rng.integers(0, 1 << 31, n_ext * world, dtype=np.int32)
    vals = rng.integers(0, 1 << 31, n_ext * world, dtype=np.int32)
    mk = keys[rank * n_ext:(rank + 1) * n_ext]
    mv = vals[rank * n_ext:(rank + 1) * n_ext]
    step = n_ext // MULTI_EXT_CHUNKS
    spill = tempfile.mkdtemp(prefix="chip_smoke_extsort_")
    try:
        ext = ExternalTeraSorter(group=group, num_buckets=MULTI_EXT_BUCKETS,
                                 spill_dir=spill)
        outs = timed("external_sort_s", lambda: list(ext.sort_chunks(
            (mk[i:i + step], mv[i:i + step]) for i in range(0, n_ext, step))))
        left = os.listdir(spill)
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    require(not left, f"rank {rank}: external sort left spill files")
    counts = _lengths(torch, group, len(outs))
    require(len(set(counts)) == 1, f"external sort: runs per rank {counts}")
    lens = group.all_gather(torch.tensor(
        [len(k) for k, _ in outs], dtype=torch.int64,
        device=dev)).cpu().reshape(world, -1)
    require(int(lens.sum()) == n_ext * world,
            "multi-GPU external sort lost records")
    whole = torch.sort(_packed_rows(torch, torch.from_numpy(keys).to(dev),
                                    torch.from_numpy(vals).to(dev))).values
    for b, (k, v) in enumerate(outs):
        lo = int(lens[:, :b].sum() + lens[:rank, b].sum())
        require(bool((np.diff(k) >= 0).all()),
                f"rank {rank}: external sort bucket {b} unsorted")
        got = torch.sort(_packed_rows(torch, torch.from_numpy(k).to(dev),
                                      torch.from_numpy(v).to(dev))).values
        require(torch.equal(got, whole[lo:lo + len(k)]),
                f"rank {rank}: external sort bucket {b} is not its slice "
                "of the sort")


def multi_gpu_windowed(torch, group, n_per_rank, out_dir,
                       port=MULTI_PLANE_PORT):
    """The windowed read plane across processes, one executor per rank
    on its own device (``group.device``) over a TCP control plane (rank 0
    also runs the driver), as tests/multihost4_worker.py's first phase
    runs it: config 1's columnar groupByKey of 64 B payloads over 512
    keys at ``n_per_rank`` records per rank, 2 maps per rank, windows of
    one map per rank, every rank reading the partitions it owns through
    ``get_reader`` (its exchange: the initialised world on its device).
    Every rank draws the whole seeded input and checks its groups
    against a numpy oracle; rank 0 then runs the same job co-located,
    ``world`` executors on its one card, and each rank holds its groups
    against that result too.  Returns the host seconds of the
    cross-process read and of the co-located job."""
    import threading

    import numpy as np

    from sparkrdma_tpu_torch.api import TpuShuffleContext
    from sparkrdma_tpu_torch.conf import TpuShuffleConf
    from sparkrdma_tpu_torch.shuffle.manager import (
        ColumnarAggregator,
        ShuffleHandle,
        TpuShuffleManager,
    )
    from sparkrdma_tpu_torch.shuffle.partitioner import HashPartitioner
    from sparkrdma_tpu_torch.transport import TcpNetwork

    import torch.distributed as dist

    rank, world, dev = group.rank, group.size, group.device
    n, words, maps = n_per_rank * world, REC1_PAYLOAD // 8, 2 * world
    rng = np.random.default_rng(0)
    keys = rng.integers(0, REC1_KEYS, n).astype(np.int64)
    vals = np.frombuffer(np.random.default_rng(1).bytes(n * REC1_PAYLOAD),
                         dtype=f"S{REC1_PAYLOAD}")
    bounds = [(i * n) // maps for i in range(maps + 1)]
    part = HashPartitioner(REC1_PARTS)
    agg = ColumnarAggregator.group()
    conf = {"spark.shuffle.tpu.driverPort": port,
            "spark.shuffle.tpu.serializer": "columnar",
            "spark.shuffle.tpu.readPlane": "windowed",
            "spark.shuffle.tpu.bulkWindowMaps": str(world),
            "spark.shuffle.tpu.partitionLocationFetchTimeout": "300s",
            "spark.shuffle.tpu.connectTimeout": "30s"}
    driver = None
    if rank == 0:
        driver = TpuShuffleManager(TpuShuffleConf(dict(conf)),
                                   is_driver=True, network=TcpNetwork(),
                                   port=port, device=dev)
        driver.register_shuffle(1, maps, part, aggregator=agg)
    dist.barrier(group=group.group)  # the driver listens
    ex = TpuShuffleManager(TpuShuffleConf(dict(conf)), is_driver=False,
                           network=TcpNetwork(), port=port + 10 + rank,
                           executor_id=str(rank), device=dev)
    from sparkrdma_tpu_torch.utils.columns import ColumnBatch

    handle = ShuffleHandle(1, maps, part, aggregator=agg)
    mine = [p for p in range(REC1_PARTS) if p % world == rank]
    got, errs = {}, {}

    def reduce_task(p):
        try:
            got[p] = list(ex.get_reader(handle, p, p + 1, {}).read())
        except BaseException as e:
            errs[p] = e

    t0 = time.monotonic()
    ts = [threading.Thread(target=reduce_task, args=(p,)) for p in mine]
    for t in ts:
        t.start()
    for m in (rank, rank + world):
        w = ex.get_writer(handle, m)
        w.write(ColumnBatch(keys[bounds[m]:bounds[m + 1]],
                            vals[bounds[m]:bounds[m + 1]]))
        w.stop(True)
    for t in ts:
        t.join(timeout=600)
    secs = time.monotonic() - t0
    require(not errs and sorted(got) == mine,
            f"rank {rank}: windowed plane failed: {errs}")
    windows = [w for w, _t, _b in ex.windowed_plane.window_events(1)]
    stats = ex.windowed_plane.stats()
    mine_d = _groups_digests(np, [kv for p in mine for kv in got[p]], words)
    del got
    owned = {int(k) for k in range(REC1_KEYS)
             if part.partition(int(k)) % world == rank}
    oracle = _key_digests(np, keys, vals.view(np.uint64).reshape(n, words))
    require(mine_d == {k: oracle[k] for k in owned if k in oracle},
            f"rank {rank}: windowed groups differ from the oracle")
    ex.stop()
    if driver is not None:
        driver.stop()
    colo_s = None
    if rank == 0:
        c = TpuShuffleConf({"spark.shuffle.tpu.serializer": "columnar",
                            "spark.shuffle.tpu.readPlane": "windowed",
                            "spark.shuffle.tpu.bulkWindowMaps": str(world)})
        t0 = time.monotonic()
        with TpuShuffleContext(num_executors=world, conf=c, device=dev,
                               tasks_per_executor=REC1_TASKS) as ctx:
            res = ctx.parallelize_columns(keys, vals, num_slices=maps) \
                .group_by_key(num_partitions=REC1_PARTS).collect()
        colo_s = time.monotonic() - t0
        colo = _groups_digests(np, res, words)
        del res
        require(colo == oracle, "co-located groups differ from the oracle")
        with open(os.path.join(out_dir, "colocated.json"), "w") as f:
            json.dump({str(k): [v[0], v[1].hex(), v[2].hex()]
                       for k, v in colo.items()}, f)
    dist.barrier(group=group.group)
    with open(os.path.join(out_dir, "colocated.json")) as f:
        colo = {int(k): (v[0], bytes.fromhex(v[1]), bytes.fromhex(v[2]))
                for k, v in json.load(f).items()}
    require(mine_d == {k: colo[k] for k in owned if k in colo},
            f"rank {rank}: windowed groups differ from the co-located "
            "result")
    return dict(windowed_plane_s=secs, windows=windows,
                payload_bytes_moved=stats["payload_bytes_moved"],
                rounds_executed=stats["rounds_executed"],
                device_exchanges=stats["device_exchanges"],
                colocated_s=colo_s)


def _multi_gpu_rank(group, out_dir):
    """One NCCL rank of :func:`phase_multi_gpu` (an ``entry.spawn_world``
    target, card ``group.rank``): its times go to
    ``out_dir/rank<rank>.json``."""
    import torch

    times = multi_gpu_cases(torch, group, MULTI_SORT_N, MULTI_FACT_N,
                            MULTI_DIM_N, MULTI_EXT_N)
    times["windowed_plane"] = multi_gpu_windowed(torch, group, REC1_N,
                                                 out_dir)
    with open(os.path.join(out_dir, f"rank{group.rank}.json"), "w") as f:
        json.dump(times, f)


def phase_multi_gpu(torch):
    """TeraSort, WordCount, the keyed aggregate, grouped top-k, the hash
    and broadcast joins, the fused join+aggregate, the external sort, the
    byte plane (``exchange_padded`` full and windowed, ``exchange_into``),
    ring and Ulysses attention and the windowed read plane (one executor
    per card, :func:`multi_gpu_windowed`) over NCCL on min(cards, 4)
    cards, one process per card, each rank against a one-card oracle; a
    failure fails the run.  With one card nothing runs: NCCL refuses two
    ranks on one GPU."""
    import tempfile

    from sparkrdma_tpu_torch.entry import spawn_world

    cards = torch.cuda.device_count()
    if cards < 2:
        out({"phase": "multi_gpu", "ran": False, "cards": cards})
        return
    world = min(cards, 4)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        spawn_world(_multi_gpu_rank, world, "cuda", MULTI_TIMEOUT_S,
                    args=(tmp,))
        times = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                times.append(json.load(f))
    phase("multi_gpu", ran=True, cards=cards, ranks=world,
          sort_records_per_rank=MULTI_SORT_N,
          fact_rows_per_rank=MULTI_FACT_N, dim_rows_per_rank=MULTI_DIM_N,
          external_sort_records_per_rank=MULTI_EXT_N,
          external_sort_chunks_per_rank=MULTI_EXT_CHUNKS,
          external_sort_buckets=MULTI_EXT_BUCKETS,
          byte_plane_pair_bytes=MULTI_PAIR_BYTES, byte_tile=BYTE_TILE,
          attention_heads=ATTN_N, attention_seq=ATTN_S,
          attention_d_head=ATTN_D,
          windowed_plane_records_per_rank=REC1_N,
          windowed_plane=[t.pop("windowed_plane") for t in times],
          seconds_max_over_ranks={k: max(t[k] for t in times)
                                  for k in times[0]}, correct=True)


def phase_dryrun(torch, _build):
    """The port's dry run (``entry.dryrun_multichip``): with three or
    more cards, every data-plane program of the JAX dry run over NCCL on
    min(cards, 8) cards, one process per card, each case held to the
    JAX dry run's assertions, then the record-plane half on card 0; one
    line with the seconds of each case (the maximum over the ranks, to
    the end of its work on the card) and each rank's kernel launches
    over the cases, which must count kernel 1 (WordCount, the keyed
    aggregator) and kernel 3 (ring and Ulysses attention) on every rank.
    With fewer cards the world does not run (the dry run needs three
    ranks, NCCL one card per rank), and the record-plane half
    (``entry.dryrun_record_plane``) runs alone on card 0 at the JAX dry
    run's n = 4: 4 windowed executors and a 3-map bulk session; its
    launches are printed.  A failing case raises out of the phase."""
    from sparkrdma_tpu_torch import entry

    cards = torch.cuda.device_count()
    if cards >= entry.DRYRUN_MIN_RANKS:
        ranks = min(cards, DRYRUN_RANKS)
        t0 = time.monotonic()
        res = entry.dryrun_multichip(ranks)
        secs = time.monotonic() - t0
        for r, counts in enumerate(res["launches"]):
            for name in ("flagged_scan", "block_attention"):
                require(counts.get(name, 0) > 0,
                        f"dry run rank {r} launched no {name}: {counts}")
        rp = res["record_plane"]
        phase("dryrun", ran=True, cards=cards, ranks=ranks,
              rows_per_rank=entry.DRYRUN_ROWS, seconds=secs,
              seconds_max_over_ranks=res["seconds"],
              launches=res["launches"],
              record_plane_seconds=rp["seconds"],
              windowed_stats=rp["windowed_stats"],
              bulk_window_events=rp["bulk_window_events"], correct=True)
        return
    out({"phase": "dryrun", "ran": False, "cards": cards,
         "ranks_needed": entry.DRYRUN_MIN_RANKS})
    t0 = time.monotonic()
    _build.reset_launch_counts()
    rp = entry.dryrun_record_plane(4, device=torch.device("cuda", 0))
    launches = _build.launch_counts()
    phase("dryrun_record_plane", n_ranks=4, windowed_executors=4,
          bulk_maps=3, seconds=time.monotonic() - t0,
          seconds_each=rp["seconds"], windowed_stats=rp["windowed_stats"],
          bulk_window_events=rp["bulk_window_events"],
          bulk_records=len(rp["bulk_records"]), launches=launches,
          correct=True)


def phase_external_sort(torch, ext_mod, seed, dev):
    """``ExternalTeraSorter`` on the card over 2^26 int32 (key, value)
    records in 16 chunks of 2^22 and 64 buckets, spilled under a
    temporary directory, against ``torch.sort``: keys in order, pairs a
    permutation.  The total is cut from larger-than-HBM (the model's
    purpose) to 512 MB to fit the run's time limit; the path is host-
    and disk-bound by design."""
    import shutil
    import tempfile

    import numpy as np

    n = KEYED_N
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 31, n, dtype=np.int32)
    vals = rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int32)
    step = n // EXT_CHUNKS

    def run():
        spill = tempfile.mkdtemp(prefix="chip_smoke_extsort_")
        try:
            sorter = ext_mod.ExternalTeraSorter(device="cuda",
                                                num_buckets=EXT_BUCKETS,
                                                spill_dir=spill)
            outs = list(sorter.sort_chunks(
                (keys[i:i + step], vals[i:i + step])
                for i in range(0, n, step)))
            return sorter, outs, os.listdir(spill)
        finally:
            shutil.rmtree(spill, ignore_errors=True)

    t0 = time.monotonic()
    sorter, outs, left = run()
    secs = time.monotonic() - t0
    require(not left, f"external sort left spill files: {left[:3]}")
    sk = torch.from_numpy(np.concatenate([k for k, _ in outs])).to(dev)
    sv = torch.from_numpy(np.concatenate([v for _, v in outs])).to(dev)
    del outs
    _check_pairs_sorted(torch, torch.from_numpy(keys).to(dev),
                        torch.from_numpy(vals).to(dev), sk, sv,
                        "external sort")
    del sk, sv
    profile(torch, "external_sort", run)
    phase("external_sort", n=n, record_bytes=8, chunks=EXT_CHUNKS,
          buckets=EXT_BUCKETS, seconds=secs, gb_per_s=n * 8 / secs / 1e9,
          bytes_spilled=sorter.bytes_spilled,
          buckets_resplit=sorter.buckets_resplit,
          max_bucket_records=sorter.max_bucket_records,
          cut="total 512 MB (2^26 records), not larger than HBM, to fit "
              "the run's time limit", correct=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from sparkrdma_tpu_torch import _build
        from sparkrdma_tpu_torch import models
        from sparkrdma_tpu_torch.models import _base as base
        # the module: the package exports a function of the same name
        ring_mod = importlib.import_module(
            "sparkrdma_tpu_torch.models.ring_attention")
        from sparkrdma_tpu_torch.models import aggregate as agg_mod
        from sparkrdma_tpu_torch.models import external_sort as ext_mod
        from sparkrdma_tpu_torch.models import join as jmod
        from sparkrdma_tpu_torch.models import join_aggregate as jamod
        from sparkrdma_tpu_torch.models import terasort as ts
        from sparkrdma_tpu_torch.models import topk as tkmod
        from sparkrdma_tpu_torch.models import wordcount as wc_mod
        from sparkrdma_tpu_torch.ops import attention as attn
        from sparkrdma_tpu_torch.ops import merge_kernel as mk
        from sparkrdma_tpu_torch.ops import partition as part
        from sparkrdma_tpu_torch.ops import scan_kernels as scan
        from sparkrdma_tpu_torch.ops import segment as seg
        from sparkrdma_tpu_torch.ops import sort_kernel as sk_mod
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # float32 products in full float32: the plain versions and oracles
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CARD["smi"] = nvidia_smi()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    try:
        phase_build(_build)
        sort_k = phase_block_sort(torch, sk_mod, gen, dev)
        torch.cuda.empty_cache()
        scan_k = phase_scan(torch, scan, gen, dev)
        torch.cuda.empty_cache()
        merge_k = phase_merge_runs(torch, mk, _build, gen, dev)
        torch.cuda.empty_cache()
        keys, vals = phase_terasort(torch, ts, gen, dev)
        torch.cuda.empty_cache()
        phase_terasort_wide(torch, ts, gen, dev)
        torch.cuda.empty_cache()
        phase_entry(torch)
        sort_k["launches"] = phase_sort_engine(torch, sk_mod, _build,
                                               keys, vals)
        del keys, vals
        torch.cuda.empty_cache()
        scan_k["launches"] = phase_keyed(torch, models, base, _build, gen,
                                         dev)
        torch.cuda.empty_cache()
        scan_k["launches"] += phase_join(torch, jmod, _build, gen, dev)
        torch.cuda.empty_cache()
        scan_k["launches"] += phase_tpcds(torch, jmod, jamod, agg_mod,
                                          _build, gen, dev)
        torch.cuda.empty_cache()
        scan_k["launches"] += phase_topk(torch, tkmod, _build, gen, dev)
        torch.cuda.empty_cache()
        phase_partition(torch, part, gen, dev)
        torch.cuda.empty_cache()
        launches, merge_k["launches"] = phase_exchange_stages(
            torch, ts, part, wc_mod, seg, _build, gen, dev)
        scan_k["launches"] += launches
        torch.cuda.empty_cache()
        phase_multi_gpu(torch)
        phase_dryrun(torch, _build)
        torch.cuda.empty_cache()
        check_err = phase_attention_check(torch, attn, gen, dev)
        attn_k = phase_attention_time(torch, attn, gen, dev)
        attn_k["max_abs_err"] = max(attn_k["max_abs_err"], check_err)
        torch.cuda.empty_cache()
        (q, k, v, ring_out), attn_k["launches"] = phase_ring(
            torch, ring_mod, _build, gen, dev)
        torch.cuda.empty_cache()
        phase_ulysses(torch, ring_mod, _build, q, k, v, ring_out)
        phase_ring_fold(torch, attn, ring_mod, q, k, v, ring_out)
        del q, k, v, ring_out
        torch.cuda.empty_cache()
        # after the attention phases: a long profile (these two are
        # host-bound) left torch.profiler without kernel 3's records in
        # the attention profiles after it
        phase_byte_plane(torch, dev)
        torch.cuda.empty_cache()
        loopback = phase_record_plane(torch, dev)
        torch.cuda.empty_cache()
        phase_device_read_plane(torch, dev)
        torch.cuda.empty_cache()
        scan_k["launches"] += phase_host_features(torch, _build, gen, dev)
        torch.cuda.empty_cache()
        scan_k["launches"] += phase_network_plane(torch, _build, dev,
                                                  loopback)
        torch.cuda.empty_cache()
        scan_k["launches"] += phase_device_workloads(torch, _build, gen,
                                                     dev)
        torch.cuda.empty_cache()
        phase_external_sort(torch, ext_mod, args.seed, dev)
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [
        dict(name="bitonic_block_sort", route="cuda",
             source="sparkrdma_tpu_torch/csrc/bitonic_block_sort.cu",
             replaces="sparkrdma_tpu/ops/sort_kernel.py:79", **sort_k),
        dict(name="flagged_scan", route="cuda",
             source="sparkrdma_tpu_torch/csrc/flagged_scan.cu",
             replaces="sparkrdma_tpu/ops/scan_kernels.py:139", **scan_k),
        dict(name="block_attention", route="cuda",
             source="sparkrdma_tpu_torch/csrc/block_attention.cu",
             replaces="sparkrdma_tpu/ops/attention.py:60", **attn_k),
        dict(name="merge_runs", route="cuda",
             source="sparkrdma_tpu_torch/csrc/merge_runs.cu",
             replaces="none (the JAX package merges with lax.sort)",
             **merge_k),
    ]
    keys_order = ["name", "route", "source", "replaces", "launches",
                  "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms"]
    for k in kernels:
        require(all(isinstance(k[f], (int, float)) and math.isfinite(k[f])
                    for f in ("ms", "plain_ms", "bound_ms")), "bad timing")
    # the contract's keys first, then any a kernel adds (kernel 2: both
    # of its bounds)
    out({"kernels": [{**{f: k[f] for f in keys_order},
                      **{f: x for f, x in k.items() if f not in keys_order}}
                     for k in kernels]})
    print(CARD["smi"], flush=True)
    out({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
