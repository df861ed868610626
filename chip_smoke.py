#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N]

Builds the hand-written kernels of ``sparkrdma_tpu_torch/csrc`` with
nvcc, holds each kernel against its plain PyTorch version on the card,
drives the port's main paths at full size through their user entry
points (TeraSort 8 B and 100 B records, the two-phase block sort
engine, WordCount and aggregateByKey over Zipf keys, and causal
sequence-parallel attention through ``ring_attention`` and
``ulysses_attention`` on a group of one, 8 heads x 8192 and x 32768,
d_head 128, bfloat16), checks every result against an independent
torch oracle, and shows through the launch counters that the main
paths ran the kernels.  float32 matrix products run without TF32
throughout, so the plain versions and oracles are full float32.

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
# float32 "add" sums in another order in the kernel (sequential per
# thread, then a tree) than in the log-step plain version; segments
# average 1000 values of magnitude <= 1, so the two sums differ by far
# less than this
F32_ADD_ATOL = 1e-3
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
#   max of each 128-key tile and the plain version against the row max
#   (one bfloat16 rounding, 2^-9 relative, per term of the sum).
ATTN_M_TOL = 1e-5
ATTN_L_RTOL = 1e-4
ATTN_O_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
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


def profile(torch, label: str, fn, top: int = 6) -> None:
    """One call of ``fn`` under torch.profiler: device time by kernel
    and the device's idle share of the profiled wall time.  Prints
    "not measured" where the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile as tprofile

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
    (registers, shared memory, spills), and check in the SASS that
    kernel 3's bfloat16 path runs on wgmma (HGMMA) fed by TMA (UTMALDG),
    with no mma.sync (HMMA) left."""
    t0 = time.monotonic()
    _build.load()
    secs = time.monotonic() - t0
    for src, name, used, spill in _ptxas_rows(_build.build_log()):
        if src in ("flagged_scan.cu", "bitonic_block_sort.cu",
                   "block_attention.cu"):
            print(f"# ptxas {src} {name}: {used} | {spill}")
    sass = {k: v for k, v in _sass_counts(_build).items()
            if "attention_bf16" in k}
    require(len(sass) == 2, f"expected two attention_bf16 kernels: {sass}")
    for name, c in sass.items():
        require(c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == 0,
                f"{name}: SASS {c} lacks wgmma or TMA, or has mma.sync")
    phase("build", seconds=secs, sources=[p.name for p in _build.sources()],
          sass_attention_bf16=sass)


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


def phase_scan(torch, scan, gen, dev):
    """Kernel 1 against its plain version: all kinds, 1-3 columns."""
    worst = 0
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
    """Kernel 3 against its plain version: dtypes, d_head, causal, a
    ragged shape, rows masked fully and partly."""
    worst = 0.0
    cases = [(dt, d, causal, n, s_q, s_k, qo, ko)
             for dt in ("bfloat16", "float32") for d in (64, 128)
             for causal in (False, True)
             for n, s_q, s_k, qo, ko in ((4, 2048, 2048, 0, 0),
                                         (3, 1000, 1500, 500, 0))]
    cases += [(dt, 128, True, 3, 1000, 1500, qo, ko)
              for dt in ("bfloat16", "float32")
              for qo, ko in ((0, 1000), (0, 300))]
    # 128-row q tiles straddling the diagonal at nonzero offsets, rows
    # masked throughout, a K block wholly in the future, a ring hop
    cases += [(dt, d, True, n, s_q, s_k, qo, ko)
              for dt in ("bfloat16", "float32") for d in (64, 128)
              for n, s_q, s_k, qo, ko in ((2, 300, 500, 200, 0),
                                          (2, 300, 500, 0, 70),
                                          (2, 300, 500, 0, 400),
                                          (4, 1024, 1536, 1024, 512))]
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
        phase("attention_check", dtype=dt, d_head=d, causal=causal, n=n,
              s_q=s_q, s_k=s_k, q_offset=qo, k_offset=ko, tf32=False,
              m_err=m_err, l_rel_err=l_err, o_err=o_err, o_tol=o_lim)
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


def phase_attention_time(torch, attn, gen, dev):
    """Kernel 3 at the bench shape, with its plain version and SDPA."""
    shape = (ATTN_N, ATTN_S, ATTN_D)
    q, k, v = (_randn(torch, shape, torch.bfloat16, gen, dev)
               for _ in range(3))
    scale = 1.0 / math.sqrt(ATTN_D)
    got = attn.block_attention(q, k, v, 0, 0, True)
    want = attn.block_attention_plain(q, k, v, 0, 0, True, scale)
    _m, _l, err, _lim = _check_partials(torch, got, want, "bfloat16",
                                        "attention at the bench shape")
    del got, want
    ms = cuda_ms(lambda: attn.block_attention(q, k, v, 0, 0, True),
                 iters=10)
    plain = cuda_ms(lambda: attn.block_attention_plain(
        q, k, v, 0, 0, True, scale), iters=2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = cuda_ms(lambda: sdpa(q[None], k[None], v[None], is_causal=True),
                  iters=10)
    b_ms, b_by = _attention_bound(ATTN_N, ATTN_S, ATTN_D, 2)
    unmasked = 4 * ATTN_D * ATTN_N * (ATTN_S * (ATTN_S + 1) // 2)
    phase("attention_time", n=ATTN_N, seq=ATTN_S, d_head=ATTN_D,
          dtype="bfloat16", causal=True, ms=ms, plain_ms=plain,
          library_ms=lib, library="scaled_dot_product_attention "
          "(normalises)", bound_ms=b_ms, bound_by=b_by,
          unmasked_tflop_per_s=unmasked / ms / 1e9, max_abs_err=err)
    del q, k, v
    # long context: the plain version's score matrix (34 GB) does not
    # fit, so the kernel runs beside SDPA alone; phase_ring checks it
    # against the oracle at this length
    shape = (ATTN_N, ATTN_LONG_S, ATTN_D)
    q, k, v = (_randn(torch, shape, torch.bfloat16, gen, dev)
               for _ in range(3))
    long_ms = cuda_ms(lambda: attn.block_attention(q, k, v, 0, 0, True),
                      iters=3)
    long_lib = cuda_ms(lambda: sdpa(q[None], k[None], v[None],
                                    is_causal=True), iters=3)
    lb_ms, lb_by = _attention_bound(ATTN_N, ATTN_LONG_S, ATTN_D, 2)
    unmasked = 4 * ATTN_D * ATTN_N * (ATTN_LONG_S * (ATTN_LONG_S + 1) // 2)
    phase("attention_time", n=ATTN_N, seq=ATTN_LONG_S, d_head=ATTN_D,
          dtype="bfloat16", causal=True, ms=long_ms, plain_ms="not measured",
          library_ms=long_lib, library="scaled_dot_product_attention "
          "(normalises)", bound_ms=lb_ms, bound_by=lb_by,
          unmasked_tflop_per_s=unmasked / long_ms / 1e9)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by)


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
        from sparkrdma_tpu_torch.models import terasort as ts
        from sparkrdma_tpu_torch.ops import attention as attn
        from sparkrdma_tpu_torch.ops import scan_kernels as scan
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
        keys, vals = phase_terasort(torch, ts, gen, dev)
        torch.cuda.empty_cache()
        phase_terasort_wide(torch, ts, gen, dev)
        torch.cuda.empty_cache()
        sort_k["launches"] = phase_sort_engine(torch, sk_mod, _build,
                                               keys, vals)
        del keys, vals
        torch.cuda.empty_cache()
        scan_k["launches"] = phase_keyed(torch, models, base, _build, gen,
                                         dev)
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
