#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N]

Builds the hand-written kernels of ``sparkrdma_tpu_torch/csrc`` with
nvcc, holds each kernel against its plain PyTorch version on the card,
drives the port's main paths at full size through their user entry
points (TeraSort 8 B and 100 B records, the two-phase block sort
engine, WordCount and aggregateByKey over Zipf keys), checks every
result against an independent torch oracle, and shows through the
launch counters that the main paths ran the kernels.

Each phase prints one JSON line with its times (CUDA events) and the
card's name and power limit.  Then one line lists the kernels, one line
gives ``nvidia-smi``'s name and power limit, and the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
that line; so does a host without CUDA or a directory without the
package.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
VECTOR_OPS_PER_S = 67e12    # non-tensor float32 rate; int32 ALU ops use it
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


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / VECTOR_OPS_PER_S * 1e3
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


def phase_build(_build):
    t0 = time.monotonic()
    _build.load()
    secs = time.monotonic() - t0
    ptxas = [ln.strip() for ln in _build.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    for ln in ptxas:
        print("# ptxas " + ln)
    phase("build", seconds=secs, sources=[p.name for p in _build.sources()])


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


def phase_block_sort(torch, sk_mod, gen, dev):
    """Kernel 2 against its plain version, bit for bit."""
    worst = 0
    cases = [("random", SORT_N, 512)] + [
        (c, 1 << 22, br)
        for c in ("all_equal", "int32_extremes", "reversed", "few_distinct")
        for br in (512, 1024)
    ]
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
    B = 512 * 128
    ms = cuda_ms(lambda: sk_mod.sort_pairs_blocks(k, v, block_rows=512))
    plain = cuda_ms(lambda: sk_mod.block_sort_plain(k, v, block_rows=512),
                    iters=2)
    lib = cuda_ms(lambda: torch.sort(k.view(-1, B), dim=1))
    log_b = B.bit_length() - 1
    compares = SORT_N // 2 * log_b * (log_b + 1) // 2
    b_ms, b_by = bound_ms(16 * SORT_N, compares)
    phase("block_sort_time", n=SORT_N, block_rows=512, ms=ms, plain_ms=plain,
          library_ms=lib, bound_ms=b_ms, bound_by=b_by,
          gb_per_s=16 * SORT_N / ms / 1e6)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by)


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
        from sparkrdma_tpu_torch.models import terasort as ts
        from sparkrdma_tpu_torch.ops import scan_kernels as scan
        from sparkrdma_tpu_torch.ops import sort_kernel as sk_mod
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
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
    ]
    keys_order = ["name", "route", "source", "replaces", "launches",
                  "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms"]
    for k in kernels:
        require(all(isinstance(k[f], (int, float)) and math.isfinite(k[f])
                    for f in ("ms", "plain_ms", "bound_ms")), "bad timing")
    out({"kernels": [{f: k[f] for f in keys_order} for k in kernels]})
    print(CARD["smi"], flush=True)
    out({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
