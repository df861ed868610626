"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``
(pointers and the stream pass as ``c_void_p``).  The build happens at
first use, never at import: the library lands in
``sparkrdma_tpu_torch/_build/<hash>/``, keyed by a hash of the sources
and flags, so a changed source rebuilds and an unchanged one loads the
cached library.  One ``nvcc`` per source runs in parallel, then one
link.

A failed build raises :class:`KernelBuildError`.  Every C entry point
returns ``cudaGetLastError()`` after its launches, and
:func:`check` raises :class:`KernelLaunchError` on a non-zero code.

Launch counters: each kernel wrapper owns a :class:`LaunchCounter` and
bumps it exactly where it launches its kernel, so a run can show that
its main path went through the kernel and not a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional

PKG_DIR = pathlib.Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libsparkrdma_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOCK = threading.Lock()  # lock-order: 87
_LIB: Optional[ctypes.CDLL] = None
_LAST_BUILD: Dict[str, object] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A CUDA entry point returned a non-zero ``cudaError_t``."""


class LaunchCounter:
    """Count of one kernel's launches from its wrapper."""

    registry: Dict[str, "LaunchCounter"] = {}

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        LaunchCounter.registry[name] = self

    def bump(self) -> None:
        self.count += 1


def reset_launch_counts() -> None:
    for c in LaunchCounter.registry.values():
        c.count = 0


def launch_counts() -> Dict[str, int]:
    return {n: c.count for n, c in LaunchCounter.registry.items()}


def sources() -> List[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cand = pathlib.Path(home or "/usr/local/cuda") / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put it on PATH)")


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(out_dir: pathlib.Path) -> pathlib.Path:
    """Compile each ``.cu`` in parallel, link them into one library,
    and move it into ``out_dir`` atomically."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix="tmp-"))
    try:
        procs = []
        objs = []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
            objs.append(obj)
        logs = []
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise KernelBuildError(
                f"nvcc failed on {failed}:\n" + "\n".join(logs)
            )
        lib = tmp / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise KernelBuildError(f"link failed:\n{link.stdout}")
        (tmp / "build.log").write_text("\n".join(logs))
        try:
            os.replace(tmp, out_dir)
        except OSError:
            if not (out_dir / LIB_NAME).is_file():
                raise
        _LAST_BUILD["log"] = "\n".join(logs)
        return out_dir / LIB_NAME
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sr_bitonic_block_sort.argtypes = [p, p, p, p, ll, i, p]
    lib.sr_bitonic_block_sort.restype = i
    lib.sr_bitonic_block_sort_shape.argtypes = [i, p]
    lib.sr_bitonic_block_sort_shape.restype = i
    lib.sr_flagged_scan.argtypes = [
        i, p, p, i, p, p, p, p, p, p, i, i, i, ll, p, p,
    ]
    lib.sr_flagged_scan.restype = i
    lib.sr_flagged_scan_tile.argtypes = [i, i]
    lib.sr_flagged_scan_tile.restype = i
    lib.sr_flagged_scan_scratch_words.argtypes = [ll]
    lib.sr_flagged_scan_scratch_words.restype = ll
    lib.sr_block_attention.argtypes = [
        p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, p,
    ]
    lib.sr_block_attention.restype = i


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out_dir = BUILD_DIR / source_hash()
        path = out_dir / LIB_NAME
        if not path.is_file():
            path = _build(out_dir)
        lib = ctypes.CDLL(str(path))
        _declare(lib)
        _LIB = lib
        return lib


def build_log() -> str:
    """nvcc's output (registers, shared memory, spills) of the build
    this process ran, or of the cached build it loaded."""
    if "log" in _LAST_BUILD:
        return str(_LAST_BUILD["log"])
    log = BUILD_DIR / source_hash() / "build.log"
    return log.read_text() if log.is_file() else ""


def check(rc: int, what: str) -> None:
    if rc:
        raise KernelLaunchError(f"{what}: cudaError_t {rc}")
