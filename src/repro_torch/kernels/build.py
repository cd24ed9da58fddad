"""Builds the port's CUDA kernels and loads them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``build/<name>-<hash>.so`` at the
root of the checkout; ``<hash>`` covers the sources and the flags, so an
unchanged tree does not rebuild.  All missing libraries are compiled by
concurrent ``nvcc`` processes.  Nothing is built when a module is imported:
the first kernel launch (or :func:`build_all`) builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
KERNELS = ("flash_attention", "layernorm", "lut_softmax", "qmatmul", "ssd_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and on PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> dict[str, dict]:
    """Compile every missing library concurrently; returns, per kernel, its
    library path, build seconds (0 when it was up to date) and the
    compiler's output (ptxas register/shared-memory report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report, procs = {}, {}
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            report[name] = {"lib": str(lib), "seconds": 0.0, "log": ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in procs.items():  # wait for every nvcc started
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
        report[name] = {"lib": str(lib), "seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    return ctypes.CDLL(build_all((name,))[name]["lib"])


def check(err: int, kernel: str) -> None:
    """Raise if a C entry returned a CUDA error (e.g. a refused launch)."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")
