"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Every ``csrc/*.cu`` file becomes its own shared library with a plain C
interface, compiled for ``sm_90a`` (Hopper) at first use into
``neural_raytracing_tpu_torch/_build/`` (git-ignored).  All sources are
compiled at once, one ``nvcc`` process each.  A library's file name carries a
hash of the sources and flags, so an edited source is never served by a stale
build.  ``-Xptxas -v`` reports (registers, shared memory, spills) are kept
beside each library as ``<name>.log``.

Nothing is fetched and nothing outside the repository is compiled; the only
outside tool is the CUDA toolkit's ``nvcc`` (on ``PATH``, or under
``$CUDA_HOME/bin``).
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if not candidate.exists():
            raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                               "toolkit (set CUDA_HOME or put nvcc on PATH)")
        nvcc = str(candidate)
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_paths() -> dict:
    """``{source stem: Path of its .so}`` for every source in ``csrc/``."""
    tag = _digest()
    return {src.stem: BUILD_DIR / f"lib{src.stem}-{tag}.so"
            for src in sorted(CSRC.glob("*.cu"))}


def build() -> float:
    """Compiles every source whose library is missing, all in parallel.

    Returns the seconds spent (0.0 when everything was built already).
    Raises RuntimeError with nvcc's output if any compilation fails.
    """
    todo = {stem: path for stem, path in library_paths().items()
            if not path.exists()}
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    start = time.perf_counter()
    procs = {}
    for stem, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failures = []
    for stem, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{stem}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {stem}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            tmp.replace(path)
    if failures:
        raise RuntimeError("\n".join(failures))
    return time.perf_counter() - start


@functools.cache
def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first use)."""
    build()
    return ctypes.CDLL(str(library_paths()[stem]))


def ptxas_report(stem: str) -> str:
    """The ptxas lines (registers, shared memory, spills) of the last build."""
    log = BUILD_DIR / f"{stem}.log"
    if not log.exists():
        return ""
    return "\n".join(line for line in log.read_text().splitlines()
                     if "ptxas" in line or "spill" in line)

