"""ctypes bindings for the native (C++/OpenMP) host geometry ops.

Counterpart of ``neural_raytracing_tpu/native``: ``mesh_intersect``,
``mesh_intersect_test``, ``knn`` and ``ray_point_min_dist`` over the port's
own copy of the host library, ``csrc/nrt_native.cpp``.  The host compiler
(``g++``, with the JAX package's flags) builds it at first use into
``neural_raytracing_tpu_torch/_build/``, under a name that carries a hash of
the source, the flags and the host CPU's features, so an edited source, or
a library built for another CPU, is never served.  A failed build raises.  This is host code, not a CUDA kernel: the
ops take tensors on any device, compute on copies on the host and return
CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

SRC = Path(__file__).resolve().parent.parent / "csrc" / "nrt_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-fopenmp", "-std=c++17")


def _host_cpu() -> str:
    """The host CPU's feature flags: ``-march=native`` builds for them, so a
    library built on another CPU is not reused."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("flags")), "")
    except OSError:
        return platform.processor()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    h.update(_host_cpu().encode())
    return BUILD_DIR / f"libnrt_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is missing; returns its path.  Raises
    RuntimeError with the compiler's output if the compilation fails."""
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on {SRC.name} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        tmp.replace(path)
    return path


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    f32 = ctypes.POINTER(ctypes.c_float)
    i32 = ctypes.POINTER(ctypes.c_int32)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    lib.nrt_mesh_intersect.argtypes = [f32, i64, f32, i32, i64, ctypes.c_float, f32, i32,
                                       f32, f32, u8]
    lib.nrt_mesh_intersect_test.argtypes = [f32, i64, f32, i32, i64, f32, u8]
    lib.nrt_knn.argtypes = [f32, i64, f32, i64, ctypes.c_int32, i32, f32]
    lib.nrt_ray_point_min_dist.argtypes = [f32, i64, f32, i64, f32]
    lib.nrt_native_version.restype = ctypes.c_int
    return lib


def available() -> bool:
    """Whether the library builds and loads (a failed build is False here;
    every op raises it)."""
    try:
        return _lib().nrt_native_version() >= 1
    except (OSError, RuntimeError):
        return False


def _host(x, dtype) -> torch.Tensor:
    return torch.as_tensor(x).detach().to("cpu", dtype).contiguous()


def _ptr(t: torch.Tensor, typ):
    return ctypes.cast(t.data_ptr(), ctypes.POINTER(typ))


def mesh_intersect(rays, verts, faces, max_t: float = float("inf")):
    """Closest hit of rays ``[R, 6]`` on a mesh -> (t ``[R]`` (inf where
    missed), face ``[R]`` int32 (-1), uv ``[R, 2]``, normal ``[R, 3]`` (facing
    the ray origin), hit ``[R]`` bool), on the CPU."""
    rays = _host(rays, torch.float32).reshape(-1, 6)
    verts = _host(verts, torch.float32)
    faces = _host(faces, torch.int32)
    r = rays.shape[0]
    t = torch.empty(r, dtype=torch.float32)
    face = torch.empty(r, dtype=torch.int32)
    uv = torch.empty(r, 2, dtype=torch.float32)
    normal = torch.empty(r, 3, dtype=torch.float32)
    hit = torch.empty(r, dtype=torch.uint8)
    limit = np.float32(min(float(max_t), float(np.finfo(np.float32).max)))
    _lib().nrt_mesh_intersect(
        _ptr(rays, ctypes.c_float), r, _ptr(verts, ctypes.c_float),
        _ptr(faces, ctypes.c_int32), faces.shape[0], ctypes.c_float(limit),
        _ptr(t, ctypes.c_float), _ptr(face, ctypes.c_int32), _ptr(uv, ctypes.c_float),
        _ptr(normal, ctypes.c_float), _ptr(hit, ctypes.c_uint8))
    return t, face, uv, normal, hit.bool()


def mesh_intersect_test(rays, verts, faces, max_t):
    """Any-hit shadow test -> ``[R]`` bool, True where NOT blocked before
    ``max_t`` (a number or ``[R]``), on the CPU."""
    rays = _host(rays, torch.float32).reshape(-1, 6)
    verts = _host(verts, torch.float32)
    faces = _host(faces, torch.int32)
    r = rays.shape[0]
    max_t = _host(max_t, torch.float32).expand(r).contiguous()
    out = torch.empty(r, dtype=torch.uint8)
    _lib().nrt_mesh_intersect_test(
        _ptr(rays, ctypes.c_float), r, _ptr(verts, ctypes.c_float),
        _ptr(faces, ctypes.c_int32), faces.shape[0], _ptr(max_t, ctypes.c_float),
        _ptr(out, ctypes.c_uint8))
    return out.bool()


def knn(points, queries, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force k nearest points -> (idx ``[Q, k]`` int32, squared
    distances ``[Q, k]``), ascending, on the CPU."""
    points = _host(points, torch.float32)
    queries = _host(queries, torch.float32)
    q = queries.shape[0]
    idx = torch.empty(q, k, dtype=torch.int32)
    dist = torch.empty(q, k, dtype=torch.float32)
    _lib().nrt_knn(_ptr(points, ctypes.c_float), points.shape[0],
                   _ptr(queries, ctypes.c_float), q, k,
                   _ptr(idx, ctypes.c_int32), _ptr(dist, ctypes.c_float))
    return idx, dist


def ray_point_min_dist(rays, points) -> torch.Tensor:
    """The distance from each ray ``[R, 6]`` to its nearest point -> ``[R]``,
    on the CPU."""
    rays = _host(rays, torch.float32).reshape(-1, 6)
    points = _host(points, torch.float32)
    out = torch.empty(rays.shape[0], dtype=torch.float32)
    _lib().nrt_ray_point_min_dist(
        _ptr(rays, ctypes.c_float), rays.shape[0], _ptr(points, ctypes.c_float),
        points.shape[0], _ptr(out, ctypes.c_float))
    return out
