"""K5: the fused SphereSDF evaluation, a CUDA kernel for Hopper, with its
plain version and the drop-in surface module ``FusedSphereSDF``.

K5 replaces the TPU kernel ``neural_raytracing_tpu/kernels/fused_sdf.py``
(``_pallas_forward``, body ``_build_kernel``): the smooth-min of the 128
transformed spheres (clamped, or exact with ``stable_min``) plus the shift
MLP, one value per point.  It never writes the ``[points, spheres, 3]``
transformed points the plain version builds.  It is bound by the f32 FMA
rate of the shift MLP.  ``csrc/fused_sdf.cu`` holds two routes, picked by
shape before the launch (``k5_route``): the tile, where the shift net runs
as K1's f32 kernel runs it (``csrc/mlp_tiled.cuh``, the weights from K1's
cached pack, ``tile_pointers``), and the general route over the device MLP
of ``csrc/mlp.cuh`` for a net off the tile.  Both give the same bits.  Its
plain version is ``sphere_sdf_plain``, which computes ``SphereSDF.forward``
over explicit tensors.

Gradients: ``fused_sphere_sdf_apply`` wraps K5 in an ``autograd.Function``
whose backward recomputes through the plain version, as the JAX
``custom_vjp`` does.  That backward is built from plain ops, so it can itself
be differentiated: the training step's eikonal loss differentiates the
normals a second time.

``FusedSphereSDF(mode=...)``: "auto" launches K5 for CUDA tensors and takes
the plain version for CPU tensors, "force" launches K5 and raises on CPU
tensors, "off" is the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch import nn

from ..nn.mlp import SkipConnMLP, mlp_forward
from ..ops.math import smooth_min, stable_smooth_min
from ._build import library
from .fused_mlp import ACT_CODES, ROUTES, check_cuda_f32, k1_route, recompute_grads, tile_pointers

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_SPHERES = [_P, _P, _P, _I, _F, _I]               # tfs, centers, radii, n, k, stable


def _lib() -> ctypes.CDLL:
    lib = library("fused_sdf")
    lib.nrt_fused_sphere_sdf.argtypes = [
        _P, _P, _I, *_SPHERES,                    # points, output, n, sphere set
        _I, _I, _I, _I, _I, _I, _I, _P,           # shift MLP
        _P]                                       # stream
    lib.nrt_fused_sdf_tile.argtypes = [
        _P, _P, _I, *_SPHERES,                    # points, output, n, sphere set
        _I, _I, _I, _I, _I, _P,                   # shift net (freqs .. act), packed table
        _P]                                       # stream
    lib.nrt_fused_sdf_tile_info.argtypes = [_I, _I, ctypes.POINTER(_I)]
    for fn in (lib.nrt_fused_sphere_sdf, lib.nrt_fused_sdf_tile, lib.nrt_fused_sdf_tile_info):
        fn.restype = _I
    return lib


# points a block of the tile takes (NRT_K5_ROWS of csrc/fused_sdf.cu)
K5_ROWS = 64


def k5_tile_spheres(np_width: int) -> int:
    """The most spheres the tile takes at ``np_width`` (128 or 256) columns:
    the sphere set (13 floats a sphere, padded to 16 bytes) and the
    ``K5_ROWS`` points borrow the activation buffer's h rows
    (``nrt_k5_fits`` of ``csrc/fused_sdf.cu``)."""
    room = np_width * (K5_ROWS + 4) - 3 * K5_ROWS
    return (room // 4 * 4) // 13


def k5_route(module) -> str:
    """The K5 kernel ``module`` takes, by its shape: "tile" where K1's tile
    takes the shift net (``k1_route``) and the tile's h rows hold the
    sphere set, else "general".  Raises ValueError, before anything touches
    a device, for a surface neither takes."""
    from .fused_march import supports
    if not supports(module):
        raise ValueError("fused_sphere_sdf supports SphereSDF surfaces with a "
                         "3 -> 1 shift net and no latent")
    mlp = module.shift
    np_width = 128 if mlp.hidden_size <= 128 else 256
    if (k1_route(mlp) == "tile"
            and module.centers.shape[0] <= k5_tile_spheres(np_width)):
        return "tile"
    return "general"


def sphere_min_plain(module, p: torch.Tensor, centers: torch.Tensor,
                     radii: torch.Tensor, tfs: torch.Tensor) -> torch.Tensor:
    """The smooth-min of the SphereSDF's transformed spheres (clamped, or
    exact with ``stable_min``) at ``p [..., 3]`` -> ``[...]``."""
    flat = p.reshape(-1, 3)
    tf = tfs + torch.eye(3, dtype=flat.dtype, device=flat.device)
    q = torch.einsum("ijk,bk->ibj", tf, flat) - centers[:, None, :]
    sd = torch.linalg.norm(q, dim=-1) - radii[:, None]
    mn = stable_smooth_min if module.stable_min else smooth_min
    return mn(sd, k=module.k, dim=0).reshape(p.shape[:-1])


def sphere_sdf_plain(module, p: torch.Tensor, centers: torch.Tensor,
                     radii: torch.Tensor, tfs: torch.Tensor,
                     basis: torch.Tensor, weights) -> torch.Tensor:
    """The plain SphereSDF forward over explicit tensors (``weights`` in
    ``SkipConnMLP.flat_weights`` order) -> ``[...]``; the plain version of
    K5, and what its backward recomputes."""
    return (sphere_min_plain(module, p, centers, radii, tfs)
            + mlp_forward(module.shift, p, basis, weights)[..., 0])


def fused_sphere_sdf(module, p: torch.Tensor, *, route=None) -> torch.Tensor:
    """Launch K5 on CUDA tensors: ``p [..., 3] -> [...]``, no gradient,
    through ``k5_route(module)``'s kernel.  For measuring, ``route="general"``
    runs the first kernel on a tile net.  Launches on the current stream and
    does not synchronise."""
    from .fused_march import _sphere_set, _spheres
    chosen = k5_route(module)
    route = chosen if route is None else route
    if route not in ROUTES or (route == "tile" and chosen != "tile"):
        raise ValueError(f"fused_sphere_sdf: route {route!r} does not take this "
                         f"surface (its route is {chosen!r})")
    batches = p.shape[:-1]
    x = p.detach().reshape(-1, 3).contiguous()
    n = x.shape[0]
    check_cuda_f32("p", x, (n, 3))
    out = torch.empty(n, device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if route == "tile":
            spheres, _tensors = _spheres(module, x.device)   # alive until the launch
            mlp = module.shift
            ptrs = tile_pointers(mlp, mlp.B, mlp.flat_weights(), x.device)
            rc = _lib().nrt_fused_sdf_tile(
                x.data_ptr(), out.data_ptr(), n, *spheres, mlp.freqs,
                mlp.hidden_size, mlp.num_layers, mlp.skip, ACT_CODES[mlp.activation_name],
                ptrs, stream)
        else:
            spheres, _tensors = _sphere_set(module, x.device)
            rc = _lib().nrt_fused_sphere_sdf(x.data_ptr(), out.data_ptr(), n, *spheres,
                                             stream)
    if rc != 0:
        raise RuntimeError(f"fused_sphere_sdf: CUDA error {rc} at launch")
    if n > 0:
        fused_sphere_sdf.launches += 1
        fused_sphere_sdf.route_launches[route] += 1
    return out.reshape(batches)


@functools.lru_cache(maxsize=None)
def _tile_info(freqs: int, hidden: int, device: int) -> dict:
    info = (_I * 4)()
    with torch.cuda.device(device):
        rc = _lib().nrt_fused_sdf_tile_info(freqs, hidden, info)
    if rc != 0 or info[0] <= 0:
        raise RuntimeError(f"nrt_fused_sdf_tile_info: CUDA error {rc}, {info[0]} blocks per SM")
    return dict(blocks_per_sm=info[0], registers=info[1], local_bytes=info[2],
                smem_bytes=info[3])


def k5_tile_info(module, device=None) -> dict:
    """K5's tile kernel for ``module`` on the CUDA ``device`` (the current
    one by default), as the library reports it: ``blocks_per_sm``,
    ``registers`` and ``local_bytes`` a thread, ``smem_bytes`` a block."""
    if k5_route(module) != "tile":
        raise ValueError("k5_tile_info: this surface is off the tile")
    index = torch.cuda.current_device() if device is None else torch.device(device).index
    mlp = module.shift
    return _tile_info(mlp.freqs, mlp.hidden_size, index)


fused_sphere_sdf.launches = 0
fused_sphere_sdf.route_launches = dict.fromkeys(ROUTES, 0)


class _FusedSDF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, module, p, centers, radii, tfs, basis, *weights):
        ctx.module = module
        ctx.save_for_backward(p, centers, radii, tfs, basis, *weights)
        return fused_sphere_sdf(module, p)

    @staticmethod
    def backward(ctx, g):
        def plain(p, centers, radii, tfs, basis, *weights):
            return sphere_sdf_plain(ctx.module, p, centers, radii, tfs, basis, weights)
        return (None, *recompute_grads(plain, ctx.saved_tensors,
                                       ctx.needs_input_grad[1:], g))


def fused_sphere_sdf_apply(module, p: torch.Tensor) -> torch.Tensor:
    """``p [..., 3] -> [...]`` through K5, differentiable in ``p`` and the
    module's parameters."""
    mlp = module.shift
    return _FusedSDF.apply(module, p, module.centers, module.radii, module.tfs,
                           mlp.B, *mlp.flat_weights())


class FusedSphereSDF(nn.Module):
    """SphereSDF evaluated by K5 on CUDA tensors.

    The parameters are named as ``SphereSDF``'s (``centers``, ``radii``,
    ``tfs``, ``shift.*``), so a checkpoint loads into either.  The default
    shift is the plain ``SkipConnMLP`` 8x128, 32 frequencies, softplus,
    zero init: the whole evaluation is fused here.
    """

    def __init__(self, n: int = 128, k: float = 32.0,
                 mlp: Optional[SkipConnMLP] = None, mode: str = "auto",
                 stable_min: bool = False):
        super().__init__()
        if mode not in ("auto", "force", "off"):
            raise ValueError(f"mode must be 'auto', 'force' or 'off', got {mode!r}")
        self.n = n
        self.k = k
        self.stable_min = stable_min
        self.mode = mode
        self.centers = nn.Parameter(torch.zeros(n, 3))
        self.radii = nn.Parameter(torch.zeros(n))
        self.tfs = nn.Parameter(torch.zeros(n, 3, 3))
        if mlp is None:
            mlp = SkipConnMLP(in_size=3, out=1, num_layers=8, hidden_size=128,
                              freqs=32, activation="softplus", init="zeros")
        self.shift = mlp

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        from ..shapes.sdf import SphereSDF
        SphereSDF.reset_parameters(self, generator)

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        if self.mode == "off" or (not p.is_cuda and self.mode == "auto"):
            return sphere_sdf_plain(self, p, self.centers, self.radii, self.tfs,
                                    self.shift.B, self.shift.flat_weights())
        if not p.is_cuda:
            raise RuntimeError("FusedSphereSDF(mode='force') needs CUDA tensors, "
                               f"got one on {p.device}")
        return fused_sphere_sdf_apply(self, p)
