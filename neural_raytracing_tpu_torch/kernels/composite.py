"""K8: NeRF alpha compositing, a CUDA kernel for Hopper, with its plain
version.

K8 replaces the TPU kernel ``neural_raytracing_tpu/kernels/composite.py``
(``_pallas_composite``, body ``_kernel``):
``alpha = 1 - exp(-sigma * t)`` on the absolute sample position ``t``, the
exclusive transmittance ``prod_{j<i} max(1 - alpha_j, 1e-10)`` and
``sum_i alpha_i T_i rgb_i``.  The TPU kernel transposes the samples to the
lane axis and builds the exclusive log-prefix-sum as a triangular matmul on
the MXU, because Mosaic has no cumsum.  The kernel (``csrc/composite.cu``)
keeps the caller's sample-major ``[T, R]`` / ``[T, R, 3]`` layout and splits
each ray's samples into segments, one thread a segment, whose products and
sums meet in a fixed order.  It reads 16 bytes per sample and writes 12 per
ray: it is bound by memory.  ``composite_plain`` is its plain version (the
jnp form of ``shapes/nerf.py``'s ``volumetric_integrate``), which
materialises alpha, the cumprod and the weights in separate passes.

Gradients: ``composite_apply`` wraps K8 in an ``autograd.Function`` whose
backward recomputes through ``composite_plain``, as the JAX ``custom_vjp``
does; the JAX package has no backward kernel for K8.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.math import maximum
from ._build import library
from .fused_mlp import check_cuda_f32, recompute_grads

_I, _P = ctypes.c_int, ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = library("composite")
    lib.nrt_composite.argtypes = [_P, _P, _P, _P, _I, _I, _P]
    lib.nrt_composite.restype = _I
    return lib


def composite_plain(sigma: torch.Tensor, rgb: torch.Tensor,
                    ts: torch.Tensor) -> torch.Tensor:
    """Composite ``[T, ...]`` densities and ``[T, ..., C]`` colours at the
    sample positions ``ts [T]`` -> ``[..., C]``; the plain version of K8."""
    t_exp = ts.reshape((ts.shape[0],) + (1,) * (sigma.dim() - 1))
    alpha = 1.0 - torch.exp(-sigma * t_exp)
    trans = torch.cumprod(maximum(1.0 - alpha, 1e-10), dim=0)
    trans = torch.cat([torch.ones_like(trans[:1]), trans[:-1]], dim=0)
    weights = alpha * trans
    return torch.sum(weights[..., None] * rgb, dim=0)


def fused_composite(sigma: torch.Tensor, rgb: torch.Tensor,
                    ts: torch.Tensor) -> torch.Tensor:
    """Launch K8 on CUDA tensors: ``sigma [T, R]``, ``rgb [T, R, 3]``,
    ``ts [T]`` -> ``[R, 3]``, no gradient.  Launches on the current stream
    and does not synchronise."""
    if sigma.dim() != 2:
        raise ValueError(f"sigma: expected [T, R], got {tuple(sigma.shape)}")
    n_t, n_r = sigma.shape
    check_cuda_f32("sigma", sigma, (n_t, n_r))
    check_cuda_f32("rgb", rgb, (n_t, n_r, 3), sigma.device)
    check_cuda_f32("ts", ts, (n_t,), sigma.device)
    out = torch.empty(n_r, 3, device=sigma.device, dtype=torch.float32)
    with torch.cuda.device(sigma.device):
        rc = _lib().nrt_composite(
            sigma.data_ptr(), rgb.data_ptr(), ts.data_ptr(), out.data_ptr(),
            n_t, n_r, torch.cuda.current_stream(sigma.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_composite: CUDA error {rc} at launch")
    if n_r > 0:
        fused_composite.launches += 1
    return out


fused_composite.launches = 0


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigma, rgb, ts):
        ctx.save_for_backward(sigma, rgb, ts)
        return fused_composite(sigma, rgb, ts)

    @staticmethod
    def backward(ctx, g):
        return tuple(recompute_grads(composite_plain, ctx.saved_tensors,
                                     ctx.needs_input_grad, g))


def composite_apply(sigma: torch.Tensor, rgb: torch.Tensor,
                    ts: torch.Tensor) -> torch.Tensor:
    """``sigma [T, ...]``, ``rgb [T, ..., 3]``, ``ts [T]`` -> ``[..., 3]``
    through K8, differentiable in all three."""
    n_t, batches = sigma.shape[0], sigma.shape[1:]
    out = _Composite.apply(sigma.reshape(n_t, -1).contiguous(),
                           rgb.reshape(n_t, -1, 3).contiguous(),
                           ts.reshape(n_t).contiguous())
    return out.reshape(batches + (3,))
