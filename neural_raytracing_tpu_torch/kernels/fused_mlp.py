"""K1: fused Fourier-encode + SkipConnMLP forward, a CUDA kernel for Hopper.

Replaces the TPU kernel ``neural_raytracing_tpu/kernels/fused_mlp.py``
(``_pallas_forward``, body ``_build_kernel``).  The kernel
(``csrc/fused_mlp.cu`` over the device MLP in ``csrc/mlp.cuh``) evaluates a
whole net per block of 32 points with every intermediate in shared memory;
it is bound by the f32 FMA rate.  Its plain version is
``SkipConnMLP.forward`` (``nn/mlp.py``).

Gradients: ``fused_mlp_apply`` wraps the kernel in an ``autograd.Function``
whose backward recomputes through the plain version, as the JAX ``_bwd``
does: the render differentiates the SDF shift net for its normals, and a
backward built from plain ops can itself be differentiated (grad-of-grad for
the eikonal loss).

``FusedSkipConnMLP(mode=...)`` selects the path: "auto" launches the kernel
for CUDA tensors and takes the plain version for CPU tensors, "force"
launches the kernel and raises on CPU tensors, "off" is the plain version.
A latent input always takes the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..nn.mlp import SkipConnMLP, mlp_forward
from ._build import library

MAX_LAYERS = 32   # NRT_MAX_LAYERS in csrc/mlp.cuh
# activation codes of csrc/mlp.cuh
ACT_CODES = {"leaky_relu": 0, "relu": 1, "softplus": 2, "sigmoid": 3,
             "tanh": 4, "elu": 5, "identity": 6}

_I, _P = ctypes.c_int, ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = library("fused_mlp")
    lib.nrt_fused_mlp_forward.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, _I,
                                          _I, _P, _P]
    lib.nrt_fused_mlp_forward.restype = _I
    return lib


def check_cuda_f32(name: str, t: torch.Tensor, shape=None, device=None):
    """Raise unless ``t`` is a contiguous float32 CUDA tensor of ``shape``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def weight_pointers(mlp: SkipConnMLP, basis: torch.Tensor, weights,
                    device: torch.device):
    """Check the net's tensors and pack their addresses in kernel order
    ``[B, init_w, init_b, layer_w, layer_b, ..., out_w, out_b]``."""
    if mlp.latent_size:
        raise ValueError("the fused MLP kernel takes no latent input")
    if mlp.num_layers > MAX_LAYERS:
        raise ValueError(f"the fused MLP kernel takes at most {MAX_LAYERS} "
                         f"layers, got {mlp.num_layers}")
    H = mlp.hidden_size
    shapes = [(mlp.in_size, mlp.freqs), (mlp.enc_size, H), (H,)]
    for i in range(mlp.num_layers):
        shapes += [(mlp.skip_size if mlp.is_skip_layer(i) else H, H), (H,)]
    shapes += [(H, mlp.out_size), (mlp.out_size,)]
    tensors = [basis, *weights]
    if len(tensors) != len(shapes):
        raise ValueError(f"expected {len(shapes)} weight tensors, got {len(tensors)}")
    for i, (t, shape) in enumerate(zip(tensors, shapes)):
        check_cuda_f32(f"weight {i}", t, shape, device)
    return (_P * len(tensors))(*(t.data_ptr() for t in tensors))


def fused_mlp_forward(mlp: SkipConnMLP, x: torch.Tensor, basis: torch.Tensor,
                      weights) -> torch.Tensor:
    """Launch K1: ``x [n, in_size] -> [n, out]`` on CUDA tensors.

    ``weights`` are in ``SkipConnMLP.flat_weights`` order.  Launches on the
    current stream and does not synchronise.
    """
    n = x.shape[0]
    check_cuda_f32("x", x, (n, mlp.in_size))
    ptrs = weight_pointers(mlp, basis, weights, x.device)
    out = torch.empty(n, mlp.out_size, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        rc = _lib().nrt_fused_mlp_forward(
            x.data_ptr(), out.data_ptr(), n, mlp.in_size, mlp.freqs,
            mlp.hidden_size, mlp.num_layers, mlp.skip, mlp.out_size,
            ACT_CODES[mlp.activation_name], ptrs,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_mlp_forward: CUDA error {rc} at launch")
    if n > 0:
        fused_mlp_forward.launches += 1
    return out


fused_mlp_forward.launches = 0


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mlp, x, basis, *weights):
        ctx.mlp = mlp
        ctx.save_for_backward(x, basis, *weights)
        return fused_mlp_forward(mlp, x, basis, weights)

    @staticmethod
    def backward(ctx, g):
        x, basis, *weights = ctx.saved_tensors
        # differentiable backward when the caller asked for a graph of it
        create = torch.is_grad_enabled()
        tensors = [x, basis, *weights]
        needs = ctx.needs_input_grad[1:]
        inputs = [t for t, need in zip(tensors, needs) if need]
        with torch.enable_grad():
            out = mlp_forward(ctx.mlp, x, basis, weights)
            grads = torch.autograd.grad(out, inputs, g, create_graph=create,
                                        allow_unused=True)
        it = iter(grads)
        result = []
        for t, need in zip(tensors, needs):
            gt = next(it) if need else None
            result.append(torch.zeros_like(t) if need and gt is None else gt)
        return (None, *result)


def fused_mlp_apply(mlp: SkipConnMLP, p: torch.Tensor) -> torch.Tensor:
    """``p [..., in_size] -> [..., out]`` through K1, differentiable."""
    batches = p.shape[:-1]
    x = p.reshape(-1, mlp.in_size).contiguous()
    out = _FusedMLP.apply(mlp, x, mlp.B, *mlp.flat_weights())
    return out.reshape(batches + (mlp.out_size,))


class FusedSkipConnMLP(SkipConnMLP):
    """SkipConnMLP that evaluates through K1 on CUDA tensors.

    ``mode``: "auto" (kernel for CUDA tensors, plain version for CPU ones),
    "force" (kernel; raises on CPU tensors) or "off" (plain version).
    """

    def __init__(self, *args, mode: str = "auto", **kwargs):
        super().__init__(*args, **kwargs)
        if mode not in ("auto", "force", "off"):
            raise ValueError(f"mode must be 'auto', 'force' or 'off', got {mode!r}")
        self.mode = mode

    def forward(self, p: torch.Tensor, latent=None) -> torch.Tensor:
        if self.mode == "off" or latent is not None:
            return super().forward(p, latent)
        if not p.is_cuda:
            if self.mode == "force":
                raise RuntimeError("FusedSkipConnMLP(mode='force') needs CUDA "
                                   f"tensors, got one on {p.device}")
            return super().forward(p)
        return fused_mlp_apply(self, p)
