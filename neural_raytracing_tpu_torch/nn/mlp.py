"""Fourier-encoded skip-connection MLP.

Counterpart of ``SkipConnMLP`` in ``neural_raytracing_tpu/nn/mlp.py``:
  * the input is Fourier-encoded, ``enc = [x, sin(xB), cos(xB)]``;
  * the activation comes BEFORE each linear layer;
  * on a skip layer (``i % skip == 0 and i != L - 1``) the concatenation
    ``[h, enc]`` is activated and fed to the layer.

Weights keep the JAX layout ``w [fan_in, fan_out]`` and compute ``x @ w + b``,
so the parameter names and shapes match the JAX params pytree
(``init.w``, ``layers.3.b``, ``out.w``, the basis ``B``).

``compute_dtype=torch.bfloat16`` is configuration, not a parameter: the
plain forward rounds the input to bf16, computes the Fourier encoding in
bf16 (``B`` cast to bf16, ``x @ B`` and sin/cos rounded), rounds a latent to
bf16 and computes everything after that in float32, as
``SkipConnMLP.__call__`` of the JAX package does (its bf16 encoding meets
float32 weights and is promoted); the fused kernel K1 rounds
every matmul operand instead (``kernels/fused_mlp.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.encoding import fourier_basis, fourier_encode, fourier_size

class _LeakyReLU(torch.autograd.Function):
    """``F.leaky_relu(x, 0.01)`` (its values, bit for bit) with the gradient
    of ``jax.nn.leaky_relu`` (``where(x >= 0, x, 0.01 x)``): slope 1 at
    ``x == 0``, where torch's own backward takes 0.01.  The backward is
    built from differentiable ops, so the eikonal term's double backward
    goes through it."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.leaky_relu(x, negative_slope=0.01)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, 0.01 * g)


# torch's softplus switches to the identity above 20, jax.nn.softplus does
# not; the difference there is below float32 resolution.
ACTIVATIONS: dict = {
    "leaky_relu": _LeakyReLU.apply,
    "relu": F.relu,
    "softplus": F.softplus,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "elu": F.elu,
    "identity": lambda x: x,
}

# d act / d x, as a function of the pre-activation; the plain backward of the
# fused MLP kernels and ``nrt_dact`` in csrc/mlp.cuh follow this table (the
# JAX package's ``ACTIVATION_GRADS``, plus ELU, which that table lacks).
ACTIVATION_GRADS: dict = {
    "elu": lambda x: torch.where(x > 0, 1.0, torch.exp(x)),
    "leaky_relu": lambda x: torch.where(x >= 0, 1.0, 0.01),
    "relu": lambda x: torch.where(x >= 0, 1.0, 0.0),
    "softplus": torch.sigmoid,
    "sigmoid": lambda x: torch.sigmoid(x) * (1.0 - torch.sigmoid(x)),
    "tanh": lambda x: 1.0 - torch.square(torch.tanh(x)),
    "identity": lambda x: torch.ones_like(x),
}


class Linear(nn.Module):
    """``x @ w + b`` with ``w`` shaped ``[fan_in, fan_out]`` (the JAX layout)."""

    def __init__(self, fan_in: int, fan_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(fan_in, fan_out))
        self.b = nn.Parameter(torch.zeros(fan_out))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator, mode: str):
        """``mode``: 'uniform' (U(+-1/sqrt(fan_in)) for w and b, torch's
        Linear default), 'zeros', or 'xavier' (uniform w, zero b)."""
        fan_in, fan_out = self.w.shape
        if mode == "zeros":
            self.w.zero_()
            self.b.zero_()
            return
        if mode == "xavier":
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            self.w.copy_(_uniform(generator, self.w.shape, limit))
            self.b.zero_()
            return
        if mode != "uniform":
            raise ValueError(f"unknown init mode {mode!r}")
        bound = 1.0 / math.sqrt(fan_in)
        self.w.copy_(_uniform(generator, self.w.shape, bound))
        self.b.copy_(_uniform(generator, self.b.shape, bound))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


def _uniform(generator: torch.Generator, shape, bound: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (2.0 * u - 1.0) * bound


COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def check_compute_dtype(dtype) -> torch.dtype:
    """Return ``dtype`` if it is an operand dtype the port runs (float32 or
    bfloat16), else raise ValueError."""
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype must be torch.float32 or torch.bfloat16, "
                         f"got {dtype!r}")
    return dtype


class SkipConnMLP(nn.Module):
    """Fourier-encoded MLP with periodic skip re-injection of the encoding.

    ``forward(p[..., in_size], latent[..., latent_size]?) -> [..., out]``.
    With ``compute_dtype=torch.float32`` this forward is the plain version
    of the fused kernel (``kernels/fused_mlp.py``).
    """

    def __init__(self, in_size: int = 3, out: int = 3, num_layers: int = 8,
                 hidden_size: int = 64, skip: int = 3, freqs: int = 16,
                 sigma: float = 32.0, latent_size: int = 0,
                 activation: str = "leaky_relu", init: str = "uniform",
                 zero_out: bool = False, compute_dtype=torch.float32):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.compute_dtype = check_compute_dtype(compute_dtype)
        self.in_size = in_size
        self.out_size = out
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.skip = skip
        self.freqs = freqs
        self.sigma = sigma
        self.latent_size = latent_size
        self.activation_name = activation
        self.activation = ACTIVATIONS[activation]
        self.init_mode = init
        # zero only the output layer: the function starts at 0 while the
        # hidden layers keep their gradients
        self.zero_out = zero_out

        self.enc_size = fourier_size(freqs, in_size)
        self.dim_p = self.enc_size + latent_size
        self.skip_size = hidden_size + self.dim_p

        self.register_buffer("B", torch.zeros(in_size, freqs))
        self.init = Linear(self.dim_p, hidden_size)
        self.layers = nn.ModuleList(
            Linear(self.skip_size if self.is_skip_layer(i) else hidden_size,
                   hidden_size)
            for i in range(num_layers))
        self.out = Linear(hidden_size, out)

    def is_skip_layer(self, i: int) -> bool:
        return (i % self.skip) == 0 and i != self.num_layers - 1

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.init.reset_parameters(generator, self.init_mode)
        for layer in self.layers:
            layer.reset_parameters(generator, self.init_mode)
        self.out.reset_parameters(
            generator, "zeros" if self.zero_out else self.init_mode)
        self.B.copy_(fourier_basis(generator, self.freqs, self.in_size,
                                   self.sigma))

    def flat_weights(self) -> list:
        """``[init.w, init.b, layers.0.w, layers.0.b, ..., out.w, out.b]``."""
        ws = [self.init.w, self.init.b]
        for layer in self.layers:
            ws.extend([layer.w, layer.b])
        ws.extend([self.out.w, self.out.b])
        return ws

    def forward(self, p: torch.Tensor,
                latent: Optional[torch.Tensor] = None) -> torch.Tensor:
        return mlp_forward(self, p, self.B, self.flat_weights(), latent)


def mlp_forward(mlp: SkipConnMLP, p: torch.Tensor, basis: torch.Tensor,
                weights: Sequence[torch.Tensor],
                latent: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain SkipConnMLP forward over explicit weights (``flat_weights``
    order), so a kernel's backward can recompute through it.  A bf16
    ``compute_dtype`` computes the Fourier encoding in bf16 and rounds the
    latent to bf16, then runs the rest in float32, as the JAX package's plain
    path does; autograd then runs the encoding's backward in bf16 too and
    rounds the latent's gradient to bf16, as JAX's does."""
    batches = p.shape[:-1]
    x = p.reshape(-1, mlp.in_size)
    # bf16: the encoding in bf16 (B cast, x @ B and sin/cos rounded) and the
    # latent rounded, float32 after
    enc = fourier_encode(x.to(mlp.compute_dtype), basis)
    if latent is not None:
        enc = torch.cat([enc, latent.reshape(-1, mlp.latent_size).to(enc.dtype)],
                        dim=-1)
    enc = enc.to(torch.float32)
    act = mlp.activation
    h = enc @ weights[0] + weights[1]
    for i in range(mlp.num_layers):
        if mlp.is_skip_layer(i):
            h = torch.cat([h, enc], dim=-1)
        h = act(h) @ weights[2 + 2 * i] + weights[3 + 2 * i]
    out = act(h) @ weights[-2] + weights[-1]
    return out.reshape(batches + (mlp.out_size,))
