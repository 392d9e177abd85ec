"""Fourier-encoded skip-connection MLPs and the nets built on them.

Counterpart of ``neural_raytracing_tpu/nn/mlp.py``.  ``SkipConnMLP``:
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

Also ``TwoStageMLP`` (weight-normed hidden layers, ``HiddenLinear``),
``AutoDecoder`` and ``PartitionedAutoDecoder`` (latent codes conditioning a
SkipConnMLP) and ``DensityEstimator`` (a 2-D Gaussian mixture); none has a
kernel in the JAX package, so all are plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.encoding import fourier_basis, fourier_encode, fourier_size
from ..ops.math import clip, maximum

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


def resolve_activation(act):
    """The activation function of a registered name, or ``act`` itself when
    it is a callable."""
    if callable(act):
        return act
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    return ACTIVATIONS[act]


def activation_name(act) -> Optional[str]:
    """The registry name of an activation (a name, or a registered function
    object), or None for a custom callable."""
    if isinstance(act, str):
        return act
    for name, fn in ACTIVATIONS.items():
        if fn is act:
            return name
    return None


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` of a ``{"w", "b"}`` params dict (the JAX layout)."""
    return x @ params["w"] + params["b"]


def wn_linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The weight-normed layer of a ``{"v", "g", "b"}`` params dict:
    ``w = g * v / max(||v||_0, 1e-12)``, the norm over ``fan_in``."""
    v = params["v"]
    w = params["g"] * v / maximum(torch.linalg.norm(v, dim=0), 1e-12)
    return x @ w + params["b"]


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
                 activation="leaky_relu", init: str = "uniform",
                 zero_out: bool = False, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = check_compute_dtype(compute_dtype)
        self.in_size = in_size
        self.out_size = out
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.skip = skip
        self.freqs = freqs
        self.sigma = sigma
        self.latent_size = latent_size
        # a name or a callable; a custom callable has no name, and the fused
        # kernels (which take the registered activations) run it plain
        self.activation = resolve_activation(activation)
        self.activation_name = activation_name(activation)
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


def prime_identity(mlp: nn.Module, generator: torch.Generator, lr: float = 1e-4,
                   iters: int = 2000, batches: int = 4096) -> torch.Tensor:
    """Pre-train ``mlp`` (in place) to approximate the identity on
    ``[0, 1]^in_size`` (its first ``out_size`` inputs): ``iters`` AdamW
    steps (optax's ``adamw(lr, weight_decay=0.0)``, no clipping) at
    ``batches`` points drawn through ``ops.sampling.uniform``.  Returns the
    last step's loss (a 0-d tensor on the net's device)."""
    from ..ops import sampling
    from ..training.optim import make_optimizer
    device = next(mlp.parameters()).device
    opt = make_optimizer({}, default_lr=lr).init(mlp)
    loss = None
    for _ in range(iters):
        x = sampling.uniform(generator, (batches, mlp.in_size), device)
        loss = torch.mean(torch.square(mlp(x) - x[:, :mlp.out_size]))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return None if loss is None else loss.detach()


class HiddenLinear(Linear):
    """A hidden layer of ``TwoStageMLP``: weight-normed ``{v, g, b}``, with
    ``w = g * v / max(||v||_0, 1e-12)`` (the norm over ``fan_in``, each
    output's column), or plain ``{w, b}``.  The layout is fixed when the
    layer is built: a plain-layout params tree, which the JAX package applies
    as plain whatever the net's flag, loads into a net built with
    ``weight_norm=False``."""

    def __init__(self, fan_in: int, fan_out: int, weight_norm: bool = True):
        super().__init__(fan_in, fan_out)
        self.weight_norm = weight_norm
        if weight_norm:
            del self.w, self.b      # the JAX order: v, g, b
            self.v = nn.Parameter(torch.zeros(fan_in, fan_out))
            self.g = nn.Parameter(torch.zeros(fan_out))
            self.b = nn.Parameter(torch.zeros(fan_out))

    @property
    def _shape(self):
        return tuple((self.v if self.weight_norm else self.w).shape)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator, mode: str):
        """The plain layer's init; weight-normed, ``v`` is its ``w`` and ``g``
        starts at ``||v||_0``, so the layer computes the plain one."""
        if not self.weight_norm:
            return super().reset_parameters(generator, mode)
        plain = Linear(*self._shape).to(self.b.device)
        plain.reset_parameters(generator, mode)
        self.v.copy_(plain.w)
        self.g.copy_(torch.linalg.norm(plain.w, dim=0))
        self.b.copy_(plain.b)

    def weight(self) -> torch.Tensor:
        if not self.weight_norm:
            return self.w
        norm = torch.linalg.norm(self.v, dim=0)
        return self.g * self.v / maximum(norm, 1e-12)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight() + self.b


class TwoStageMLP(nn.Module):
    """Two chained skip-MLP stages with a sigmoid bottleneck between them.

    ``forward(i1[..., in_1], i2[..., in_2]) -> [..., out]``: the first stage
    over the Fourier encoding of ``i1`` narrows to ``intermediate``
    sigmoid units, which the second stage takes beside the encoding of
    ``i2``.  The hidden layers of both stages are weight-normed
    (``HiddenLinear``; ``weight_norm=False`` builds them plain); ``init``,
    ``inter``, ``from_inter`` and ``out`` are plain.
    """

    def __init__(self, in_1: int = 3, in_2: int = 3, intermediate: int = 1,
                 out: int = 3, num_layers: int = 6, hidden_size: int = 128,
                 skip: int = 3, freqs: int = 10, sigma: float = 64.0,
                 activation="relu", init: str = "uniform",
                 weight_norm: bool = True):
        super().__init__()
        self.weight_norm = weight_norm
        self.in_1, self.in_2 = in_1, in_2
        self.intermediate = intermediate
        self.out_size = out
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.skip = skip
        self.freqs = freqs
        self.sigma = sigma
        self.activation = resolve_activation(activation)
        self.init_mode = init
        self.dim_1 = fourier_size(freqs, in_1)
        self.mid_input = intermediate + fourier_size(freqs, in_2)

        self.register_buffer("B1", torch.zeros(in_1, freqs))
        self.register_buffer("B2", torch.zeros(in_2, freqs))
        self.init = Linear(self.dim_1, hidden_size)
        self.layers1 = self._stage(hidden_size + self.dim_1)
        self.inter = Linear(hidden_size, intermediate)
        self.from_inter = Linear(self.mid_input, hidden_size)
        self.layers2 = self._stage(hidden_size + self.mid_input)
        self.out = Linear(hidden_size, out)

    def _stage(self, skip_size: int) -> nn.ModuleList:
        return nn.ModuleList(
            HiddenLinear(skip_size if self.is_skip_layer(i) else self.hidden_size,
                         self.hidden_size, self.weight_norm)
            for i in range(self.num_layers))

    def is_skip_layer(self, i: int) -> bool:
        return (i % self.skip) == 0 and i != self.num_layers - 1

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        for layer in (self.init, *self.layers1, self.inter, self.from_inter,
                      *self.layers2, self.out):
            layer.reset_parameters(generator, self.init_mode)
        self.B1.copy_(fourier_basis(generator, self.freqs, self.in_1, self.sigma))
        self.B2.copy_(fourier_basis(generator, self.freqs, self.in_2, self.sigma))

    def forward(self, i1: torch.Tensor, i2: torch.Tensor) -> torch.Tensor:
        batches = i1.shape[:-1]
        act = self.activation
        enc1 = fourier_encode(i1.reshape(-1, self.in_1), self.B1)
        h = self.init(enc1)
        for i, layer in enumerate(self.layers1):
            if self.is_skip_layer(i):
                h = torch.cat([h, enc1], dim=-1)
            h = layer(act(h))
        h = torch.sigmoid(self.inter(act(h)))
        enc2 = fourier_encode(i2.reshape(-1, self.in_2), self.B2)
        mid = torch.cat([h, enc2], dim=-1)
        h = self.from_inter(mid)
        for i, layer in enumerate(self.layers2):
            if self.is_skip_layer(i):
                h = torch.cat([h, mid], dim=-1)
            h = layer(act(h))
        out = self.out(act(h))
        return out.reshape(batches + (self.out_size,))


class AutoDecoder(nn.Module):
    """A SkipConnMLP conditioned on one learned global code (DeepSDF-style).

    ``forward(p[..., in_size], code=None) -> [..., out]``; without ``code``
    the learned ``code [code_size]`` conditions every point.
    """

    def __init__(self, in_size: int = 3, out: int = 3, num_layers: int = 4,
                 code_size: int = 64, hidden_size: int = 64, skip: int = 3,
                 freqs: int = 8, sigma: float = 64.0,
                 activation: str = "leaky_relu", init: str = "uniform"):
        super().__init__()
        self.code_size = code_size
        self.code = nn.Parameter(torch.zeros(code_size))
        self.mlp = SkipConnMLP(in_size=in_size, out=out, num_layers=num_layers,
                               hidden_size=hidden_size, skip=skip, freqs=freqs,
                               sigma=sigma, latent_size=code_size,
                               activation=activation, init=init)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """The code ``U[0, 1)``, the net as its own init."""
        self.code.copy_(torch.rand(self.code.shape, generator=generator,
                                   device=generator.device))
        self.mlp.reset_parameters(generator)

    def forward(self, p: torch.Tensor, code: Optional[torch.Tensor] = None) -> torch.Tensor:
        code = self.code if code is None else code
        latent = torch.broadcast_to(code, p.shape[:-1] + (self.code_size,))
        return self.mlp(p, latent)


class PartitionedAutoDecoder(nn.Module):
    """A voxel grid of learned codes and one shared decoder MLP.

    Positions in ``[-bound, bound]^3`` (clipped to it) fall into the cells of
    a ``ps^3`` grid; each cell owns a code that conditions the shared net on
    the point's coordinates within the cell.
    """

    def __init__(self, in_size: int = 3, out: int = 3, num_layers: int = 4,
                 code_size: int = 64, partition_size: int = 8,
                 bound: float = 3.0, hidden_size: int = 64, skip: int = 3,
                 freqs: int = 8, sigma: float = 64.0,
                 activation: str = "leaky_relu", init: str = "uniform"):
        super().__init__()
        self.code_size = code_size
        self.ps = partition_size
        self.bound = bound
        self.in_size = in_size
        self.codes = nn.Parameter(torch.zeros(partition_size ** 3, code_size))
        self.mlp = SkipConnMLP(in_size=in_size, out=out, num_layers=num_layers,
                               hidden_size=hidden_size, skip=skip, freqs=freqs,
                               sigma=sigma, latent_size=code_size,
                               activation=activation, init=init)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """The codes ``N(0, 1)``, the net as its own init."""
        self.codes.copy_(torch.randn(self.codes.shape, generator=generator,
                                     device=generator.device))
        self.mlp.reset_parameters(generator)

    def partition(self, p: torch.Tensor):
        """-> (flat cell index [...], coordinates in the cell [..., 3]).  The
        cell is the truncation of the non-negative scaled position, as the
        JAX package's int32 cast, clamped to the grid."""
        ps = self.ps
        xyz = clip(p, -self.bound, self.bound) + self.bound
        inv = (ps - 1) / (2.0 * self.bound)
        idx = torch.clamp((xyz * inv).to(torch.int64), 0, ps - 1)
        local = xyz * inv - idx
        flat = idx[..., 0] + idx[..., 1] * ps + idx[..., 2] * ps * ps
        return flat, local

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        flat, local = self.partition(p.reshape(-1, self.in_size))
        out = self.mlp(local, self.codes[flat])
        return out.reshape(p.shape[:-1] + (self.mlp.out_size,))


class DensityEstimator(nn.Module):
    """A learned mixture of 2-D Gaussians with reparameterized sampling.

    Each component ``k`` has a centre and the lower-triangular scale
    ``[[exp(d0), 0], [a, exp(d1)]]`` from ``vars[k] = (a, d0, d1)``; the
    mixture weights are ``softmax(weights)``.  ``sample(generator, shape)
    -> (values [*shape, 2], pdf [*shape])`` draws one standard normal per
    component through ``ops.sampling.normal`` and mixes the reparameterized
    samples by the weights; ``pdf(val [..., 2]) -> [..., 1]``.  At init
    every component is the unit Gaussian at the origin.
    """

    def __init__(self, in_size: int = 2, dists: int = 32):
        super().__init__()
        if in_size != 2:
            raise ValueError("DensityEstimator is 2-D (in_size=2)")
        self.in_size = in_size
        self.dists = dists
        self.centers = nn.Parameter(torch.zeros(dists, in_size))
        self.vars = nn.Parameter(torch.zeros(dists, 3))
        self.weights = nn.Parameter(torch.zeros(dists))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None):
        for p in (self.centers, self.vars, self.weights):
            p.zero_()

    def _scale_tril(self):
        a = self.vars[:, 0]
        d0 = torch.exp(self.vars[:, 1])
        d1 = torch.exp(self.vars[:, 2])
        zeros = torch.zeros_like(a)
        return torch.stack([torch.stack([d0, zeros], dim=-1),
                            torch.stack([a, d1], dim=-1)], dim=-2)    # [K, 2, 2]

    def _log_prob(self, val: torch.Tensor) -> torch.Tensor:
        """``log N(val; centre_k, L_k L_k^T)`` for each component ``[..., K]``:
        the 2x2 triangular solve in closed form."""
        tril = self._scale_tril()
        diff = val[..., None, :] - self.centers                       # [..., K, 2]
        l00, l10, l11 = tril[:, 0, 0], tril[:, 1, 0], tril[:, 1, 1]
        z0 = diff[..., 0] / l00
        z1 = (diff[..., 1] - l10 * z0) / l11
        maha = z0 * z0 + z1 * z1
        logdet = torch.log(l00) + torch.log(l11)
        return -0.5 * maha - logdet - math.log(2.0 * math.pi)

    def sample(self, generator, shape: tuple):
        from ..ops import sampling
        shape = tuple(shape)
        tril = self._scale_tril()
        eps = sampling.normal(generator, shape + (self.dists, self.in_size),
                              self.centers.device, batch_axis=0)
        samples = self.centers + torch.einsum("kij,...kj->...ki", tril, eps)
        k = torch.softmax(self.weights, dim=-1)
        val = torch.sum(samples * k[:, None], dim=-2)
        pdf = torch.sum(torch.exp(self._log_prob(val)) * k, dim=-1)
        return val, pdf

    def pdf(self, val: torch.Tensor) -> torch.Tensor:
        k = torch.softmax(self.weights, dim=-1)
        return torch.sum(torch.exp(self._log_prob(val)) * k, dim=-1, keepdim=True)
