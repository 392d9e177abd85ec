"""Learned distribution warps: NeuralWarp, MipMap, SphericalHarmonics.

Counterpart of ``neural_raytracing_tpu/warps.py``:
  * ``NeuralWarp``: a ``DensityEstimator`` over uv, mapped to directions by
    ``uv_to_dir(tanh(val))``; ``prime`` fits its density to a target pdf
    (the cosine hemisphere's by default) by BCE on random sphere directions;
  * ``MipMap``: one learned weight per leaf of a depth-d alternating
    bisection of the unit square; ``pdf`` finds a point's leaf by binary
    descent, ``sample`` picks a leaf (a Gumbel-argmax, as
    ``jax.random.categorical``) and jitters uniformly inside it;
  * ``legendre`` and ``SphericalHarmonics``: the Legendre recursion and the
    real SH basis with learnable coefficients, fitted by least squares.
Every draw goes through ``ops.sampling``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from .bsdf.bsdfs import gumbel_argmax
from .nn.mlp import DensityEstimator
from .ops import sampling
from .ops.dirs import uv_to_dir
from .ops.math import clip, maximum, normalize
from .ops.warps import random_on_sphere, square_to_cos_hemisphere_pdf


class NeuralWarp(nn.Module):
    """Learned square -> direction warp by a mixture-density estimator
    (the child ``estim``)."""

    def __init__(self, dists: int = 32):
        super().__init__()
        self.estim = DensityEstimator(dists=dists)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None):
        self.estim.reset_parameters(generator)

    def sample(self, generator, shape: tuple):
        """-> (directions [*shape, 3], pdf [*shape])."""
        val, pdf = self.estim.sample(generator, shape)
        return uv_to_dir(torch.tanh(val)), pdf

    def pdf(self, val: torch.Tensor) -> torch.Tensor:
        return self.estim.pdf(val)

    def prime(self, generator, iters: int = 2000, batches: int = 4096, lr: float = 1e-3,
              compare_to: Callable = square_to_cos_hemisphere_pdf):
        """Fit the density to ``compare_to`` in place: ``iters`` AdamW steps
        (optax's ``adamw(lr, weight_decay=0)``, no clipping) of the BCE
        between the clipped estimate and target at ``batches`` random sphere
        directions.  Returns the last step's loss (0-d, on the warp's
        device)."""
        from .training.optim import make_optimizer
        device = self.estim.centers.device
        opt = make_optimizer({}, default_lr=lr).init(self)
        loss = None
        for _ in range(iters):
            d, uv = random_on_sphere(generator, batches, device)
            est = clip(self.estim.pdf(uv)[..., 0], 1e-7, 1.0 - 1e-7)
            real = clip(torch.broadcast_to(torch.as_tensor(compare_to(d), device=device),
                                           est.shape), 0.0, 1.0)
            loss = torch.mean(-(real * torch.log(est) + (1.0 - real) * torch.log(1.0 - est)))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        return None if loss is None else loss.detach()


class MipMap(nn.Module):
    """Hierarchical binary-partition 2-D warp with learned cell weights.

    The unit square is split ``depth`` times (alternating: first y, then
    x); each of the ``2**depth`` leaves carries a weight, ``softmax`` of the
    parameter ``percents``.
    """

    def __init__(self, depth: int = 4):
        super().__init__()
        self.depth = depth
        self.n = 2 ** depth
        self.percents = nn.Parameter(torch.zeros(self.n))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.percents.copy_(torch.randn(self.percents.shape, generator=generator,
                                        device=generator.device))

    def _leaf_index(self, val01: torch.Tensor) -> torch.Tensor:
        """``[..., 2]`` in ``[0, 1]^2`` -> leaf index by alternating bisection."""
        idx = torch.zeros(val01.shape[:-1], dtype=torch.int64, device=val01.device)
        x, y = val01[..., 0], val01[..., 1]
        for d in range(self.depth):
            if d % 2 == 0:
                upper = y >= 0.5
                y = torch.where(upper, (y - 0.5) * 2.0, y * 2.0)
            else:
                upper = x >= 0.5
                x = torch.where(upper, (x - 0.5) * 2.0, x * 2.0)
            idx = idx * 2 + upper.to(torch.int64)
        return idx

    def pdf(self, val: torch.Tensor) -> torch.Tensor:
        """Density at ``val`` in ``[-1, 1]^2`` (the leaf's weight x the leaf
        count: normalized over the unit square)."""
        w = torch.softmax(self.percents, dim=-1)
        idx = self._leaf_index(clip((val + 1.0) / 2.0, 0.0, 1.0))
        return w[idx] * self.n

    def sample(self, generator, shape: tuple):
        """-> (values [*shape, 2] in ``[-1, 1]^2``, pdf [*shape]): a leaf
        ``~ softmax(percents)`` by a Gumbel-argmax (one uniform a leaf), then a
        uniform point in it."""
        shape = tuple(shape)
        device = self.percents.device
        w = torch.softmax(self.percents, dim=-1)
        leaf = gumbel_argmax(generator, w.expand(shape + (self.n,)))
        jitter = sampling.uniform(generator, shape + (2,), device)
        # the leaf's cell from its bit path
        x0 = torch.zeros(shape, device=device)
        y0 = torch.zeros(shape, device=device)
        sx = torch.ones(shape, device=device)
        sy = torch.ones(shape, device=device)
        for d in range(self.depth):
            bit = (leaf >> (self.depth - 1 - d)) & 1
            if d % 2 == 0:
                sy = sy / 2.0
                y0 = y0 + bit * sy
            else:
                sx = sx / 2.0
                x0 = x0 + bit * sx
        uv = torch.stack([x0 + jitter[..., 0] * sx, y0 + jitter[..., 1] * sy], dim=-1)
        return uv * 2.0 - 1.0, w[leaf] * self.n


def legendre(x: torch.Tensor, up_to_order: int) -> torch.Tensor:
    """Legendre polynomials ``P_0 .. P_{n-1}(x)``, stacked on axis 0."""
    out = [torch.ones_like(x), x]
    for n in range(1, up_to_order - 1):
        out.append(((2 * n + 1) * x * out[-1] - n * out[-2]) / (n + 1))
    return torch.stack(out[:up_to_order])


def _assoc_legendre(l: int, m: int, x: torch.Tensor) -> torch.Tensor:
    """Associated Legendre ``P_l^m(x)`` by the standard recurrences."""
    pmm = torch.ones_like(x)
    if m > 0:
        somx2 = torch.sqrt(maximum(1.0 - x * x, 0.0))
        fact = 1.0
        for _ in range(m):
            pmm = -pmm * fact * somx2
            fact += 2.0
    if l == m:
        return pmm
    pmmp1 = x * (2 * m + 1) * pmm
    if l == m + 1:
        return pmmp1
    for ll in range(m + 2, l + 1):
        pll = ((2 * ll - 1) * x * pmmp1 - (ll + m - 1) * pmm) / (ll - m)
        pmm, pmmp1 = pmmp1, pll
    return pmmp1


class SphericalHarmonics(nn.Module):
    """Real spherical-harmonics basis of ``order`` bands with learnable
    coefficients ``coeffs [order^2]``; ``forward(d) = basis(d) . coeffs``."""

    def __init__(self, order: int = 3):
        super().__init__()
        self.order = order
        self.n_coeffs = order * order
        self.coeffs = nn.Parameter(torch.zeros(self.n_coeffs))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None):
        self.coeffs.zero_()

    def basis(self, d: torch.Tensor) -> torch.Tensor:
        """The real SH basis ``[..., order^2]`` at the directions ``d``."""
        d = normalize(d)
        x, y, z = d[..., 0], d[..., 1], d[..., 2]
        phi = torch.atan2(y, x)
        out = []
        for l in range(self.order):
            for m in range(-l, l + 1):
                am = abs(m)
                norm = math.sqrt((2 * l + 1) / (4 * math.pi)
                                 * math.factorial(l - am) / math.factorial(l + am))
                p = _assoc_legendre(l, am, z)
                if m > 0:
                    out.append(math.sqrt(2.0) * norm * torch.cos(m * phi) * p)
                elif m < 0:
                    out.append(math.sqrt(2.0) * norm * torch.sin(am * phi) * p)
                else:
                    out.append(norm * p)
        return torch.stack(out, dim=-1)

    def forward(self, d: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.basis(d) * self.coeffs, dim=-1)

    @torch.no_grad()
    def fit(self, dirs: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
        """Least-squares coefficients for the samples ``(dirs [N, 3], values
        [N])``, set in place and returned.  On CUDA tensors torch's only
        solver (LAPACK's ``gels``) assumes the basis has full rank: give it
        well-spread directions."""
        coeffs = torch.linalg.lstsq(self.basis(dirs), values[:, None]).solution[:, 0]
        self.coeffs.copy_(coeffs)
        return coeffs
