"""Multiresolution hash encoding (Instant-NGP style) and the HashSDF surface.

Counterpart of ``neural_raytracing_tpu/nn/hash_encoding.py``:
  * ``HashEncoding``: L levels of hashed voxel features, trilinearly
    interpolated from the 8 corners of the voxel that holds each point,
    every level gathered at once from the ``[L*T, F]`` view of the tables
    (the JAX package's ``stacked=True`` body, which gives the same numbers
    as its per-level loop);
  * ``HashSDF``: the hashed features concatenated with the position, fed to
    a small relu ``SkipConnMLP`` whose output layer starts at zero, plus
    ``|p| - init_sphere_radius``, so the surface starts as that sphere.

The hash is the JAX package's uint32 arithmetic, computed in int64 with each
product masked to 32 bits before the XOR; the table size is a power of two,
so the int64 remainder is the uint32 one.  The float32 operations keep the
JAX order: ``(p + bound) / (2 bound)``, the clip (its tie form, so the
gradient on the bound is JAX's), ``x * res``, ``xl - floor(xl)``.  No
kernel runs this module: its gathers and weights are plain PyTorch, as they
are plain XLA in the JAX package, and ``kernels.fused_march.supports`` is
False for a ``HashSDF``, so ``SDF`` marches it by the plain loops.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.math import clip
from .mlp import SkipConnMLP

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF


class HashEncoding(nn.Module):
    """L-level hashed voxel features with trilinear interpolation.

    ``forward(p[..., 3]) -> [..., levels * features]``, for inputs expected
    in ``[-bound, bound]^3`` (clipped to it).  The tables are one parameter
    ``tables [L, T, F]``.  ``stacked`` is accepted for the JAX signature and
    changes nothing: the one body here is the single gather, whose numbers
    are those of both JAX variants.
    """

    def __init__(self, levels: int = 8, table_size_log2: int = 14,
                 features: int = 2, base_resolution: int = 16,
                 max_resolution: int = 512, bound: float = 2.0,
                 stacked: bool = False):
        super().__init__()
        self.stacked = stacked
        self.levels = levels
        self.table_size = 2 ** table_size_log2
        self.features = features
        self.bound = bound
        # Python floats, as the JAX package computes them
        if levels > 1:
            growth = math.exp(math.log(max_resolution / base_resolution) / (levels - 1))
        else:
            growth = 1.0
        self.resolutions = tuple(int(math.floor(base_resolution * growth ** l))
                                 for l in range(levels))
        self.out_size = levels * features
        self.tables = nn.Parameter(torch.zeros(levels, self.table_size, features))
        # constants that move with the module (made per call on the card, each
        # would be a copy from the host); not part of the state_dict
        self.register_buffer("corners", torch.tensor(
            [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)]), persistent=False)
        self.register_buffer("res", torch.tensor(self.resolutions, dtype=torch.float32),
                             persistent=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """``1e-4 * U(-1, 1)``, as the JAX init."""
        u = torch.rand(self.tables.shape, generator=generator, device=generator.device)
        self.tables.copy_(1e-4 * (2.0 * u - 1.0))

    def hash(self, coords: torch.Tensor) -> torch.Tensor:
        """``[..., 3]`` non-negative int64 voxel coordinates -> table indices:
        the JAX package's uint32 hash, each product masked to 32 bits."""
        h = (coords[..., 0] * _PRIMES[0]) & _MASK32
        h = h ^ ((coords[..., 1] * _PRIMES[1]) & _MASK32)
        h = h ^ ((coords[..., 2] * _PRIMES[2]) & _MASK32)
        return h % self.table_size

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        batches = p.shape[:-1]
        x = (p.reshape(-1, 3) + self.bound) / (2.0 * self.bound)    # [R, 3] in [0, 1]
        x = clip(x, 0.0, 1.0)
        # every level in one gather from the [L*T, F] table, each level's
        # index offset by l*T
        xl = x[:, None, :] * self.res[None, :, None]                 # [R, L, 3]
        base = torch.floor(xl)
        frac = xl - base
        coords = base.to(torch.int64)[:, :, None, :] + self.corners  # [R, L, 8, 3]
        offsets = torch.arange(self.levels, device=p.device) * self.table_size
        idx = self.hash(coords) + offsets[None, :, None]             # [R, L, 8]
        flat = self.tables.reshape(self.levels * self.table_size, self.features)
        feats = flat[idx]                                            # [R, L, 8, F]
        w = torch.prod(torch.where(self.corners == 1, frac[:, :, None, :],
                                   1.0 - frac[:, :, None, :]), dim=-1)
        out = torch.sum(feats * w[..., None], dim=2)                 # [R, L, F]
        return out.reshape(batches + (self.out_size,))


class HashSDF(nn.Module):
    """SDF surface: hash encoding + a small relu MLP.

    The raw position is concatenated with the hashed features, so the
    surface stays defined outside the grid's bound.  The encoding is the
    child ``enc`` (the JAX params key; ``encoding`` is the JAX attribute's
    name), the net the child ``mlp``.
    """

    def __init__(self, encoding: Optional[HashEncoding] = None,
                 hidden_size: int = 64, num_layers: int = 2,
                 init_sphere_radius: float = 0.5):
        super().__init__()
        self.enc = encoding if encoding is not None else HashEncoding()
        self.mlp = SkipConnMLP(in_size=3 + self.enc.out_size, out=1, num_layers=num_layers,
                               hidden_size=hidden_size, freqs=4, sigma=1.0,
                               activation="relu")
        self.init_sphere_radius = init_sphere_radius

    @property
    def encoding(self) -> HashEncoding:
        return self.enc

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.enc.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        # only the output layer is zeroed: the start is the exact sphere, and
        # the hidden relu layers still take gradients
        self.mlp.out.reset_parameters(generator, "zeros")

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        feats = self.enc(p)
        shift = self.mlp(torch.cat([p, feats], dim=-1))[..., 0]
        return torch.linalg.norm(p, dim=-1) - self.init_sphere_radius + shift
