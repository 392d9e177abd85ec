"""Samplers: a stateful uniform sampler and stratified orthogonal-array
sampling.

Counterpart of ``neural_raytracing_tpu/samplers.py``:
  * ``Sampler``: independent uniforms from a ``torch.Generator`` it holds,
    drawn through ``ops.sampling.uniform``;
  * ``permute_kensler``: Kensler's hash-based permutation of ``[0,
    samples)``, the JAX package's uint32 rounds computed in int64 with each
    product, sum and shift masked to 32 bits;
  * ``OrthogonalSampler``: the Bose orthogonal-array construction of
    strength 2.  As in the JAX package, its third dimension (``dim = 2``)
    raises ``OverflowError``: the permutation seed ``(dim + 1) *
    0x68BC21EB`` no longer fits in 32 bits.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .ops import sampling

_MASK32 = 0xFFFFFFFF


class Sampler:
    """Independent uniform sampler over a stateful generator (seeded with
    ``seed`` unless one is given)."""

    def __init__(self, generator: Optional[torch.Generator] = None, seed: int = 0):
        self.generator = (generator if generator is not None
                          else torch.Generator().manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def sample(self, shape, dtype=torch.float32) -> torch.Tensor:
        return sampling.uniform(self.generator, tuple(shape), self.device).to(dtype)


def _uint32(value: int) -> int:
    """``value`` as the JAX package's ``jnp.uint32(value)`` takes it: out of
    range raises ``OverflowError``."""
    if not 0 <= value <= _MASK32:
        raise OverflowError(f"Python integer {value} out of bounds for uint32")
    return value


def _encode_all_ones(x: int) -> int:
    for s in (1, 2, 4, 8, 16):
        x |= x >> s
    return x


def permute_kensler(idx, samples: int, seed: int) -> torch.Tensor:
    """Pseudorandom permutation of ``idx`` within ``[0, samples)`` (int64
    tensor of ``idx``'s shape): the hash rounds re-hash each candidate that
    lands outside the range, for a fixed number of masked rounds."""
    idx = torch.as_tensor(idx)
    if samples <= 1:
        return torch.zeros(idx.shape, dtype=torch.int64, device=idx.device)
    idx = idx.to(torch.int64) & _MASK32
    seed = _uint32(seed)
    w = _encode_all_ones(samples - 1)
    # enough rounds that every lane lands inside [0, samples)
    max_iter = int(2 ** math.ceil(math.log2(max(samples, 2)))) - samples + 1

    def mul(v, c):
        return (v * c) & _MASK32

    def hash_round(v):
        v = v ^ seed
        v = mul(v, 0xE170893D)
        v = v ^ (seed >> 16)
        v = v ^ ((v & w) >> 4)
        v = v ^ (seed >> 8)
        v = mul(v, 0x0929EB3F)
        v = v ^ (seed >> 23)
        v = v ^ ((v & w) >> 1)
        v = mul(v, 1 | (seed >> 27))
        v = mul(v, 0x6935FA69)
        v = v ^ ((v & w) >> 11)
        v = mul(v, 0x74DCB303)
        v = v ^ ((v & w) >> 2)
        v = mul(v, 0x9E501CC3)
        v = v ^ ((v & w) >> 2)
        v = mul(v, 0xC860A3DF)
        v = v & w
        v = v ^ (v >> 5)
        return v

    out = idx
    done = torch.zeros(idx.shape, dtype=torch.bool, device=idx.device)
    for _ in range(max(max_iter, 1)):
        out = torch.where(done, out, hash_round(out))
        done = done | (out < samples)
    return ((out + seed) & _MASK32) % samples


def _next_prime_resolution(sample_count: int) -> int:
    def is_prime(x):
        if x < 2:
            return False
        return all(x % i for i in range(2, int(math.isqrt(x)) + 1))

    r = max(2, int(math.ceil(math.sqrt(sample_count))))
    while not is_prime(r):
        r += 1
    return r


class OrthogonalSampler(Sampler):
    """Bose orthogonal-array (strength 2) stratified sampler: ``resolution^2``
    samples whose projection onto each pair of dimensions 0 and 1 is a
    stratified (latin-square) pattern."""

    def __init__(self, sample_count: int, jitter: bool = True, strength: int = 2,
                 seed: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__(generator, seed=seed)
        if strength != 2:
            raise ValueError("only the strength-2 Bose construction is supported")
        self.jitter = jitter
        self.resolution = _next_prime_resolution(sample_count)
        self.sample_count = self.resolution ** 2
        self.base_seed = seed
        self.dimension_index = 0

    def bose(self, i, dim: int, permute_seed: int) -> torch.Tensor:
        r = self.resolution
        i = torch.as_tensor(i, device=self.device)
        i = permute_kensler(i % self.sample_count, self.sample_count, permute_seed)
        a_i0 = i // r
        a_i1 = i - a_i0 * r
        if dim == 0:
            a_ij, a_ik = a_i0, a_i1
        elif dim == 1:
            a_ij, a_ik = a_i1, a_i0
        else:
            k = dim - 1 if dim % 2 == 0 else dim + 1
            a_ij = (a_i0 + (dim - 1) * a_i1) % r
            a_ik = (a_i0 + (k - 1) * a_i1) % r
        stratum = permute_kensler(a_ij, r, permute_seed * (dim + 1) * 0x51633E2D).float()
        sub_stratum = permute_kensler(a_ik, r,
                                      permute_seed * (dim + 1) * 0x68BC21EB).float()
        if self.jitter:
            jit = sampling.uniform(self.generator, tuple(i.shape), self.device)
        else:
            jit = 0.5
        return (stratum + (sub_stratum + jit) / r) / r

    def next_1d(self, n: int) -> torch.Tensor:
        out = self.bose(torch.arange(n, device=self.device), self.dimension_index,
                        self.base_seed + 1)
        self.dimension_index += 1
        return out

    def next_2d(self, n: int) -> torch.Tensor:
        return torch.stack([self.next_1d(n), self.next_1d(n)], dim=-1)

    def sample(self, shape, dtype=torch.float32) -> torch.Tensor:
        n = int(np.prod(shape))
        return self.next_1d(n).reshape(tuple(shape)).to(dtype)
