"""Gaussian Fourier-feature positional encoding.

Counterpart of ``neural_raytracing_tpu/ops/encoding.py``: the basis is
``sigma * N(0, 1)`` of shape ``[features, freqs]`` and the encoding is
``[x, sin(x @ B), cos(x @ B)]``.  The basis is stored with the weights but no
gradient flows into it.
"""

from __future__ import annotations

import torch


def fourier_basis(generator: torch.Generator, freqs: int, features: int,
                  sigma: float) -> torch.Tensor:
    """Random Gaussian frequency matrix ``B`` of shape ``[features, freqs]``."""
    return sigma * torch.randn((features, freqs), generator=generator,
                               device=generator.device, dtype=torch.float32)


def fourier_size(freqs: int, features: int) -> int:
    return 2 * freqs + features


def fourier_encode(x: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """``[..., features] -> [..., features + 2*freqs]`` Fourier features."""
    mapped = x @ basis.detach().to(x.dtype)
    return torch.cat([x, torch.sin(mapped), torch.cos(mapped)], dim=-1)
