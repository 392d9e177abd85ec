"""The draw functions of the Monte Carlo parts of the port.

The BSDF samplers, the ``Constant`` light, the integrators, the camera
jitter, the silhouette scan's jitter, the learned warps and the samplers
draw every uniform through ``uniform``, and ``DensityEstimator.sample``
its standard normals through ``normal``, always as ``sampling.uniform(...)``
/ ``sampling.normal(...)`` (looked up on this module at each call), so a
test can replace either with a replay of the JAX package's draws in call
order.
"""

from __future__ import annotations

from typing import Optional

import torch


def uniform(generator: Optional[torch.Generator], shape, device,
            minval: float = 0.0) -> torch.Tensor:
    """``U[minval, 1)`` float32 of ``shape`` on ``device``, drawn from
    ``generator`` on the generator's own device (a CUDA generator draws on
    the card: nothing waits for it).  As ``jax.random.uniform``, the
    samples are scaled to the interval and clamped at ``minval``."""
    if generator is None:
        raise ValueError("a Monte Carlo draw requires a torch.Generator")
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    if minval:
        u = torch.clamp_min(u * (1.0 - minval) + minval, minval)
    return u.to(device)


def normal(generator: Optional[torch.Generator], shape, device) -> torch.Tensor:
    """Standard normal float32 of ``shape`` on ``device``, drawn from
    ``generator`` on the generator's own device (``jax.random.normal``'s
    counterpart)."""
    if generator is None:
        raise ValueError("a Monte Carlo draw requires a torch.Generator")
    z = torch.randn(tuple(shape), generator=generator, device=generator.device)
    return z.to(device)
