"""The one draw function of the Monte Carlo parts of the port.

The BSDF samplers, the ``Constant`` light, the integrators, the camera
jitter and the silhouette scan's jitter draw every uniform through
``uniform``, always as ``sampling.uniform(...)`` (looked up on this module
at each call), so a test can replace it with a replay of the JAX package's
uniforms in call order.
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
