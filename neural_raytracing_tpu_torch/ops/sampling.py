"""The draw functions of the Monte Carlo parts of the port.

The BSDF samplers, the ``Constant`` light, the integrators, the camera
jitter, the silhouette scan's jitter, the learned warps and the samplers
draw every uniform through ``uniform``, and ``DensityEstimator.sample``
its standard normals through ``normal``, always as ``sampling.uniform(...)``
/ ``sampling.normal(...)`` (looked up on this module at each call), so a
test can replace either with a replay of the JAX package's draws in call
order.

A draw made per rendered ray names the axis of its shape that runs over
the batch being rendered (``batch_axis``: the views of a camera batch, or
the rays of a flat one).  Under ``view_shard`` (a data-parallel rank
rendering its shard of that batch) such a draw is made at the whole padded
batch and this rank's rows are kept, so the ranks draw what one process
draws for the whole batch; a 0-d draw is made whole, the same on every
rank; any other draw there raises, since no rank could tell its rows.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

_SHARD: Optional[tuple] = None          # (rank, n_local, n_padded)


@contextlib.contextmanager
def view_shard(rank: int, n_local: int, n_padded: int):
    """Within the block this rank renders the rows ``[rank * n_local, (rank
    + 1) * n_local)`` of a batch of ``n_padded``: a draw's ``batch_axis``
    must be ``n_local`` long, and holds those rows of a draw of
    ``n_padded``."""
    global _SHARD
    old, _SHARD = _SHARD, (rank, n_local, n_padded)
    try:
        yield
    finally:
        _SHARD = old


def _draw(fn, generator, shape, batch_axis: Optional[int]) -> torch.Tensor:
    shape = tuple(shape)
    if _SHARD is None or not shape:
        return fn(shape, generator=generator, device=generator.device)
    rank, n_local, n_padded = _SHARD
    if batch_axis is None or shape[batch_axis] != n_local:
        raise ValueError(f"a draw of shape {shape} under view_shard needs the batch axis of "
                         f"the shard's {n_local} rows (batch_axis={batch_axis})")
    whole = list(shape)
    whole[batch_axis] = n_padded
    return fn(tuple(whole), generator=generator, device=generator.device).narrow(
        batch_axis, rank * n_local, n_local)


def uniform(generator: Optional[torch.Generator], shape, device,
            minval: float = 0.0, batch_axis: Optional[int] = None) -> torch.Tensor:
    """``U[minval, 1)`` float32 of ``shape`` on ``device``, drawn from
    ``generator`` on the generator's own device (a CUDA generator draws on
    the card: nothing waits for it).  As ``jax.random.uniform``, the
    samples are scaled to the interval and clamped at ``minval``.
    ``batch_axis``: the axis of ``shape`` over the rendered batch, for a
    draw made per ray (see the module's docstring)."""
    if generator is None:
        raise ValueError("a Monte Carlo draw requires a torch.Generator")
    u = _draw(torch.rand, generator, shape, batch_axis)
    if minval:
        u = torch.clamp_min(u * (1.0 - minval) + minval, minval)
    return u.to(device)


def normal(generator: Optional[torch.Generator], shape, device,
           batch_axis: Optional[int] = None) -> torch.Tensor:
    """Standard normal float32 of ``shape`` on ``device``, drawn from
    ``generator`` on the generator's own device (``jax.random.normal``'s
    counterpart); ``batch_axis`` as ``uniform``'s."""
    if generator is None:
        raise ValueError("a Monte Carlo draw requires a torch.Generator")
    z = _draw(torch.randn, generator, shape, batch_axis)
    return z.to(device)
