"""Volumetric NeRF-family shapes, rendered through the same drivers.

Counterpart of ``neural_raytracing_tpu/shapes/nerf.py``:
  * ``volumetric_integrate``: alpha compositing on the absolute sample
    position ``t`` (``alpha = 1 - exp(-sigma * t)``, exclusive transmittance
    of ``max(1 - alpha, 1e-10)``), through the kernel K8 for CUDA tensors
    with three channels and its plain version otherwise;
  * ``PlainNeRF``: two stacked MLPs (sigma and a feature from the point; the
    colour from the view direction's elevation/azimuth, the feature and an
    optional per-view latent), stratified ``t`` with a jittered far end,
    sigma noise;
  * ``PartialNeRF``: the same decomposed into ``forward`` -> (alpha, rgb,
    ts) and the shared compositing;
  * ``MPI``: learnable RGBA on planes, composited inline (not through K8, as
    in the JAX package);
  * ``NeRFLE``: NeRF conditioned on the light, by the point-light location
    or, with ``envmap=True``, by the ``bins^2`` probe of
    ``PointLights.envmap`` (the relighting baseline of ``scripts/nerfle.py``).

Each shape is an ``nn.Module`` whose parameters follow the JAX params tree
(``first.layers.0.w``, ``second.B``, ``mlp.out.b``).  ``volume_render(rays,
generator=None, lights=None[, latent=None])`` renders ``rays [..., 6]`` to
``[..., 3]``: the ``generator`` takes the place of the JAX key (it jitters
the far end of the samples and draws the sigma noise; without one there is
no jitter; the draws go through ``ops.sampling``), ``lights`` is the
scene's light module.  ``PlainNeRF`` and ``PartialNeRF`` take a
``latent``, as in JAX; ``PlainNeRF.latent``, when set, is the codes a call
without one uses (the JAX ``params["shape"]["latent"]``).  The nets are the plain
``SkipConnMLP`` (plain jnp in the JAX package too).  ``fused`` ("auto",
"force" or "off") selects the compositing of ``volumetric_integrate``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.composite import composite_apply, composite_plain
from ..nn.mlp import SkipConnMLP
from ..ops import sampling
from ..ops.dirs import dir_to_elev_azim, elev_azim_to_dir
from ..ops.math import maximum

_MODES = ("auto", "force", "off")


def _check_mode(fused: str) -> str:
    if fused not in _MODES:
        raise ValueError(f"fused must be 'auto', 'force' or 'off', got {fused!r}")
    return fused


def volumetric_integrate(sigma: torch.Tensor, rgb: torch.Tensor,
                         ts: torch.Tensor, fused: str = "auto") -> torch.Tensor:
    """Composite ``[T, ...]`` densities and ``[T, ..., C]`` colours at the
    sample positions ``ts [T]`` -> ``[..., C]``.

    As in the reference, alpha uses the absolute sample position ``t``, not
    the spacing.  ``fused``: "auto" launches K8 for CUDA tensors with three
    channels, "force" launches it (and raises on CPU tensors), "off" is the
    plain version.
    """
    _check_mode(fused)
    if fused != "off" and rgb.shape[-1] == 3 and (fused == "force" or sigma.is_cuda):
        return composite_apply(sigma, rgb, ts)
    return composite_plain(sigma, rgb, ts)


def _linspace(start: float, stop, num: int, device) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` as XLA computes it in float32
    (``start * (1 - s) + stop * s`` with ``s = i * (1 / (num - 1))``, the
    last value ``stop``); ``stop`` may be a 0-d tensor."""
    stop = torch.as_tensor(stop, dtype=torch.float32, device=device).reshape(1)
    if num == 1:
        return torch.full((1,), float(start), device=device)
    div = num - 1
    s = torch.arange(div, dtype=torch.float32, device=device) * (1.0 / div)
    return torch.cat([start * (1.0 - s) + stop * s, stop])


def _sample_ts(generator: Optional[torch.Generator], t_near: float,
               t_far: float, steps: int, device, jitter: float = 0.1):
    """``steps`` positions from ``t_near`` to ``t_far``; with a generator the
    far end moves by ``U(0, 1) * jitter``."""
    far = t_far
    if generator is not None:
        far = t_far + sampling.uniform(generator, (), device) * jitter
    return _linspace(t_near, far, steps, device)


def _sample_points(rays: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """``[T, ..., 3]`` points ``o + t d`` of ``rays [..., 6]``."""
    r_o, r_d = rays[..., :3], rays[..., 3:]
    return r_o[None] + ts.reshape((-1,) + (1,) * r_o.dim()) * r_d[None]


def _per_view(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast ``[N, C]`` per-view values over ``like [T, N, ..., *]`` ->
    ``[T, N, ..., C]``: one leading axis (T) and ``like.dim() - 3`` trailing
    ones before C (the JAX package's indexing, kept exactly)."""
    extra = (None,) * max(like.dim() - 3, 0)
    return v[(None, slice(None)) + extra].expand(like.shape[:-1] + v.shape[-1:])


class PlainNeRF(nn.Module):
    """Vanilla NeRF with an optional per-view latent code."""

    def __init__(self, latent_size: int = 32, intermediate_size: int = 32,
                 steps: int = 32, t_near: float = 0.4, t_far: float = 2.0,
                 sigma_noise: float = 1e-3, fused: str = "auto"):
        super().__init__()
        self.latent_size = latent_size
        self.intermediate_size = intermediate_size
        self.steps = steps
        self.t_near = t_near
        self.t_far = t_far
        self.sigma_noise = sigma_noise
        self.fused = _check_mode(fused)
        self.first = SkipConnMLP(in_size=3, out=1 + intermediate_size,
                                 latent_size=latent_size, num_layers=5,
                                 hidden_size=32)
        self.second = SkipConnMLP(in_size=2, out=3,
                                  latent_size=latent_size + intermediate_size,
                                  num_layers=5, hidden_size=32)
        self.latent: Optional[torch.Tensor] = None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.first.reset_parameters(generator)
        self.second.reset_parameters(generator)

    def volume_render(self, rays: torch.Tensor, generator=None, lights=None,
                      latent: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``latent``: optional per-view codes ``[N, latent_size]`` over the
        leading camera axis of the rays (``self.latent`` without; zeros
        without either)."""
        if latent is None:
            latent = self.latent
        r_d = rays[..., 3:]
        ts = _sample_ts(generator, self.t_near, self.t_far, self.steps, rays.device)
        pts = _sample_points(rays, ts)
        if latent is None:
            latent = pts.new_zeros(pts.shape[:-1] + (self.latent_size,))
        else:
            latent = _per_view(latent, pts)
        first_out = self.first(pts, latent)
        alpha, intermediate = first_out[..., 0], first_out[..., 1:]
        elaz = dir_to_elev_azim(r_d)[None].expand(pts.shape[:-1] + (2,))
        rgb = torch.tanh(self.second(elaz, torch.cat([intermediate, latent], dim=-1)))
        noise = 0.0
        if generator is not None and self.sigma_noise:
            # alpha is [steps, batch, ...]: the batch is its axis 1
            noise = sampling.normal(generator, alpha.shape, alpha.device,
                                    batch_axis=1) * self.sigma_noise
        sigma = F.relu(alpha + noise)
        return (volumetric_integrate(sigma, rgb, ts, self.fused) + 1.0) / 2.0


class PartialNeRF(nn.Module):
    """NeRF decomposed into (alpha, rgb) heads and the shared compositing."""

    def __init__(self, latent_size: int = 32, intermediate_size: int = 32,
                 first_layers: int = 4, first_hidden: int = 32,
                 second_layers: int = 4, second_hidden: int = 32,
                 steps: int = 16, t_near: float = 0.4, t_far: float = 1.5,
                 fused: str = "auto"):
        super().__init__()
        self.latent_size = latent_size
        self.steps = steps
        self.t_near = t_near
        self.t_far = t_far
        self.fused = _check_mode(fused)
        self.first = SkipConnMLP(in_size=3, out=1 + intermediate_size,
                                 latent_size=latent_size, num_layers=first_layers,
                                 hidden_size=first_hidden)
        self.second = SkipConnMLP(in_size=2, out=3,
                                  latent_size=latent_size + intermediate_size,
                                  num_layers=second_layers,
                                  hidden_size=second_hidden)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.first.reset_parameters(generator)
        self.second.reset_parameters(generator)

    def forward(self, rays: torch.Tensor, generator=None,
                latent: Optional[torch.Tensor] = None):
        """-> (alpha [T, ...], rgb [T, ..., 3], ts [T]); ``latent``
        broadcasts to ``[T, ..., latent_size]``."""
        r_d = rays[..., 3:]
        ts = _sample_ts(generator, self.t_near, self.t_far, self.steps,
                        rays.device, jitter=0.01)
        pts = _sample_points(rays, ts)
        shape = pts.shape[:-1] + (self.latent_size,)
        latent = (pts.new_zeros(shape) if latent is None
                  else torch.broadcast_to(latent, shape))
        first_out = self.first(pts, latent)
        alpha, intermediate = first_out[..., 0], first_out[..., 1:]
        elaz = dir_to_elev_azim(r_d)[None].expand(pts.shape[:-1] + (2,))
        rgb = self.second(elaz, torch.cat([intermediate, latent], dim=-1))
        return alpha, rgb, ts

    def volume_render(self, rays: torch.Tensor, generator=None, lights=None,
                      latent: Optional[torch.Tensor] = None) -> torch.Tensor:
        alpha, rgb, ts = self.forward(rays, generator, latent)
        return torch.sigmoid(volumetric_integrate(F.relu(alpha), rgb, ts, self.fused))


class MPI(nn.Module):
    """Multi-plane image: learnable RGBA on ``num_planes`` planes
    perpendicular to ``normal`` between ``min_t`` and ``max_t``, sampled
    through one MLP conditioned on the plane index and composited front to
    back (the reference's MPI exits before rendering; this is the JAX
    package's working version)."""

    def __init__(self, num_planes: int = 10, point=(0.0, 0.0, 0.0),
                 normal=(0.0, 0.0, -1.0), min_t: float = 1e-1,
                 max_t: float = 2.0):
        super().__init__()
        self.num_planes = num_planes
        self.min_t = min_t
        self.max_t = max_t
        # constants of the shape, not parameters (the JAX tree holds only mlp)
        self.register_buffer("point", torch.tensor(point, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("normal", torch.tensor(normal, dtype=torch.float32),
                             persistent=False)
        self.mlp = SkipConnMLP(in_size=3, out=4, num_layers=4, hidden_size=64,
                               freqs=16)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.mlp.reset_parameters(generator)

    def volume_render(self, rays: torch.Tensor, generator=None,
                      lights=None) -> torch.Tensor:
        r_o, r_d = rays[..., :3], rays[..., 3:]
        n = self.normal
        offsets = _linspace(self.min_t, self.max_t, self.num_planes, rays.device)
        # ray/plane intersection per plane: t = (o_k - n.r_o) / (n.r_d)
        denom = torch.sum(n * r_d, dim=-1)
        denom = torch.where(torch.abs(denom) < 1e-6, 1e-6, denom)
        base = torch.sum(n * (self.point - r_o), dim=-1)
        lead = (-1,) + (1,) * base.dim()
        ts = (base[None] + offsets.reshape(lead)) / denom
        valid = ts > 0
        pts = r_o[None] + ts[..., None] * r_d[None]
        idx = (offsets / self.max_t).reshape(lead).expand(ts.shape)
        rgba = self.mlp(torch.cat([pts[..., :2], idx[..., None]], dim=-1))
        rgb = torch.sigmoid(rgba[..., :3])
        alpha = torch.sigmoid(rgba[..., 3]) * valid
        trans = torch.cumprod(maximum(1.0 - alpha, 1e-10), dim=0)
        trans = torch.cat([torch.ones_like(trans[:1]), trans[:-1]], dim=0)
        weights = alpha * trans
        return torch.sum(weights[..., None] * rgb, dim=0)


class NeRFLE(nn.Module):
    """NeRF with light-emission conditioning: the colour net sees the point
    light's location (``[N, 3]``, one per view) or, with ``envmap``, the
    light's falloff spectrum at ``bins^2`` probe directions."""

    def __init__(self, envmap: bool = False, bins: int = 4, steps: int = 64,
                 t_near: float = 0.0, t_far: float = 2.0, latent_size: int = 64,
                 fused: str = "auto"):
        super().__init__()
        self.envmap = envmap
        self.bins = bins
        self.steps = steps
        self.t_near = t_near
        self.t_far = t_far
        self.latent_size = latent_size
        self.fused = _check_mode(fused)
        self.first = SkipConnMLP(in_size=3, out=1 + latent_size, num_layers=5,
                                 hidden_size=128)
        light_in = 3 + bins * bins * 3 if envmap else 6
        self.second = SkipConnMLP(in_size=latent_size + light_in, out=3)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.first.reset_parameters(generator)
        self.second.reset_parameters(generator)

    def volume_render(self, rays: torch.Tensor, generator=None,
                      lights=None) -> torch.Tensor:
        r_d = rays[..., 3:]
        ts = _sample_ts(generator, self.t_near, self.t_far, self.steps, rays.device)
        pts = _sample_points(rays, ts)
        first_out = self.first(pts)
        latent, alpha = first_out[..., 1:], first_out[..., 0]
        if self.envmap:
            probes = torch.stack(torch.meshgrid(
                _linspace(0.0, 180.0, self.bins, rays.device),
                _linspace(0.0, 45.0, self.bins, rays.device), indexing="ij"),
                dim=-1).reshape(-1, 2)
            spectrum = lights.envmap(elev_azim_to_dir(probes))   # [L, bins^2, 3]
            light_encode = _per_view(spectrum.reshape(spectrum.shape[0], -1), latent)
        else:
            light_encode = _per_view(lights.location, latent)
        dirs = r_d[None].expand(latent.shape[:-1] + (3,))
        rgb = torch.sigmoid(self.second(torch.cat([latent, dirs, light_encode], dim=-1)))
        return volumetric_integrate(F.relu(alpha), rgb, ts, self.fused)
