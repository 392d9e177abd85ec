"""Light emitters: learnable point lights and the learned light field.

Counterpart of ``PointLights`` and ``LightField`` in
``neural_raytracing_tpu/lights/lights.py``:
  * ``PointLights``: learnable intensity, location and constant / linear /
    quadratic falloff; spectrum ``scale * normalize(intensity) / max(c + l d
    + q d^2, 1e-6)`` with each coefficient clamped at 1e-6; a delta sample.
    A ``[N, 3]`` location is one light per view and broadcasts over the
    camera axis of the interaction (NeRV's per-frame lights);
  * ``LightField``: MLP(x) gives an unnormalised direction whose length
    scales a learned RGB; a delta light (pdf 1).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..bsdf.bsdfs import active_mask
from ..interaction import DirectionSample
from ..kernels.fused_mlp import FusedSkipConnMLP
from ..nn.mlp import SkipConnMLP
from ..ops.math import clip, maximum, normalize


def _bcast(v: torch.Tensor, batch_ndim: int) -> torch.Tensor:
    """Reshape an ``[N, C]`` per-view parameter to ``[N, 1, ..., 1, C]``."""
    v = torch.atleast_2d(v)
    return v.reshape(v.shape[:1] + (1,) * (batch_ndim - 1) + v.shape[-1:])


class PointLights(nn.Module):
    """Delta point light(s) with learnable falloff and colour.

    ``intensity`` and ``location`` are ``[1, 3]`` parameters; ``const``,
    ``linear``, ``square`` and ``scale`` are 0-d.  ``location`` may hold one
    row per view: ``set_location`` and loading a state dict whose
    ``location`` has another row count (a trained NeRV checkpoint stores the
    last step's per-view lights) resize it.  Every other leaf loads
    strictly.
    """

    delta = True

    def __init__(self, intensity=(1.0, 1.0, 1.0), location=(0.0, 1.0, 0.0),
                 const: float = 1e-8, linear: float = 1e-8,
                 square: float = 1.0, scale: float = 1e2):
        super().__init__()
        self._init = dict(
            intensity=torch.atleast_2d(torch.tensor(intensity, dtype=torch.float32)),
            location=torch.atleast_2d(torch.tensor(location, dtype=torch.float32)),
            const=torch.tensor(float(const)), linear=torch.tensor(float(linear)),
            square=torch.tensor(float(square)), scale=torch.tensor(float(scale)))
        for name, value in self._init.items():
            self.register_parameter(name, nn.Parameter(value.clone()))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None):
        for name, value in self._init.items():
            if name == "location":
                self.set_location(value)
            else:
                getattr(self, name).copy_(value)

    @torch.no_grad()
    def set_location(self, location) -> None:
        """Write ``location`` (``[3]`` or ``[N, 3]``) into the parameter, in
        place when the row count is unchanged; otherwise the parameter takes
        the new shape and drops its gradient (the optimizer's moments follow
        at its next step, see ``training.optim.broadcast_state``)."""
        p = self.location
        loc = torch.atleast_2d(torch.as_tensor(location, dtype=p.dtype)).to(p.device)
        if loc.shape == p.shape:
            p.copy_(loc)
        else:
            p.data = loc.clone()
            p.grad = None

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        loc = state_dict.get(prefix + "location")
        if (loc is not None and loc.dim() == 2 and loc.shape[-1] == 3
                and loc.shape != self.location.shape):
            self.set_location(loc)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _falloff(self, dist: torch.Tensor) -> torch.Tensor:
        return (maximum(self.const, 1e-6)
                + maximum(self.linear, 1e-6) * dist
                + maximum(self.square, 1e-6) * torch.square(dist))

    def sample_direction(self, it, generator=None, active=True):
        batch_ndim = it.p.dim() - 1
        loc = _bcast(self.location, batch_ndim)
        d = loc - it.p
        dist = torch.linalg.norm(d, dim=-1, keepdim=True)
        d = normalize(d, eps=1e-6)
        color = _bcast(normalize(self.intensity), batch_ndim)
        spectrum = self.scale * color / maximum(self._falloff(dist), 1e-6)
        ok = active_mask(active, it.p.shape[:-1], it.p.device)[..., None]
        spectrum = torch.where(ok, spectrum, 0.0)
        ds = DirectionSample(d=d, pdf=torch.ones(it.p.shape[:-1], dtype=it.p.dtype,
                                                 device=it.p.device),
                             dist=dist[..., 0], p=loc.expand(it.p.shape),
                             delta=True)
        return ds, spectrum

    def envmap(self, p: torch.Tensor) -> torch.Tensor:
        """Falloff spectrum at probe points ``p`` -> ``[L, ..., 3]``."""
        d = p[None, ...] - self.location.reshape(
            (-1,) + (1,) * (p.dim() - 1) + (3,))
        dist = torch.linalg.norm(d, dim=-1, keepdim=True)
        return self.scale * normalize(self.intensity) / maximum(self._falloff(dist), 1e-6)

    # a delta light: BSDF-sampled rays cannot hit it
    def intersect(self, rays: torch.Tensor):
        batch = rays.shape[:-1]
        return (torch.zeros(batch, dtype=rays.dtype, device=rays.device),
                torch.zeros(batch, dtype=torch.bool, device=rays.device))

    def eval_pdf(self, rays: torch.Tensor):
        batch = rays.shape[:-1]
        return (torch.zeros(batch + (3,), dtype=rays.dtype, device=rays.device),
                torch.zeros(batch, dtype=rays.dtype, device=rays.device))


class LightField(nn.Module):
    """Learned 5D light field: MLP(x) -> direction * magnitude, learned RGB."""

    delta = True

    def __init__(self, mlp: Optional[SkipConnMLP] = None):
        super().__init__()
        if mlp is None:
            mlp = FusedSkipConnMLP(in_size=3, out=3, num_layers=10,
                                   hidden_size=256)
        self.mlp = mlp
        self.color = nn.Parameter(torch.zeros(3))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.mlp.reset_parameters(generator)
        self.color.zero_()

    def sample_direction(self, it, generator=None, active=True):
        non_norm = self.mlp(it.p)
        # reference quirk: each component of the normalised direction is
        # clamped to [1e-6, 1]
        d = clip(normalize(non_norm, eps=1e-6), 1e-6, 1.0)
        magn = torch.linalg.norm(non_norm, dim=-1, keepdim=True)
        spectrum = magn * torch.sigmoid(self.color)
        ok = active_mask(active, it.p.shape[:-1], it.p.device)[..., None]
        d = torch.where(ok, d, 0.0)
        spectrum = torch.where(ok, spectrum, 0.0)
        ds = DirectionSample(d=d, pdf=torch.ones(it.p.shape[:-1], dtype=it.p.dtype,
                                                 device=it.p.device),
                             dist=None, delta=True)
        return ds, spectrum
