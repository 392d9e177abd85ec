"""The learned light field of the flagship model.

Counterpart of ``LightField`` in ``neural_raytracing_tpu/lights/lights.py``:
MLP(x) gives an unnormalised direction whose length scales a learned RGB;
a delta light (pdf 1) that BSDF-sampled rays cannot hit.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..bsdf.bsdfs import active_mask
from ..interaction import DirectionSample
from ..kernels.fused_mlp import FusedSkipConnMLP
from ..nn.mlp import SkipConnMLP
from ..ops.math import normalize


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
        d = torch.clamp(normalize(non_norm, eps=1e-6), 1e-6, 1.0)
        magn = torch.linalg.norm(non_norm, dim=-1, keepdim=True)
        spectrum = magn * torch.sigmoid(self.color)
        ok = active_mask(active, it.p.shape[:-1], it.p.device)[..., None]
        d = torch.where(ok, d, 0.0)
        spectrum = torch.where(ok, spectrum, 0.0)
        ds = DirectionSample(d=d, pdf=torch.ones(it.p.shape[:-1], dtype=it.p.dtype,
                                                 device=it.p.device),
                             dist=None, delta=True)
        return ds, spectrum
