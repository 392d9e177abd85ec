"""Learned BSDFs of the flagship model.

Counterpart of ``neural_raytracing_tpu/bsdf/bsdfs.py`` for the render path:
  * ``NeuralBSDF``: one lobe, ``act(MLP(param_rusin2(wi, wo)))``;
  * ``ComposeSpatialVarying``: the spatially-varying mixture, weights
    ``sigmoid(MLP_16x256(x))`` per basis lobe.

``eval_and_pdf(it, wo, active) -> (spectrum [..., 3], pdf [...], aux)``.
Sampling (``sample``) belongs to the BSDF-sampling arm and is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..kernels.fused_mlp import FusedSkipConnMLP
from ..nn.mlp import ACTIVATIONS, SkipConnMLP
from ..ops.math import maximum
from ..ops.rusin import param_rusin2


def active_mask(active, batch_shape, device) -> torch.Tensor:
    """``active`` (a bool or a bool tensor) broadcast to ``batch_shape``."""
    return torch.as_tensor(active, dtype=torch.bool, device=device).expand(batch_shape)


class NeuralBSDF(nn.Module):
    """Single neural lobe: MLP(rusin(wi, wo)) -> RGB."""

    def __init__(self, activation: str = "sigmoid",
                 mlp: Optional[SkipConnMLP] = None):
        super().__init__()
        if mlp is None:
            mlp = FusedSkipConnMLP(in_size=3, out=3, num_layers=6,
                                   hidden_size=96, freqs=64)
        self.mlp = mlp
        self.act = ACTIVATIONS[activation]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.mlp.reset_parameters(generator)

    def eval_and_pdf(self, it, wo: torch.Tensor, active=True):
        # argument order of the reference: param_rusin2(it.wi, wo)
        spectrum = self.act(self.mlp(param_rusin2(it.wi, wo)))
        pdf = torch.ones(spectrum.shape[:-1], dtype=spectrum.dtype,
                         device=spectrum.device)
        return spectrum, pdf, {}


class ComposeSpatialVarying(nn.Module):
    """Spatially-varying mixture: weights = sigmoid(MLP(x)) per basis BSDF."""

    def __init__(self, bsdfs: Sequence[nn.Module],
                 sp_var_fn: Optional[SkipConnMLP] = None):
        super().__init__()
        self.bsdfs = nn.ModuleList(bsdfs)
        if sp_var_fn is None:
            sp_var_fn = FusedSkipConnMLP(
                in_size=3, out=len(self.bsdfs), num_layers=16,
                hidden_size=256, freqs=128, sigma=128.0, init="xavier")
        self.sp_var_fn = sp_var_fn

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        for b in self.bsdfs:
            b.reset_parameters(generator)
        self.sp_var_fn.reset_parameters(generator)

    def normalized_weights(self, p: torch.Tensor):
        """-> (sigmoid weights [..., K], raw logits [..., K])."""
        raw = self.sp_var_fn(p)
        # the reference uses sigmoid rather than softmax
        return torch.sigmoid(raw), raw

    def eval_and_pdf(self, it, wo: torch.Tensor, active=True):
        k, raw = self.normalized_weights(it.p)
        spec_pdf = torch.stack([
            torch.cat([s, p[..., None]], dim=-1)
            for s, p, _ in (b.eval_and_pdf(it, wo, active) for b in self.bsdfs)
        ], dim=-1)                                            # [..., 4, K]
        ok = active_mask(active, it.p.shape[:-1], it.p.device)
        spec_pdf = torch.where(ok[..., None, None], spec_pdf * k[..., None, :], 0.0)
        summed = torch.sum(spec_pdf, dim=-1)
        aux = {"nonnormalized_weights": raw, "normalized_weights": k}
        # the spectrum keeps the sigmoid weighting (k does not sum to 1);
        # the pdf is the density of a categorical pick ~ k, hence / sum k
        ksum = maximum(torch.sum(k, dim=-1), 1e-10)
        return summed[..., :3], summed[..., 3] / ksum, aux
