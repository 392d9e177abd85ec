"""``SDF(SphereSDF)``, the flagship's and NeRV's surface: the smooth minimum
of transformed spheres plus a Fourier-feature shift net.

The surface block holds ``spheres`` (their number), ``k`` (the smooth
minimum's sharpness) and ``shift`` (the shift net's widths).  An evaluation
is ``2 x`` the shift net's multiply-adds plus 31 operations per sphere
(``2 x 165,504 + 31 x 128`` for ``SphereSDF(128)`` with its 8 x 128 shift
net).
"""

from __future__ import annotations

import torch

from ...counts import net_ops, weight_bytes
from ...weights import net_shapes
from ..model import Net

SPHERE_OPS = 31


def shapes(spec: dict) -> dict:
    s = spec["spheres"]
    out = {"shape.centers": (s, 3), "shape.radii": (s,), "shape.tfs": (s, 3, 3)}
    out.update(net_shapes("shape.shift.", spec["shift"]))
    return out


def eval_ops(spec: dict) -> int:
    return net_ops(spec["shift"]) + SPHERE_OPS * spec["spheres"]


def eval_bytes(spec: dict) -> int:
    """The shift net's weights, and each sphere's centre, radius and 3 x 3
    transform."""
    return weight_bytes(spec["shift"]) + 4 * 13 * spec["spheres"]


class Surface:
    """``-log(max(sum_i exp(-k d_i), 1e-4)) / k`` over the transformed
    spheres, plus the shift net."""

    def __init__(self, spec: dict, weights: dict):
        self.spec = spec
        self.w = weights
        self.shift = Net(spec["shift"], weights, "shape.shift.")

    def __call__(self, p):
        batch = p.shape[:-1]
        flat = p.reshape(-1, 3)
        tfs = self.w["shape.tfs"] + torch.eye(3, dtype=flat.dtype, device=flat.device)
        q = torch.einsum("ijk,bk->ibj", tfs, flat) - self.w["shape.centers"][:, None, :]
        sd = torch.linalg.norm(q, dim=-1) - self.w["shape.radii"][:, None]
        k = self.spec["k"]
        smin = -torch.log(torch.clamp_min(torch.sum(torch.exp(-k * sd), dim=0), 1e-4)) / k
        return smin.reshape(batch) + self.shift(p)[..., 0]
