"""Optimizer construction with per-component learning rates.

Counterpart of ``neural_raytracing_tpu/training/optim.py`` (the reference's
AdamW groups, e.g. surface 8e-5 / bsdf 8e-4 / light 8e-5, weight decay 0).
The groups are the top-level children of the scene (``shape``, ``bsdf``,
``lights``, ``occ``, anything else at the default rate).

Traps kept away from the reference's behaviour:
  * ``torch.optim.AdamW`` defaults to ``weight_decay=0.01``; the reference
    uses 0, so it is always passed;
  * ``clip_grad_norm_`` divides by ``norm + 1e-6``; optax scales by
    ``max_norm / norm`` only when ``norm >= max_norm``, which ``clip_grads``
    writes out;
  * Fourier bases are buffers and never updated, as optax's zero-gradient,
    zero-decay update leaves them;
  * a parameter may change shape between steps (NeRV's light location goes
    from one row to one row per view): optax's moments broadcast to the new
    shape at the next update, ``broadcast_state`` does the same for
    AdamW's.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over a list of tensors (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


@torch.no_grad()
def clip_grads(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the ``.grad`` of ``params``, in place and
    without a host synchronisation.  Returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


@torch.no_grad()
def broadcast_state(optimizer: torch.optim.Optimizer) -> None:
    """Broadcast each AdamW moment whose parameter changed shape since the
    moment was made to the parameter's shape, as optax's moments broadcast
    (raises where the shapes do not broadcast)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p)
            if not st:
                continue
            for key in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq"):
                m = st.get(key)
                if m is not None and m.shape != p.shape:
                    st[key] = torch.broadcast_to(m, p.shape).clone()


class AdamWConfig(NamedTuple):
    """What ``make_optimizer`` returns: ``init(module)`` builds the
    ``torch.optim.AdamW`` over the module's parameters."""
    lrs: Dict[str, float]
    default_lr: float
    weight_decay: float
    b1: float
    b2: float
    eps: float
    clip_norm: Optional[float]

    def param_groups(self, module: nn.Module) -> list:
        groups = []
        for name, child in module.named_children():
            params = [p for p in child.parameters() if p.requires_grad]
            if params:
                groups.append({"params": params, "name": name,
                               "lr": self.lrs.get(name, self.default_lr)})
        own = [p for p in module.parameters(recurse=False) if p.requires_grad]
        if own:
            groups.append({"params": own, "name": "__default__",
                           "lr": self.default_lr})
        return groups

    def init(self, module: nn.Module) -> torch.optim.AdamW:
        return torch.optim.AdamW(self.param_groups(module), lr=self.default_lr,
                                 betas=(self.b1, self.b2), eps=self.eps,
                                 weight_decay=self.weight_decay)


def make_optimizer(lrs: Dict[str, float], default_lr: float = 1e-4,
                   weight_decay: float = 0.0, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8,
                   clip_norm: Optional[float] = None) -> AdamWConfig:
    """AdamW with a learning rate per top-level scene component; optionally
    the global gradient norm is clipped first (``clip_grads``)."""
    return AdamWConfig(dict(lrs), default_lr, weight_decay, b1, b2, eps,
                       clip_norm)
