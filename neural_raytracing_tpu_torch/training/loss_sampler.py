"""Loss-proportional view sampling (host side).

Counterpart of ``neural_raytracing_tpu/training/loss_sampler.py`` (the
reference's ``LossSampler``): a per-view loss, views drawn with probability
proportional to loss^2, and every stored loss multiplied by 1.00001 on each
update so that stale views slowly regain likelihood.
"""

from __future__ import annotations

import numpy as np


class LossSampler:
    def __init__(self, n: int, default: float = 1e5,
                 likelihood_inc: float = 1.00001,
                 rng: np.random.Generator | None = None):
        self.losses = np.full(n, default, dtype=np.float64)
        self.l_inc = likelihood_inc
        self.rng = rng if rng is not None else np.random.default_rng(0)

    def update(self, idx: int, loss: float):
        self.losses *= self.l_inc
        self.losses[idx] = loss + 1.0

    def update_idxs(self, idxs, loss: float):
        for idx in idxs:
            self.update(int(idx), loss)

    def sample(self, n: int = 1, replace: bool = False) -> np.ndarray:
        sqr = self.losses * self.losses
        p = sqr / sqr.sum()
        return self.rng.choice(len(self.losses), size=n, replace=replace, p=p)
