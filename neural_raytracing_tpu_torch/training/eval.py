"""Evaluation: held-out-view metrics.

Counterpart of ``neural_raytracing_tpu/training/eval.py``: every view is
rendered with ``pathtrace`` (background 0, jitter from a per-view seed), and
the per-view L1, L2 and PSNR and a set-level SSIM (optionally MS-SSIM) are
reported.  The ground-truth protocol is the reference's: the GT is clamped to
[0, 1] for the per-view metrics only with ``tone_map``, and the set-level
SSIM stack is built from the raw GT (tone-mapped ``x / (1 + x)`` with
``tone_map``); ``masks`` multiply prediction and GT everywhere.

``light_update(scene, camera, i)`` moves the lights for view ``i`` in place
(NeRV's per-view point lights).  The JAX ``evaluate`` works on a local
params pytree; here the scene's parameters are restored, in values and
shapes, before ``evaluate`` returns, so a training run that evaluates in
the middle goes on from the state it had.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.math import mse2psnr
from ..ops.ssim import ms_ssim as ms_ssim_fn
from ..ops.ssim import ssim as ssim_fn
from ..render import pathtrace


@contextlib.contextmanager
def restored_parameters(module: torch.nn.Module):
    """On exit, every parameter of ``module`` gets back the values and the
    shape it had on entry (a shape change drops the gradient, as
    ``PointLights.set_location`` does)."""
    saved = [(p, p.detach().clone()) for p in module.parameters()]
    try:
        yield module
    finally:
        with torch.no_grad():
            for p, value in saved:
                if p.shape == value.shape:
                    p.copy_(value)
                else:
                    p.data = value
                    p.grad = None


def view_key(key: Optional[int], i: int) -> Optional[int]:
    """The render seed of view ``i`` under the evaluation seed ``key``
    (None: no jitter)."""
    if key is None:
        return None
    return int(np.random.SeedSequence([key, i]).generate_state(1)[0])


@torch.no_grad()
def evaluate(scene, make_camera: Callable, exp_imgs: np.ndarray, integrator,
             *, size: int, chunk_size: int = 64, bundle_size: int = 1,
             masks: Optional[np.ndarray] = None, tone_map: bool = False,
             with_ms_ssim: bool = False, key: Optional[int] = 0,
             light_update: Optional[Callable] = None,
             save_fn: Optional[Callable] = None, log_fn: Callable = print,
             device=None):
    """Render every view and compute L1/L2/PSNR per view + set-level SSIM.

    ``make_camera(i) -> camera`` for view ``i``; ``exp_imgs [V, H, W, 3]``;
    optional ``masks [V, H, W]``.  ``key`` seeds the per-view jitter (None:
    none).  Renders on the scene's device unless ``device`` is given.
    Returns a dict of floats.
    """
    if device is None:
        device = next(scene.parameters()).device
    with restored_parameters(scene):
        return _evaluate(scene, make_camera, exp_imgs, integrator, size=size,
                         chunk_size=chunk_size, bundle_size=bundle_size,
                         masks=masks, tone_map=tone_map,
                         with_ms_ssim=with_ms_ssim, key=key,
                         light_update=light_update, save_fn=save_fn,
                         log_fn=log_fn, device=device)


def _evaluate(scene, make_camera, exp_imgs, integrator, *, size, chunk_size,
              bundle_size, masks, tone_map, with_ms_ssim, key, light_update,
              save_fn, log_fn, device):
    l1s, l2s, psnrs = [], [], []
    got_all, exp_all = [], []
    for i in range(len(exp_imgs)):
        camera = make_camera(i)
        if light_update is not None:
            light_update(scene, camera, i)
        img, _ = pathtrace(scene, camera, integrator, size=size,
                           chunk_size=chunk_size, bundle_size=bundle_size,
                           background=0.0, key=view_key(key, i),
                           training=False, squeeze_first=True, device=device)
        got = np.clip(img.cpu().numpy()[..., :3], 0.0, 1.0)
        exp_raw = np.asarray(exp_imgs[i], dtype=np.float32)[..., :3]
        exp = np.clip(exp_raw, 0.0, 1.0) if tone_map else exp_raw
        exp_set = exp_raw
        if masks is not None:
            m = np.asarray(masks[i])[..., None]
            got, exp, exp_set = got * m, exp * m, exp_set * m
        l1 = float(np.mean(np.abs(got - exp)))
        l2 = float(np.mean((got - exp) ** 2))
        l1s.append(l1)
        l2s.append(l2)
        # an exactly zero L2 would give an infinite PSNR
        psnrs.append(float(mse2psnr(max(l2, 1e-10))))
        got_all.append(got)
        exp_all.append(exp_set)
        if save_fn is not None:
            save_fn(i, got)
        log_fn(f"view {i:3d} L1 {l1:.5f} L2 {l2:.6f} PSNR {psnrs[-1]:.3f}")

    got_n = np.stack(got_all).astype(np.float32)
    exp_n = np.stack(exp_all).astype(np.float32)
    if tone_map:
        got_n = got_n / (1.0 + got_n)
        exp_n = exp_n / (1.0 + exp_n)
    got_t = torch.from_numpy(got_n).permute(0, 3, 1, 2)
    exp_t = torch.from_numpy(exp_n).permute(0, 3, 1, 2)
    out = {
        "l1": float(np.mean(l1s)),
        "l2": float(np.mean(l2s)),
        "psnr": float(np.mean(psnrs)),
        "ssim": float(ssim_fn(got_t, exp_t, data_range=1.0)),
    }
    if with_ms_ssim:
        out["ms_ssim"] = float(ms_ssim_fn(got_t, exp_t, data_range=1.0))
    log_fn(f"avg L1 {out['l1']:.5f} L2 {out['l2']:.6f} PSNR {out['psnr']:.3f} "
           f"SSIM {out['ssim']:.4f}"
           + (f" MS-SSIM {out['ms_ssim']:.4f}" if with_ms_ssim else ""))
    return out
