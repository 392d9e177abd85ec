"""Training step and host loop.

Counterpart of ``neural_raytracing_tpu/training/loop.py``: the loss sampler
picks views, a crop is drawn, ``NeRFIntegrator(integrator)`` renders the
crop with primary (throughput-carrying) intersections, ``masked_loss`` plus
the eikonal term is minimised by AdamW.

The JAX step is one jitted pure function; here the step runs eagerly and
updates the scene's parameters and the optimizer in place.  ``TrainState``
carries the scene, the ``torch.optim.AdamW`` and the applied-step count.
The loop resolves each step's loss one step behind, so the host queues the
next step before it waits for the card.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..integrators import NeRFIntegrator
from ..ops.losses import masked_loss
from ..ops.math import eikonal_loss
from ..render import pathtrace_sample
from .loss_sampler import LossSampler
from .optim import broadcast_state, clip_grads, global_norm


class TrainState(NamedTuple):
    scene: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int


def init_train_state(scene, optimizer_config, generator=None,
                     device="cuda") -> TrainState:
    """Draw the scene's parameters from ``generator`` (if given), move it to
    ``device`` and build its optimizer."""
    if generator is not None:
        scene.init(generator, device=device)
    else:
        scene.to(device)
    return TrainState(scene, optimizer_config.init(scene), 0)


def default_extra_loss(it, got, exp, mask):
    """Eikonal regularizer on the raw SDF gradients."""
    if it.raw_normals is None:
        return 0.0
    return eikonal_loss(it.raw_normals)


def _not_ported(name: str, queue: str):
    raise NotImplementedError(f"{name} is not ported yet: it comes with {queue} "
                              "(ROADMAP.md, Queue 1)")


def build_step_fn(scene, integrator, optimizer_config, *, size: int,
                  crop_size: int, bundle_size: int = 1,
                  mask_weight: float = 15.0, tone_mapping: bool = False,
                  with_ssim: bool = True, with_noise=False,
                  extra_loss: Callable = default_extra_loss,
                  space_reg: Optional[Callable] = None,
                  skip_nan_updates: bool = False):
    """The step ``(state, camera, uv, exp, mask, generator) -> (state, aux)``.

    ``exp``/``mask`` are the ``[N, S, S, 3]`` / ``[N, S, S]`` ground-truth crop
    on the scene's device, ``uv`` the crop offset, ``camera`` a camera batch;
    ``generator`` (optional) draws the camera jitter and the throughput
    jitter.  ``aux`` holds the loss and the rendered crop, not synchronised.
    With ``skip_nan_updates`` a step whose loss or gradient norm is not
    finite keeps the parameters and the optimizer state and does not advance
    the count; that check waits for the card.
    ``space_reg(scene, generator) -> scalar`` (optional) is added to the
    loss: a regularizer at fresh random points each step (the JAX
    ``space_reg(params, key)``).
    """
    train_integrator = NeRFIntegrator(integrator)
    clip_norm = optimizer_config.clip_norm

    def step(state: TrainState, camera, uv, exp, mask, generator=None):
        scene_, opt = state.scene, state.optimizer
        params = [p for group in opt.param_groups for p in group["params"]]
        # zeros, not None: AdamW then updates every parameter each step, as
        # optax does, also one that no gradient reaches (Conductor's k) or
        # whose gradient a shape change dropped
        opt.zero_grad(set_to_none=False)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        values, _, it = pathtrace_sample(
            scene_, train_integrator, camera, uv, generator, crop_size=crop_size,
            bundle_size=bundle_size, size=size, with_noise=with_noise)
        got = values.mean(dim=-2)                       # over the bundle
        throughput = it.throughput.mean(dim=-1)
        loss = masked_loss(got[..., :3], exp, throughput, mask,
                           mask_weight=mask_weight, tone_mapping=tone_mapping,
                           with_ssim=with_ssim)
        loss = loss + extra_loss(it, got, exp, mask)
        if space_reg is not None:
            loss = loss + space_reg(scene_, generator)
        loss.backward()
        if clip_norm is not None:
            clip_grads(params, clip_norm)
        if skip_nan_updates:
            good = bool(torch.isfinite(loss) & torch.isfinite(
                global_norm([p.grad for p in params])))
            if not good:
                return state, {"loss": loss.detach(), "got": got.detach()}
        broadcast_state(opt)
        opt.step()
        return (TrainState(scene_, opt, state.step + 1),
                {"loss": loss.detach(), "got": got.detach()})

    return step


def rand_uv(rng: np.random.Generator, w: int, h: int, size: int):
    return (int(rng.integers(0, w - size + 1)),
            int(rng.integers(0, h - size + 1)))


def rand_uv_mask(rng: np.random.Generator, mask: np.ndarray, size: int):
    """Crop corner centred on a random non-zero mask pixel; a uniform crop
    when the mask is empty."""
    h, w = mask.shape[:2]
    half = size // 2
    ys, xs = np.nonzero(np.asarray(mask) > 0.5)
    if len(ys) == 0:
        return rand_uv(rng, h, w, size)
    i = int(rng.integers(0, len(ys)))
    u = int(np.clip(ys[i] - half, 0, h - size))
    v = int(np.clip(xs[i] - half, 0, w - size))
    return u, v


def train(scene, integrator, optimizer_config, state: TrainState,
          make_camera: Callable, exp_imgs: np.ndarray, exp_masks: np.ndarray,
          generator: Optional[torch.Generator] = None, *, size: int,
          crop_size: int, iters: int, n_views: int = 3, bundle_size: int = 1,
          mask_weight: float = 15.0, tone_mapping: bool = False,
          with_ssim: bool = True, extra_loss: Callable = default_extra_loss,
          space_reg: Optional[Callable] = None,
          light_update: Optional[Callable] = None,
          save_fn: Optional[Callable] = None, ckpt_freq: int = 0,
          valid_freq: int = 0, valid_fn: Optional[Callable] = None,
          log_every: int = 100, log_fn: Callable = print,
          metrics: Optional[list] = None, mesh=None, seed: int = 0,
          uv_select: Optional[Callable] = None, nan_policy: str = "raise",
          device_data=None):
    """The host training loop.

    ``make_camera(idxs) -> camera`` builds the view batch; ``exp_imgs
    [V, H, W, 3]`` and ``exp_masks [V, H, W]`` (numpy) go to the scene's
    device once; ``generator`` draws the step jitter;
    ``light_update(scene, camera, idxs)`` runs before each step and moves
    the lights in place (NeRV's per-frame point lights; the JAX
    ``light_update(params, camera, idxs) -> params``);
    ``space_reg(scene, generator) -> scalar`` is added to each step's loss
    (the JAX ``space_reg(params, key)``); ``valid_fn(state,
    step)`` runs every ``valid_freq`` steps and ``save_fn(state, step)``
    every ``ckpt_freq``; per-step scalars are appended to ``metrics``.
    ``nan_policy``: "raise" aborts on a non-finite loss; "skip" drops the
    update and goes on, aborting after 200 consecutive bad steps.
    Returns (state, losses).
    """
    if nan_policy not in ("raise", "skip"):
        raise ValueError(f"nan_policy must be 'raise' or 'skip', got {nan_policy!r}")
    if mesh is not None:
        _not_ported("mesh= (multi-device training)", "the deferred training items")
    if device_data is not None:
        _not_ported("device_data= (the on-device data path)",
                    "the deferred training items")
    skip_nan = nan_policy == "skip"
    step_fn = build_step_fn(
        scene, integrator, optimizer_config, size=size, crop_size=crop_size,
        bundle_size=bundle_size, mask_weight=mask_weight,
        tone_mapping=tone_mapping, with_ssim=with_ssim,
        extra_loss=extra_loss, space_reg=space_reg, skip_nan_updates=skip_nan)
    device = next(state.scene.parameters()).device
    images = torch.as_tensor(np.asarray(exp_imgs)[..., :3], dtype=torch.float32,
                             device=device)
    masks = torch.as_tensor(np.asarray(exp_masks), dtype=torch.float32,
                            device=device)
    # metrics and logs carry the global attempted step
    base = int(state.step)
    selector = LossSampler(len(exp_imgs))
    rng = np.random.default_rng(seed)
    losses: list = []
    t0 = time.time()
    rays_done = 0
    pending = None
    consecutive_bad = 0

    def resolve(pending, i):
        nonlocal consecutive_bad
        p_idxs, p_loss = pending
        loss = float(p_loss)
        if not np.isfinite(loss):
            if not skip_nan:
                raise FloatingPointError(f"Unexpected NaN loss at step {base + i - 1}")
            consecutive_bad += 1
            log_fn(f"step {base + i - 1:6d} non-finite loss — update skipped "
                   f"({consecutive_bad} consecutive)")
            if consecutive_bad >= 200:
                raise FloatingPointError(f"200 consecutive non-finite losses at "
                                         f"step {base + i - 1}")
            return
        consecutive_bad = 0
        losses.append(loss)
        selector.update_idxs(p_idxs, loss)
        rps = rays_done / max(time.time() - t0, 1e-9)
        if log_every and ((i - 1) % log_every) == 0:
            log_fn(f"step {base + i - 1:6d} loss {loss:.5f} rays/s {rps:,.0f}")
        if metrics is not None:
            metrics.append({"step": base + i - 1, "loss": loss, "rays_per_sec": rps})

    for i in range(iters):
        idxs = selector.sample(n=n_views)
        camera = make_camera(idxs)
        if uv_select is not None:
            u, v = uv_select(rng, exp_masks[idxs[0]], crop_size)
        else:
            u, v = rand_uv(rng, size, size, crop_size)
        sel = torch.as_tensor(idxs, device=device)
        exp = images[sel, u:u + crop_size, v:v + crop_size]
        mask = masks[sel, u:u + crop_size, v:v + crop_size]
        if light_update is not None:
            light_update(state.scene, camera, idxs)
        state, aux = step_fn(state, camera, (u, v), exp, mask, generator)
        rays_done += n_views * crop_size * crop_size * bundle_size
        if pending is not None:
            resolve(pending, i)
        pending = (idxs, aux["loss"])
        if save_fn is not None and ckpt_freq and (i % ckpt_freq) == 0 and i:
            save_fn(state, base + i)
        if valid_fn is not None and valid_freq and (i % valid_freq) == 0:
            valid_fn(state, base + i)
    if pending is not None:
        resolve(pending, iters)
    return state, losses
