"""The plain reference the benchmark holds the program against.

Plain PyTorch in float32 with TF32 off; it imports neither JAX nor anything
of the program under test, and takes from the benchmark only the
configuration, the weights the benchmark made or loaded, and the inputs the
benchmark handed to both sides.  ``train_steps`` follows a training run for
its first steps; ``render_view`` renders one view as the program's one-tile
``pathtrace`` renders it.
"""

from __future__ import annotations

import contextlib

import torch

from .loss import eikonal, masked_loss
from .model import Scene, camera_rays, tile_jitter, tile_positions


@contextlib.contextmanager
def full_float32():
    """TF32 off for matmuls and convolutions while the reference runs."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def is_basis(name: str) -> bool:
    """The Fourier bases ``B`` are fixed at initialisation and never trained."""
    return name.rsplit(".", 1)[-1] == "B"


def train_steps(cfg: dict, weights: dict, steps: list, *, march: dict, size: int,
                crop: int, focal: float, images: torch.Tensor, masks: torch.Tensor,
                loss_cfg: dict):
    """AdamW over ``steps`` from ``weights`` -> ``(losses, first_grads,
    params_after)``.  Each step is a dict: ``c2w [N, 3, 4]``, ``idxs`` (the
    views), ``uv`` (the crop corner) and ``jitter`` (the min-scan's uniform
    draw, a 0-d tensor, or None).  ``images [V, S, S, 3]`` and ``masks [V, S,
    S]`` are the ground truth on the device."""
    opt_cfg = cfg["optimizer"]
    params = {k: (v.detach().clone() if is_basis(k) else v.detach().clone().requires_grad_())
              for k, v in weights.items()}
    groups = {}
    for k, v in params.items():
        if not is_basis(k):
            groups.setdefault(k.split(".", 1)[0], []).append(v)
    opt = torch.optim.AdamW(
        [{"params": ps, "lr": opt_cfg["lrs"].get(name, opt_cfg["default_lr"])}
         for name, ps in groups.items()],
        lr=opt_cfg["default_lr"], betas=(opt_cfg["b1"], opt_cfg["b2"]), eps=opt_cfg["eps"],
        weight_decay=opt_cfg["weight_decay"])
    scene = Scene(cfg, params, march)
    losses, first_grads = [], None
    with full_float32():
        for i, st in enumerate(steps):
            u, v = st["uv"]
            rays = camera_rays(st["c2w"], focal,
                               tile_positions(float(u), float(v), crop, images.device), size)
            rgb, _, it, _ = scene.direct(rays, primary=True, jitter=st["jitter"])
            idxs = torch.as_tensor(st["idxs"], device=images.device)
            exp = images[idxs, u:u + crop, v:v + crop]
            mask = masks[idxs, u:u + crop, v:v + crop]
            loss = masked_loss(rgb.mean(dim=-2), exp, it["throughput"].mean(dim=-1), mask,
                               mask_weight=loss_cfg["mask_weight"],
                               with_ssim=loss_cfg["ssim"])
            loss = loss + loss_cfg["eikonal"] * eikonal(it["raw_normals"])
            opt.zero_grad(set_to_none=False)
            for p in params.values():
                if p.requires_grad and p.grad is None:
                    p.grad = torch.zeros_like(p)
            loss.backward()
            if i == 0:
                first_grads = {k: p.grad.detach().clone() for k, p in params.items()
                               if p.requires_grad}
            opt.step()
            losses.append(float(loss.detach()))
    return losses, first_grads, {k: p.detach() for k, p in params.items()}


@torch.no_grad()
def render_view(scene: Scene, c2w: torch.Tensor, focal: float, size: int, chunk: int,
                key: int, light_loc=None):
    """One ``size``-square view in ``chunk``-square tiles, background 0, the
    pixels of tile ``idx`` jittered from ``(key, idx)`` -> ``(image [S, S,
    3], work)``; ``work`` sums the hits, the march's SDF evaluations and,
    with shadow rays, the shadow march's and the blocked shadow rays."""
    device = c2w.device
    image = torch.zeros((size, size, 3), device=device)
    work = dict.fromkeys(("hits", "march_evals", "shadow_evals", "blocked"), 0)
    n = size // chunk
    with full_float32():
        for idx in range(n * n):
            ti, tj = divmod(idx, n)
            rays = camera_rays(c2w[None], focal,
                               tile_positions(float(ti * chunk), float(tj * chunk), chunk, device),
                               size, jitter=tile_jitter(key, idx, chunk, device))
            rgb, hit, _, tile_work = scene.direct(rays, primary=False, light_loc=light_loc)
            image[ti * chunk:(ti + 1) * chunk, tj * chunk:(tj + 1) * chunk] = torch.where(
                hit[..., None], rgb, 0.0)[0, :, :, 0]
            work["hits"] += int(hit.sum())
            for k, v in tile_work.items():
                work[k] += int(v.sum())
    return image, work
