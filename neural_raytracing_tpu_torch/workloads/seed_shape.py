"""Seed the learnable SphereSDF by fitting it to a known mesh's distance.

The twin of ``scripts/seed_shape.py`` of the JAX package.  Training a
surface from scratch on the mirror-plate ground truth falls into a fog
basin; the reference resumes hard scenes from pretrained shapes, and this
is that seed: the NeRV twin's ``SphereSDF(128)`` fitted by distance
regression to the ground truth's mesh (``make_mesh_dataset``'s kind, scaled
by ``--obj-scale``, with its mirror plate), saved with fresh BSDF, lights
and occlusion net for ``workloads.nerv --load``.

The probe points are uniform in [-1.25, 1.25]^3 (``--n-uniform``) and
points on random faces (Dirichlet(1, 1, 1) barycentrics) pushed off by
N(0, 0.08^2) (``--n-surface``).  Their targets are the unsigned distance to
the mesh (``raster.point_face_distance``) less ``--inset``, at most
``--cap``.  Each of ``--iters`` steps draws ``--batch`` of them, and Adam
(1e-2) minimises the mean Huber loss (delta 0.05) of the SDF against the
targets.  On the card the SDF's shift net is ``FusedSkipConnMLP``: K1's
forward, with its recompute backward.

    python -m neural_raytracing_tpu_torch.workloads.seed_shape --kind gear \
        --mirror-plate 0.7 --models models_seed --name nerv_mesh_gear_mirror200b

The draws come from ``torch.Generator``s seeded ``--seed`` (the points),
``--seed + 1`` (the batches) and ``--seed`` (the scene's weights); the JAX
script draws them from ``PRNGKey``s.  ``--device`` picks the card
(default) or the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ._common import device_of


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kind", type=str, default="gear")
    ap.add_argument("--obj-scale", type=float, default=1.0)
    ap.add_argument("--mirror-plate", type=float, default=0.0)
    ap.add_argument("--dist", type=float, default=3.4,
                    help="the scene's dist (a setting of the SDF; the params' layout "
                         "does not depend on it)")
    ap.add_argument("--models", type=str, default="models_seed")
    ap.add_argument("--name", type=str, required=True,
                    help="the model directory's name, e.g. nerv_mesh_gear_mirror200b")
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--n-uniform", type=int, default=32768)
    ap.add_argument("--n-surface", type=int, default=32768)
    ap.add_argument("--inset", type=float, default=0.01,
                    help="subtracted from the unsigned distance, so the field dips "
                         "below 0 at the surface")
    ap.add_argument("--cap", type=float, default=0.26,
                    help="the targets' ceiling, under the smooth-min's plateau (0.288)")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def target_tris(kind: str, obj_scale: float = 1.0, mirror_plate: float = 0.0) -> np.ndarray:
    """The target geometry's triangles ``[F, 3, 3]``: the mesh and its plate,
    as ``make_mesh_dataset`` builds them."""
    from .make_mesh_dataset import gt_mesh
    verts, faces, _ = gt_mesh(kind, obj_scale, mirror_plate)
    return np.asarray(verts, np.float32)[faces]


def probe_points(tris: torch.Tensor, n_uniform: int, n_surface: int,
                 generator: torch.Generator) -> torch.Tensor:
    """``[n_uniform + n_surface, 3]``: uniform points in [-1.25, 1.25]^3, then
    points on random faces shifted by N(0, 0.08^2)."""
    dev = tris.device
    pts_u = torch.rand(n_uniform, 3, generator=generator, device=dev) * 2.5 - 1.25
    fidx = torch.randint(0, tris.shape[0], (n_surface,), generator=generator, device=dev)
    # Dirichlet(1, 1, 1): normalised exponential draws
    e = -torch.log1p(-torch.rand(n_surface, 3, generator=generator, device=dev))
    bary = e / e.sum(-1, keepdim=True)
    on_surf = torch.einsum("pk,pkd->pd", bary, tris[fidx])
    pts_s = on_surf + 0.08 * torch.randn(on_surf.shape, generator=generator, device=dev)
    return torch.cat([pts_u, pts_s])


def targets_of(points: torch.Tensor, tris: torch.Tensor, inset: float, cap: float,
               splits: int = 8) -> torch.Tensor:
    """``min(sqrt(d^2) - inset, cap)`` with ``d^2`` the least squared distance
    to the triangles, in ``splits`` chunks of points."""
    from ..raster import point_face_distance
    out = []
    with torch.no_grad():
        for p in torch.tensor_split(points, splits):
            d2, _ = point_face_distance(p, tris)
            out.append(torch.clamp_max(torch.sqrt(torch.clamp_min(d2, 0.0)) - inset, cap))
    return torch.cat(out)


def huber(f: torch.Tensor, t: torch.Tensor, delta: float = 0.05) -> torch.Tensor:
    """``optax.huber_loss(f, t, delta)``, elementwise, with its gradient at
    the ties."""
    from ..ops.math import absolute, minimum
    err = absolute(f - t)
    quadratic = minimum(err, delta)
    return 0.5 * quadratic * quadratic + delta * (err - quadratic)


def fit_step(scene, optimizer, p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """One Adam step on the mean Huber loss of ``scene.shape.sdf(p)``
    against ``t``; -> the loss (before the step)."""
    optimizer.zero_grad(set_to_none=True)
    loss = torch.mean(huber(scene.shape.sdf(p), t))
    loss.backward()
    optimizer.step()
    return loss.detach()


def fit(scene, pts: torch.Tensor, targets: torch.Tensor, *, iters: int, batch: int,
        generator: torch.Generator, lr: float = 1e-2, log_fn=print) -> torch.Tensor:
    """``iters`` steps of ``batch`` points drawn from ``generator`` -> the
    losses ``[iters]``."""
    optimizer = torch.optim.Adam(scene.shape.parameters(), lr=lr)
    losses = []
    for i in range(iters):
        idx = torch.randint(0, pts.shape[0], (batch,), generator=generator,
                            device=pts.device)
        losses.append(fit_step(scene, optimizer, pts[idx], targets[idx]))
        if i % 500 == 0 or i == iters - 1:
            log_fn(f"fit step {i:5d} huber {losses[-1].item():.6f}")
    return torch.stack(losses)


@torch.no_grad()
def report(scene, pts: torch.Tensor, targets: torch.Tensor) -> dict:
    """The fit's quality (|f - d| percentiles over the probes) and the
    field's health on a 25^3 grid over [-1.25, 1.25]^3."""
    err = (scene.shape.sdf(pts) - targets).abs().cpu().numpy()
    axis = torch.linspace(-1.25, 1.25, 25, device=pts.device)
    grid = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    v = scene.shape.sdf(grid).cpu().numpy()
    return {"p50": float(np.percentile(err, 50)), "p90": float(np.percentile(err, 90)),
            "max": float(err.max()), "volume_min": float(v.min()),
            "volume_max": float(v.max()), "volume_p50": float(np.median(v)),
            "frac_neg": float((v < 0).mean())}


def run(args, log_fn=print) -> dict:
    """Draw the probes, fit, report -> ``{"scene", "points", "targets",
    "losses", "report"}``."""
    from .nerv import build_scene
    device = device_of(args)
    tris = torch.from_numpy(target_tris(args.kind, args.obj_scale,
                                        args.mirror_plate)).to(device)
    log_fn(f"target geometry: {tris.shape[0]} triangles")
    pts = probe_points(tris, args.n_uniform, args.n_surface,
                       torch.Generator(device=device).manual_seed(args.seed))
    targets = targets_of(pts, tris, args.inset, args.cap)
    scene = build_scene(dist=args.dist).init(torch.Generator().manual_seed(args.seed),
                                             device=device)
    losses = fit(scene, pts, targets, iters=args.iters, batch=args.batch,
                 generator=torch.Generator(device=device).manual_seed(args.seed + 1),
                 log_fn=log_fn)
    rep = report(scene, pts, targets)
    log_fn(f"|f - d| p50 {rep['p50']:.4f} p90 {rep['p90']:.4f} max {rep['max']:.4f}")
    log_fn(f"volume: min {rep['volume_min']:.4f} max {rep['volume_max']:.4f} p50 "
           f"{rep['volume_p50']:.4f} frac_neg {rep['frac_neg']:.3f}")
    return {"scene": scene, "points": pts, "targets": targets, "losses": losses,
            "report": rep}


def main(argv=None) -> dict:
    """Fit and save the seeded scene to ``{models}/{name}``; returns ``run``'s
    dict."""
    from ..training import save_scene
    args = parser().parse_args(argv)
    out = run(args)
    model_dir = os.path.join(args.models, args.name)
    save_scene(model_dir, out["scene"], step=0)
    print(f"seeded scene (fitted shape, fresh bsdf, lights and occ) -> {model_dir}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
