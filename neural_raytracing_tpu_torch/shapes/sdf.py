"""Learnable signed-distance surfaces, the sphere-trace marcher and the
silhouette min-scan.

Counterpart of ``neural_raytracing_tpu/shapes/sdf.py``:
  * ``SphereSDF``: smooth-min of n learnable transformed spheres plus a
    zero-initialised SkipConnMLP residual ``shift``;
  * ``SDF.intersect``: a no-grad sphere trace (the fused kernel K2 on CUDA
    tensors, ``march_plain`` otherwise), over-relaxed with ``omega > 1``,
    optionally clipped to a bounding sphere (``march_bound``), then normals
    from autograd at the hit points;
    with ``primary=True`` also the soft-silhouette throughput
    ``-alpha * min_sdf`` of ``SDF.throughput`` (the min-scan K3 on CUDA
    tensors, ``min_scan_plain`` otherwise; ``throughput_mode="half_res"``
    scans the 2x-subsampled crop grid);
  * ``SDF.intersect_test``: the shadow march (the fused kernel K4 on CUDA
    tensors, ``shadow_march_plain`` otherwise).
The surface may also be a ``kernels.FusedSphereSDF`` (the same parameters,
evaluated by K5), or a ``FunctionalSDF`` around a plain ``p -> sdf``
function built from ``sphere_sdf``, ``box_sdf`` and ``capsule_sdf`` (the
dataset generator's procedural shapes), or ``RoundBoxSDF``, ``CapsuleSDF``
or ``ParametricSDFSet``; the kernels take only a SphereSDF, so the other
surfaces run the plain loops, as in the JAX package.  ``SDF(warp=)`` (the
scene-editing view of ``with_warp``, ``edits.py``) maps each point before
the surface; under a warp the plain float32 loops run over the warped
field, whatever the surface, as the JAX package turns its fused loops off.
``SDF(march_dtype=torch.bfloat16)`` runs the three loops
with bf16 operands in the shift net (K2-bf16, K3-bf16, K4-bf16); the
differentiable evaluations (hit point, normals, throughput value) stay
float32.  ``SDF.level_surfaces`` (the minimum SDF along a ray) and
``SDF.batch_throughput`` (a chunked silhouette scan) are plain PyTorch, as
in the JAX package.  ``prime`` regresses a surface onto a known SDF before
training.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .. import profiling
from ..interaction import Interaction
from ..kernels.fused_march import (
    check_omega, fused_march, fused_min_scan, fused_shadow_march, march_plain,
    min_scan_plain, shadow_march_plain, sphere_sdf_eval_plain, supports,
)
from ..kernels.fused_mlp import FusedSkipConnMLP
from ..nn.mlp import SkipConnMLP, check_compute_dtype
from ..ops import sampling
from ..ops.math import (
    absolute, clip, maximum, minimum, normalize, smooth_min, stable_smooth_min,
)


def march_interval(r_o: torch.Tensor, r_d: torch.Tensor, bound: float,
                   max_t: float):
    """Per-ray ``(t_start, t_end)`` of the march clipped to the
    origin-centred sphere of radius ``bound``; rays that miss it get an
    empty interval and resolve at once."""
    b = torch.sum(r_o * r_d, dim=-1)
    c = torch.sum(r_o * r_o, dim=-1) - bound ** 2
    disc = b * b - c
    s = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = torch.clamp_min(-b - s, 0.0)
    # the exit root is clamped to >= 0: a sphere entirely behind the origin
    # collapses to the empty interval [0, 0]
    t1 = torch.clamp_max(torch.clamp_min(torch.where(disc > 0.0, -b + s, 0.0), 0.0),
                         max_t)
    return torch.minimum(t0, t1), t1


def sphere_sdf(p: torch.Tensor, radius: float = 1.0) -> torch.Tensor:
    return torch.linalg.norm(p, dim=-1) - radius


def box_sdf(p: torch.Tensor, sizes) -> torch.Tensor:
    q = absolute(p) - sizes
    # amax splits the gradient between tied maxima, as jnp.max does
    return (torch.linalg.norm(maximum(q, 0.0), dim=-1)
            + minimum(torch.amax(q, dim=-1), 0.0))


def capsule_sdf(p: torch.Tensor, a, b, r) -> torch.Tensor:
    pa = p - a
    ba = b - a
    h = clip(torch.sum(pa * ba, dim=-1, keepdim=True)
             / torch.sum(ba * ba, dim=-1, keepdim=True), 0.0, 1.0)
    return torch.linalg.norm(pa - ba * h, dim=-1) - r


def adopt_surface(owner: nn.Module, surface: nn.Module) -> None:
    """Register ``surface``'s children and parameters on ``owner`` under
    their own names and keep ``surface`` as ``owner.module``, unregistered:
    the parameters keep the names they have in ``surface``'s own tree."""
    if any(True for _ in surface.buffers(recurse=False)):
        raise ValueError(f"{type(owner).__name__} cannot adopt a surface module with "
                         "buffers of its own")
    for name, child in surface.named_children():
        owner.add_module(name, child)
    for name, param in surface.named_parameters(recurse=False):
        owner.register_parameter(name, param)
    owner.__dict__["module"] = surface


def _uniform(generator: torch.Generator, *shape) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=generator.device)


class FunctionalSDF(nn.Module):
    """A plain ``p -> sdf`` function as a surface module with no parameters
    or buffers (so ``SDF`` adopts it)."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def reset_parameters(self, generator: torch.Generator = None):
        pass

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        return self.fn(p)


UNIT_SPHERE = FunctionalSDF(sphere_sdf)


class SphereSDF(nn.Module):
    """Smooth-min of learnable transformed spheres + zero-init MLP residual.

    ``stable_min=True`` replaces the clamped smooth-min (which saturates at
    -log(1e-4)/k = 0.288 for k=32, the reference's behaviour) with the exact
    logsumexp form.
    """

    def __init__(self, n: int = 128, k: float = 32.0,
                 mlp: Optional[SkipConnMLP] = None, stable_min: bool = False):
        super().__init__()
        self.n = n
        self.k = k
        self.stable_min = stable_min
        self.centers = nn.Parameter(torch.zeros(n, 3))
        self.radii = nn.Parameter(torch.zeros(n))
        self.tfs = nn.Parameter(torch.zeros(n, 3, 3))
        if mlp is None:
            mlp = FusedSkipConnMLP(in_size=3, out=1, num_layers=8,
                                   hidden_size=128, freqs=32,
                                   activation="softplus", init="zeros")
        self.shift = mlp

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.centers.copy_(0.3 * _uniform(generator, self.n, 3) - 0.15)
        self.radii.copy_(0.2 * _uniform(generator, self.n) - 0.1)
        self.tfs.zero_()
        self.shift.reset_parameters(generator)

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        batches = p.shape[:-1]
        flat = p.reshape(-1, 3)
        tfs = self.tfs + torch.eye(3, dtype=flat.dtype, device=flat.device)
        q = torch.einsum("ijk,bk->ibj", tfs, flat) - self.centers[:, None, :]
        sd = torch.linalg.norm(q, dim=-1) - self.radii[:, None]
        mn = stable_smooth_min if self.stable_min else smooth_min
        out = mn(sd, k=self.k, dim=0).reshape(batches)
        return out + self.shift(p)[..., 0]


class RoundBoxSDF(nn.Module):
    """Smooth-min of learnable boxes, axis-aligned in their local frames
    (``radii`` is a parameter the JAX surface declares and does not read)."""

    def __init__(self, n: int = 32, k: float = 16.0):
        super().__init__()
        self.n = n
        self.k = k
        self.centers = nn.Parameter(torch.zeros(n, 3))
        self.b = nn.Parameter(torch.zeros(n, 3))
        self.radii = nn.Parameter(torch.zeros(n))
        self.tfs = nn.Parameter(torch.zeros(n, 3, 3))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.centers.copy_(0.3 * _uniform(generator, self.n, 3) - 0.15)
        self.b.copy_(0.2 * _uniform(generator, self.n, 3))
        self.radii.copy_(0.2 * _uniform(generator, self.n) - 0.1)
        self.tfs.zero_()

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        batches = p.shape[:-1]
        flat = p.reshape(-1, 3)
        tfs = self.tfs + torch.eye(3, dtype=flat.dtype, device=flat.device)
        q = absolute(torch.einsum("ijk,bk->ibj", tfs, flat)
                     - self.centers[:, None, :]) - self.b[:, None, :]
        up = torch.linalg.norm(maximum(q, 1e-7), dim=-1)
        down = minimum(torch.amax(q, dim=-1), -1e-7)
        return smooth_min(up + down, k=self.k, dim=0).reshape(batches)


class CapsuleSDF(nn.Module):
    """Smooth-min of learnable capsules from ``a`` to ``b``."""

    def __init__(self, n: int = 64, k: float = 16.0):
        super().__init__()
        self.n = n
        self.k = k
        self.a = nn.Parameter(torch.zeros(n, 3))
        self.b = nn.Parameter(torch.zeros(n, 3))
        self.radii = nn.Parameter(torch.zeros(n))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.a.copy_(0.1 * _uniform(generator, self.n, 3) - 0.05)
        self.b.copy_(0.1 * _uniform(generator, self.n, 3) - 0.05)
        self.radii.copy_(0.1 * _uniform(generator, self.n) - 0.05)

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        batches = p.shape[:-1]
        flat = p.reshape(-1, 3)
        sd = capsule_sdf(flat[None, :, :], self.a[:, None, :], self.b[:, None, :],
                         self.radii[:, None])
        return smooth_min(sd, k=self.k, dim=0).reshape(batches)


class ParametricSDFSet(nn.Module):
    """Smooth-min over shapes, each a softmax-weighted blend of a sphere, a
    box and a capsule around its offset."""

    def __init__(self, num_shapes: int = 5, k: float = 32.0):
        super().__init__()
        self.num_shapes = num_shapes
        self.k = k
        n = num_shapes
        self.offsets = nn.Parameter(torch.zeros(n, 3))
        self.sph_rads = nn.Parameter(torch.zeros(n))
        self.box_sizes = nn.Parameter(torch.zeros(n, 3))
        self.capsules = nn.Parameter(torch.zeros(n, 7))
        self.descriptors = nn.Parameter(torch.zeros(n, 3))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        n = self.num_shapes
        self.offsets.copy_(_uniform(generator, n, 3) - 0.5)
        self.sph_rads.copy_(_uniform(generator, n) * 0.3 + 0.1)
        self.box_sizes.copy_(_uniform(generator, n, 3) * 0.3 + 0.1)
        self.capsules.copy_(_uniform(generator, n, 7))
        self.descriptors.copy_(_uniform(generator, n, 3))

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        batches = p.shape[:-1]
        flat = p.reshape(-1, 3)
        local = flat[None, :, :] - self.offsets[:, None, :]          # [S, B, 3]
        w = torch.softmax(self.descriptors, dim=-1)                   # [S, 3]
        caps = self.capsules
        sdfs = torch.stack([
            torch.linalg.norm(local, dim=-1) - self.sph_rads[:, None],
            box_sdf(local, self.box_sizes[:, None, :]),
            capsule_sdf(local, caps[:, None, 0:3], caps[:, None, 3:6], caps[:, None, 6]),
        ], dim=-1)                                                    # [S, B, 3]
        per_shape = torch.sum(w[:, None, :] * sdfs, dim=-1)
        return smooth_min(per_shape, k=self.k, dim=0).reshape(batches)


class SDF(nn.Module):
    """Sphere-trace intersection driver around a surface module.

    The surface module's parameters are this module's own (``centers``,
    ``shift.layers.0.w``, ...), as the JAX ``SDF.init`` returns the
    module's params unchanged.

    ``warp`` (None, or a ``p -> p`` function of ``edits.py``) maps every
    point before the surface; ``with_warp`` gives such a view.  Under a warp
    the kernels are never taken: the three loops run in float32 over the
    warped field on any device (the JAX package's ``_fused_loop_state``).

    ``fused_loops``: "auto" (K2 for CUDA tensors, the plain loop for CPU
    tensors), "force" (K2; raises on CPU tensors) or "off".  ``omega`` in
    [1, 2) over-relaxes the primary march (1: the reference's march); it is
    read at every march, so setting it on a built SDF takes effect.
    ``march_dtype`` (None: float32, or torch.bfloat16) is the operand dtype
    of the shift net inside the three no-grad loops: on CUDA tensors the
    bf16 kernels, on CPU tensors in "auto" their plain versions (the JAX
    ``fused_loops="force"``); "off" takes the float32 loop over ``sdf``
    whatever the dtype, as the JAX loop does.
    """

    def __init__(self, sdf_module: nn.Module, epsilon: float = 1e-3,
                 max_steps: int = 32, dist: float = 2.2,
                 throughput_steps: int = 128, alpha: float = 1000.0,
                 fused_loops: str = "auto", omega: float = 1.0,
                 shadow_past_light_exit: bool = True,
                 throughput_mode: str = "full",
                 march_bound: Optional[float] = None, march_dtype=None,
                 warp: Optional[Callable] = None):
        super().__init__()
        if fused_loops not in ("auto", "force", "off"):
            raise ValueError("fused_loops must be 'auto', 'force' or 'off', "
                             f"got {fused_loops!r}")
        if throughput_mode not in ("full", "half_res"):
            raise ValueError("throughput_mode must be 'full' or 'half_res', "
                             f"got {throughput_mode!r}")
        check_omega(omega)
        adopt_surface(self, sdf_module)
        self.epsilon = epsilon
        self.max_steps = max_steps
        # silhouette min-scan settings of the training slice
        self.dist = dist
        self.throughput_steps = throughput_steps
        self.alpha = alpha
        # "half_res": the min-scan on the 2x-subsampled crop grid
        self.throughput_mode = throughput_mode
        self.fused_loops = fused_loops
        self.omega = omega
        # freeze a shadow ray once it marches past the light (it is
        # unblocked); False keeps marching as the reference does, where a
        # negative-SDF overshoot can pull a ray back before max_t
        self.shadow_past_light_exit = shadow_past_light_exit
        # opt-in eval accelerator: clip the primary march to the ray's
        # interval inside the origin-centred sphere of this radius
        self.march_bound = march_bound
        self.march_dtype = check_compute_dtype(
            torch.float32 if march_dtype is None else march_dtype)
        self.warp = warp

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.module.reset_parameters(generator)

    def replace(self, **overrides) -> "SDF":
        """A view of this SDF, over the same surface and parameters, with
        some settings (``max_steps``, ``march_bound``, ...) overridden."""
        cfg = {k: getattr(self, k) for k in (
            "epsilon", "max_steps", "dist", "throughput_steps", "alpha",
            "fused_loops", "omega", "shadow_past_light_exit",
            "throughput_mode", "march_bound", "march_dtype", "warp")}
        cfg.update(overrides)
        return SDF(self.module, **cfg)

    def with_warp(self, warp: Callable) -> "SDF":
        """A view of this SDF, over the same surface and parameters, whose
        points go through ``warp`` first; it replaces any earlier warp."""
        return self.replace(warp=warp)

    def sdf(self, p: torch.Tensor) -> torch.Tensor:
        if self.warp is not None:
            p = self.warp(p)
        return self.module(p)

    def _use_kernel(self, r_o: torch.Tensor) -> bool:
        if (self.fused_loops == "off" or self.warp is not None
                or not supports(self.module)):
            return False
        return self.fused_loops == "force" or r_o.is_cuda

    def _loop_sdf(self):
        """The SDF the plain loops evaluate: the bf16 kernels' plain version
        where a bf16 kernel would run, else ``sdf`` (under a warp always)."""
        if (self.march_dtype == torch.float32 or self.fused_loops == "off"
                or self.warp is not None or not supports(self.module)):
            return self.sdf
        return lambda p: sphere_sdf_eval_plain(self.module, p, self.march_dtype)

    def _march(self, r_o, r_d, max_t, t_start=None):
        """No-grad sphere trace. Returns (depths [...], hit mask [...])."""
        profiling.count("march.rays", r_o.numel() // 3)
        with profiling.annotate("nrt.sdf.march"):
            if self._use_kernel(r_o):
                return fused_march(self.module, r_o, r_d, max_t,
                                   max_steps=self.max_steps, epsilon=self.epsilon,
                                   omega=self.omega, t_start=t_start,
                                   compute_dtype=self.march_dtype)
            depths, hit, _ = march_plain(self._loop_sdf(), r_o, r_d, max_t, t_start,
                                         max_steps=self.max_steps,
                                         epsilon=self.epsilon, omega=self.omega)
        return depths, hit

    def normals(self, p: torch.Tensor) -> torch.Tensor:
        """Un-normalized SDF gradient at ``p``; differentiable (a graph of
        the gradient is built) when grad mode is on."""
        create = torch.is_grad_enabled()
        with profiling.annotate("nrt.sdf.normals"), torch.enable_grad():
            q = p if create and p.requires_grad else p.detach().requires_grad_()
            (g,) = torch.autograd.grad(self.sdf(q).sum(), q, create_graph=create)
        return g

    def throughput(self, r_o: torch.Tensor, r_d: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
        """Soft silhouette: the SDF at the argmin of a min-scan along the ray,
        differentiable at that point only.

        With a ``generator`` the scan length ``dist`` is jittered by
        ``U(0, 1) * 2 / steps``; without one it is not.  Returns (SDF value at
        the argmin point [...], best position [..., 3]).
        """
        steps = self.throughput_steps
        if generator is None:
            step = torch.tensor(self.dist / steps, dtype=torch.float32,
                                device=r_o.device)
        else:
            u = sampling.uniform(generator, (), r_o.device)
            step = (self.dist + u * (2.0 / steps)) / steps
        profiling.count("scan.samples", r_o.numel() // 3 * (steps + 1))
        with profiling.annotate("nrt.sdf.scan"):
            if self._use_kernel(r_o):
                idxs = fused_min_scan(self.module, r_o, r_d, step, steps=steps,
                                      compute_dtype=self.march_dtype)
            else:
                idxs = min_scan_plain(self._loop_sdf(), r_o.detach(), r_d.detach(),
                                      step, steps=steps)
        best_pos = (r_o + (idxs * step)[..., None] * r_d).detach()
        return self.sdf(best_pos), best_pos

    def half_res_throughput(self, r_o: torch.Tensor, r_d: torch.Tensor,
                            generator: Optional[torch.Generator] = None):
        """Throughput on the 2x-subsampled pixel grid, nearest-upsampled back.
        ``r_o``/``r_d`` are ``[N, W, H, ..., 3]`` ray grids; every 2x2 pixel
        block shares one sample."""
        sd, _ = self.throughput(r_o[:, ::2, ::2], r_d[:, ::2, ::2], generator)
        sd = sd.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return sd[:, :r_o.shape[1], :r_o.shape[2]]

    def batch_throughput(self, r_o: torch.Tensor, r_d: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         batch_size: int = 56, per: int = 32, max_t: float = 2.0):
        """A chunked min-scan: the SDF at ``batch_size`` samples of ``t`` in
        ``[0, max_t]`` (their grid shifted by ``U(0, 1) * max_t /
        batch_size`` with a ``generator``), ``per`` at a time, keeping the
        argmin; then one differentiable evaluation at the best ``t``."""
        jitter = 0.0
        if generator is not None:
            jitter = sampling.uniform(generator, (), r_o.device) * (max_t / batch_size)
        ts = torch.linspace(0.0, max_t, batch_size, device=r_o.device) + jitter
        pad = (-batch_size) % per
        if pad:
            ts = torch.cat([ts, torch.full((pad,), torch.inf, device=r_o.device)])
        batch = r_o.shape[:-1]
        bests = torch.full(batch, torch.inf, device=r_o.device)
        best_t = torch.zeros(batch, device=r_o.device)
        expand = (...,) + (None,) * r_o.dim()
        with torch.no_grad():
            for tb in ts.reshape(-1, per):
                p = r_o[None] + tb[expand] * r_d[None]
                sd = torch.where(torch.isfinite(tb)[(...,) + (None,) * (r_o.dim() - 1)],
                                 self.sdf(p), torch.inf)
                mins, idxs = torch.min(sd, dim=0)
                better = mins < bests
                bests = torch.where(better, mins, bests)
                best_t = torch.where(better, tb[idxs], best_t)
        return self.sdf(r_o + best_t[..., None] * r_d)

    def intersect(self, rays: torch.Tensor, max_t: float = 10.0,
                  primary: bool = True,
                  generator: Optional[torch.Generator] = None):
        """-> (Interaction, hit [...]) for ``rays [..., 6]``.

        ``primary=True`` adds the silhouette ``throughput`` logits (training
        intersections); ``generator`` jitters its scan.
        """
        r_o, r_d = rays[..., :3], rays[..., 3:]
        if self.march_bound is not None:
            t0, t1 = march_interval(r_o, r_d, self.march_bound, max_t)
            depths, hit = self._march(r_o, r_d, t1, t_start=t0)
        else:
            depths, hit = self._march(r_o, r_d, max_t)
        p = r_o + depths[..., None] * r_d

        throughput = None
        if primary:
            # half_res needs the [N, W, H, ...] crop grid; flat ray batches
            # take the full scan
            if self.throughput_mode == "half_res" and r_o.ndim >= 4:
                min_sdf = self.half_res_throughput(r_o, r_d, generator)
            else:
                min_sdf, _ = self.throughput(r_o, r_d, generator)
            throughput = -self.alpha * min_sdf

        raw_normals = self.normals(p)
        n = torch.where(hit[..., None], normalize(raw_normals, eps=1e-6), 0.0)
        p = p + n * (self.epsilon * 5.0)

        it = Interaction(p=p, t=depths, throughput=throughput,
                         raw_normals=raw_normals).with_normals(n)
        it = it._replace(wi=it.to_local(-r_d))
        return it, hit

    def intersect_test(self, rays: torch.Tensor, max_t=10.0,
                       active=None) -> torch.Tensor:
        """True where the ray ``[..., 6]`` is NOT blocked before ``max_t`` (a
        scalar or per ray); no gradient.  ``active`` is accepted and, as in
        the reference, not used."""
        r_o, r_d = rays[..., :3], rays[..., 3:]
        profiling.count("shadow.rays", r_o.numel() // 3)
        with profiling.annotate("nrt.sdf.shadow"):
            if self._use_kernel(r_o):
                return fused_shadow_march(
                    self.module, r_o, r_d, max_t, max_steps=self.max_steps,
                    epsilon=self.epsilon,
                    past_light_exit=self.shadow_past_light_exit,
                    compute_dtype=self.march_dtype)
            not_blocked, _ = shadow_march_plain(
                self._loop_sdf(), r_o, r_d, max_t, max_steps=self.max_steps,
                epsilon=self.epsilon, past_light_exit=self.shadow_past_light_exit)
        return not_blocked

    def level_surfaces(self, rays: torch.Tensor, steps: int = 128) -> torch.Tensor:
        """The minimum SDF along each ray over ``steps`` points of ``t`` in
        ``[0, dist]`` (the ``LevelSurfaces`` debug integrator)."""
        r_o, r_d = rays[..., :3], rays[..., 3:]
        out = torch.full(r_o.shape[:-1], torch.inf, device=r_o.device)
        for t in torch.linspace(0.0, self.dist, steps, device=r_o.device):
            out = torch.minimum(out, self.sdf(r_o + t * r_d))
        return out


def prime(sdf: SDF, known_sdf: Callable, generator: torch.Generator, lr: float = 1e-4,
          iters: int = 2000, batch_size: int = 4096, lo: float = -5.0,
          hi: float = 5.0) -> torch.Tensor:
    """Regress ``sdf`` (in place) onto ``known_sdf`` before training: ``iters``
    AdamW steps (optax's ``adamw(lr, weight_decay=0.0)``, no clipping) of
    the mean squared difference at ``batch_size`` points drawn uniformly in
    ``[lo, hi]^3`` through ``ops.sampling.uniform``.  Returns the last
    step's loss (a 0-d tensor on the surface's device)."""
    from ..training.optim import make_optimizer
    device = next(sdf.parameters()).device
    opt = make_optimizer({}, default_lr=lr).init(sdf)
    loss = None
    for _ in range(iters):
        u = sampling.uniform(generator, (batch_size, 3), device)
        p = torch.clamp_min(u * (hi - lo) + lo, lo)
        loss = torch.mean(torch.square(sdf.sdf(p) - known_sdf(p)))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return None if loss is None else loss.detach()
