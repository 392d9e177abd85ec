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
evaluated by K5).  ``SDF(march_dtype=torch.bfloat16)`` runs the three loops
with bf16 operands in the shift net (K2-bf16, K3-bf16, K4-bf16); the
differentiable evaluations (hit point, normals, throughput value) stay
float32.  ``batch_throughput`` is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..interaction import Interaction
from ..kernels.fused_march import (
    check_omega, fused_march, fused_min_scan, fused_shadow_march, march_plain,
    min_scan_plain, shadow_march_plain, sphere_sdf_eval_plain, supports,
)
from ..kernels.fused_mlp import FusedSkipConnMLP
from ..nn.mlp import SkipConnMLP, check_compute_dtype
from ..ops.math import normalize, smooth_min, stable_smooth_min


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
        def u(*shape):
            return torch.rand(shape, generator=generator, device=generator.device)
        self.centers.copy_(0.3 * u(self.n, 3) - 0.15)
        self.radii.copy_(0.2 * u(self.n) - 0.1)
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


class SDF(nn.Module):
    """Sphere-trace intersection driver around a surface module.

    The surface module's parameters are this module's own (``centers``,
    ``shift.layers.0.w``, ...), as the JAX ``SDF.init`` returns the
    module's params unchanged.

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
                 march_bound: Optional[float] = None, march_dtype=None):
        super().__init__()
        if fused_loops not in ("auto", "force", "off"):
            raise ValueError("fused_loops must be 'auto', 'force' or 'off', "
                             f"got {fused_loops!r}")
        if throughput_mode not in ("full", "half_res"):
            raise ValueError("throughput_mode must be 'full' or 'half_res', "
                             f"got {throughput_mode!r}")
        check_omega(omega)
        if any(True for _ in sdf_module.buffers(recurse=False)):
            raise ValueError("SDF cannot adopt a surface module with buffers "
                             "of its own")
        # share the surface's parameters and children under this module's
        # name; the surface itself stays an unregistered attribute
        for name, child in sdf_module.named_children():
            self.add_module(name, child)
        for name, param in sdf_module.named_parameters(recurse=False):
            self.register_parameter(name, param)
        self.__dict__["module"] = sdf_module
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

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.module.reset_parameters(generator)

    def replace(self, **overrides) -> "SDF":
        """A view of this SDF, over the same surface and parameters, with
        some settings (``max_steps``, ``march_bound``, ...) overridden."""
        cfg = {k: getattr(self, k) for k in (
            "epsilon", "max_steps", "dist", "throughput_steps", "alpha",
            "fused_loops", "omega", "shadow_past_light_exit",
            "throughput_mode", "march_bound", "march_dtype")}
        cfg.update(overrides)
        return SDF(self.module, **cfg)

    def sdf(self, p: torch.Tensor) -> torch.Tensor:
        return self.module(p)

    def _use_kernel(self, r_o: torch.Tensor) -> bool:
        if self.fused_loops == "off" or not supports(self.module):
            return False
        return self.fused_loops == "force" or r_o.is_cuda

    def _loop_sdf(self):
        """The SDF the plain loops evaluate: the bf16 kernels' plain version
        where a bf16 kernel would run, else ``sdf``."""
        if (self.march_dtype == torch.float32 or self.fused_loops == "off"
                or not supports(self.module)):
            return self.sdf
        return lambda p: sphere_sdf_eval_plain(self.module, p, self.march_dtype)

    def _march(self, r_o, r_d, max_t, t_start=None):
        """No-grad sphere trace. Returns (depths [...], hit mask [...])."""
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
        with torch.enable_grad():
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
            u = torch.rand((), generator=generator, device=generator.device)
            step = (self.dist + u.to(r_o.device) * (2.0 / steps)) / steps
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
