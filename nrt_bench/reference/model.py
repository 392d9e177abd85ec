"""Plain float32 PyTorch reference of the scenes the benchmark runs.

Written from the published model (prashantraina/neural_raytracing,
``scripts/nerf_synthetic.py`` and ``scripts/nerv.py``) as the port states
it, with no kernel, no cache and no batching trick: a learned surface (of
the kind its configuration names, one module each under ``surfaces/``), a
sphere trace, the silhouette min-scan, the shadow march, neural BSDF lobes
under a spatially varying weight net, and a learned light field or a point
light with hard or learned shadows, under direct lighting.

Everything is read from a configuration file (``nrt_bench/configs``) and a
flat ``{name: tensor}`` of weights that the benchmark made or loaded.  This
module imports nothing of the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .surfaces import surface_kind


def leaky_relu(x):
    # slope 1 at exactly 0, as the published (JAX) activation
    return torch.where(x >= 0, x, 0.01 * x)


ACTIVATIONS = {"leaky_relu": leaky_relu, "softplus": F.softplus, "relu": F.relu,
               "sigmoid": torch.sigmoid, "tanh": torch.tanh}


def normalize(v, eps=1e-7):
    return v / torch.sqrt(torch.clamp_min(torch.sum(v * v, dim=-1, keepdim=True), eps * eps))


def nonzero_eps(v, eps=1e-7):
    return torch.where(torch.abs(v) < eps, torch.full_like(v, eps), v)


def rotate_vector(v, axis, c, s):
    return (v * c + axis * torch.sum(v * axis, dim=-1, keepdim=True) * (1.0 - c)
            + torch.linalg.cross(axis, v, dim=-1) * s)


class Net:
    """A skip-connection MLP: ``enc = [x, sin(x B), cos(x B)]``, the
    activation before each linear layer, ``[h, enc]`` fed to every layer
    ``i`` with ``i % skip == 0`` and ``i != L - 1``; weights ``w [fan_in,
    fan_out]`` under ``<prefix>init``, ``layers.<i>``, ``out``."""

    def __init__(self, spec: dict, weights: dict, prefix: str):
        self.spec = spec
        self.w = weights
        self.p = prefix
        self.act = ACTIVATIONS[spec.get("activation", "leaky_relu")]

    def __call__(self, x):
        s, w, p = self.spec, self.w, self.p
        batch = x.shape[:-1]
        x = x.reshape(-1, s["in_size"])
        mapped = x @ w[p + "B"].detach()
        enc = torch.cat([x, torch.sin(mapped), torch.cos(mapped)], dim=-1)
        h = enc @ w[p + "init.w"] + w[p + "init.b"]
        n = s["num_layers"]
        for i in range(n):
            if i % s.get("skip", 3) == 0 and i != n - 1:
                h = torch.cat([h, enc], dim=-1)
            h = self.act(h) @ w[f"{p}layers.{i}.w"] + w[f"{p}layers.{i}.b"]
        out = self.act(h) @ w[p + "out.w"] + w[p + "out.b"]
        return out.reshape(batch + (s["out"],))


def Surface(cfg: dict, weights: dict):
    """The configuration's surface: the plain SDF of its kind's module,
    ``surfaces/<cfg["surface"]["kind"]>.py``."""
    spec = cfg["surface"]
    return surface_kind(spec).Surface(spec, weights)


# ---- the three loops ---------------------------------------------------------

@torch.no_grad()
def march(sdf, r_o, r_d, max_t, t_start, *, max_steps, epsilon):
    """Sphere trace -> ``(depths, hit, evals)``; ``evals`` counts per ray the
    steps on which it still needed an SDF evaluation."""
    batch = r_o.shape[:-1]
    depths = (torch.zeros(batch, device=r_o.device) if t_start is None
              else t_start.clone())
    max_t = torch.as_tensor(max_t, dtype=torch.float32, device=r_o.device).expand(batch)
    remaining = torch.ones(batch, dtype=torch.bool, device=r_o.device)
    hit = torch.zeros_like(remaining)
    evals = torch.zeros(batch, dtype=torch.int64, device=r_o.device)
    for _ in range(max_steps):
        remaining = remaining & (depths < max_t)
        evals += remaining
        sd = sdf(r_o + r_d * depths[..., None])
        hits = remaining & (sd <= epsilon)
        hit = hit | hits
        remaining = remaining & ~hits
        depths = torch.where(remaining, depths + sd, depths)
    return depths, hit, evals


@torch.no_grad()
def min_scan(sdf, r_o, r_d, step, steps):
    """Index of the earliest strict minimum of the SDF over ``t = step i``,
    ``i = 0..steps``, as float32."""
    mn = sdf(r_o)
    idx = torch.zeros(mn.shape, dtype=torch.int64, device=r_o.device)
    for i in range(1, steps + 1):
        sd = sdf(r_o + (step * float(i)) * r_d)
        idx = torch.where(sd < mn, i, idx)
        mn = torch.minimum(mn, sd)
    return idx.to(torch.float32)


@torch.no_grad()
def shadow_march(sdf, r_o, r_d, max_t, *, max_steps, epsilon, past_light_exit):
    """-> ``(not_blocked, evals)``: a ray starts at ``100 epsilon`` and is
    blocked once the SDF falls below ``epsilon``; with ``past_light_exit`` a
    ray that has passed ``max_t`` stops marching."""
    batch = r_o.shape[:-1]
    max_t = torch.as_tensor(max_t, dtype=torch.float32, device=r_o.device).expand(batch)
    depths = torch.full(batch, 1e2 * epsilon, device=r_o.device)
    remaining = torch.ones(batch, dtype=torch.bool, device=r_o.device)
    evals = torch.zeros(batch, dtype=torch.int64, device=r_o.device)
    for _ in range(max_steps):
        live = remaining & (depths < max_t) if past_light_exit else remaining
        evals += live
        d = sdf(r_o + r_d * depths[..., None])
        hits = live & (d < epsilon)
        depths = torch.where(live, depths + d, depths)
        remaining = remaining & ~hits
    return (depths >= max_t) | remaining, evals


def march_interval(r_o, r_d, bound, max_t):
    b = torch.sum(r_o * r_d, dim=-1)
    c = torch.sum(r_o * r_o, dim=-1) - bound ** 2
    disc = b * b - c
    s = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = torch.clamp_min(-b - s, 0.0)
    t1 = torch.clamp_max(torch.clamp_min(torch.where(disc > 0.0, -b + s, 0.0), 0.0), max_t)
    return torch.minimum(t0, t1), t1


# ---- frames, the BRDF parameterization, directions ---------------------------

def coordinate_system(n):
    n = normalize(n)
    x, y, z = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    sign = torch.where(z >= 0, 1.0, -1.0)
    s_z = sign + z
    a = -1.0 / torch.where(torch.abs(s_z) < 1e-6, torch.full_like(s_z, 1e-6), s_z)
    b = x * y * a
    s = normalize(torch.cat([x * x * a * sign + 1.0, b * sign, x * -sign], dim=-1))
    t = normalize(torch.linalg.cross(s, n, dim=-1))
    s = normalize(torch.linalg.cross(n, t, dim=-1))
    return torch.stack([s, t, n], dim=-1)


def to_local(frame, v):
    return normalize(torch.einsum("...ij,...i->...j", frame, v))


def rusin(wo, wi):
    """``[cos phi_d, cos theta_h, cos theta_d]`` of two local directions."""
    wo, wi = normalize(wo), normalize(wi)
    e1 = torch.tensor((0.0, 1.0, 0.0), device=wo.device).expand(wo.shape)
    e2 = torch.tensor((0.0, 0.0, 1.0), device=wo.device).expand(wo.shape)
    h = normalize(wo + wi)
    r = torch.clamp_min(torch.hypot(nonzero_eps(h[..., 1]), nonzero_eps(h[..., 0])), 1e-6)
    tmp = normalize(rotate_vector(wi, e2, (h[..., 0] / r)[..., None], -(h[..., 1] / r)[..., None]))
    s = -torch.sqrt(torch.clamp_min(1.0 - h[..., 2], 1e-6))[..., None]
    diff = normalize(rotate_vector(tmp, e1, h[..., 2][..., None], s))
    cos_phi_d = torch.cos(torch.atan2(nonzero_eps(diff[..., 1]), nonzero_eps(diff[..., 0])))
    return torch.stack([cos_phi_d, h[..., 2], diff[..., 2]], dim=-1)


def dir_to_elev_azim(d):
    d = torch.clamp(normalize(d), -1.0 + 1e-7, 1.0 - 1e-7)
    x, z = d[..., 0:1], d[..., 2:3]
    return torch.cat([torch.arcsin(z),
                      torch.atan2(x, torch.sqrt(torch.clamp_min(1.0 - x * x - z * z, 1e-10)))],
                     dim=-1)


# ---- the scene -----------------------------------------------------------------

class Scene:
    """A configuration's scene over a flat dict of weights.  ``march`` holds
    the cell's march settings (``max_steps``, ``march_bound``, ``occlusion``)."""

    def __init__(self, cfg: dict, weights: dict, march: dict):
        self.cfg = cfg
        self.w = weights
        self.m = {**cfg["sdf"], **march}
        self.sdf = Surface(cfg, weights)
        b = cfg["bsdf"]
        self.weight_net = Net(b["weight_net"], weights, "bsdf.sp_var_fn.")
        self.lobes = [Net(b["lobe"], weights, f"bsdf.bsdfs.{i}.mlp.")
                      for i in range(b["lobes"])]
        self.lobe_act = ACTIVATIONS[b["lobe_activation"]]
        light = cfg["light"]
        self.light_net = (Net(light["net"], weights, "lights.mlp.")
                          if light["kind"] == "light_field" else None)
        self.occ = (Net(cfg["occlusion_net"], weights, "occ.")
                    if self.m.get("occlusion") == "learned" else None)

    def normals(self, p, create_graph):
        with torch.enable_grad():
            q = p.detach().requires_grad_()
            (g,) = torch.autograd.grad(self.sdf(q).sum(), q, create_graph=create_graph)
        return g

    def intersect(self, rays, *, primary, jitter=None, max_t=10.0):
        """-> ``(it, hit, evals)``, ``it`` a dict of ``p, n, frame, wi,
        throughput, raw_normals``; ``jitter`` the min-scan's uniform draw."""
        m = self.m
        r_o, r_d = rays[..., :3], rays[..., 3:]
        if m.get("march_bound"):
            t0, t1 = march_interval(r_o, r_d, m["march_bound"], max_t)
            depths, hit, evals = march(self.sdf, r_o, r_d, t1, t0,
                                       max_steps=m["max_steps"], epsilon=m["epsilon"])
        else:
            depths, hit, evals = march(self.sdf, r_o, r_d, max_t, None,
                                       max_steps=m["max_steps"], epsilon=m["epsilon"])
        p = r_o + depths[..., None] * r_d
        it = {}
        if primary:
            steps = m["throughput_steps"]
            if jitter is None:
                step = torch.tensor(m["dist"] / steps, device=r_o.device)
            else:
                step = (m["dist"] + jitter * (2.0 / steps)) / steps
            idx = min_scan(self.sdf, r_o, r_d, step, steps)
            best = (r_o + (idx * step)[..., None] * r_d).detach()
            it["throughput"] = -m["alpha"] * self.sdf(best)
        raw = self.normals(p, create_graph=torch.is_grad_enabled())
        n = torch.where(hit[..., None], normalize(raw, eps=1e-6), 0.0)
        p = p + n * (m["epsilon"] * 5.0)
        frame = coordinate_system(n)
        it.update(p=p, n=n, frame=frame, raw_normals=raw, wi=to_local(frame, -r_d))
        return it, hit, evals

    def emitter(self, it, active, light_loc=None):
        """-> ``(d, spectrum, shadow)`` of the scene's delta light; ``shadow``
        is ``(not_blocked, evals)`` per ray, or None without shadow rays."""
        p = it["p"]
        ok = active[..., None]
        if self.light_net is not None:
            non_norm = self.light_net(p)
            d = torch.clamp(normalize(non_norm, eps=1e-6), 1e-6, 1.0)
            spectrum = torch.linalg.norm(non_norm, dim=-1, keepdim=True) * torch.sigmoid(
                self.w["lights.color"])
            return torch.where(ok, d, 0.0), torch.where(ok, spectrum, 0.0), None
        w = self.w
        loc = light_loc.reshape((1,) * (p.dim() - 1) + (3,))
        d = loc - p
        dist = torch.linalg.norm(d, dim=-1, keepdim=True)
        d = normalize(d, eps=1e-6)
        falloff = (torch.clamp_min(w["lights.const"], 1e-6)
                   + torch.clamp_min(w["lights.linear"], 1e-6) * dist
                   + torch.clamp_min(w["lights.square"], 1e-6) * dist * dist)
        color = normalize(w["lights.intensity"]).reshape((1,) * (p.dim() - 1) + (3,))
        spectrum = torch.where(ok, w["lights.scale"] * color / torch.clamp_min(falloff, 1e-6), 0.0)
        occlusion = self.m.get("occlusion", "none")
        if occlusion == "none":
            return d, spectrum, None
        not_blocked, evals = shadow_march(
            self.sdf, p, d, dist[..., 0], max_steps=self.m["max_steps"],
            epsilon=self.m["epsilon"], past_light_exit=self.m["shadow_past_light_exit"])
        if occlusion == "hard":
            spectrum = torch.where((not_blocked & active)[..., None], spectrum, 0.0)
        else:
            att = torch.sigmoid(self.occ(torch.cat([p, dir_to_elev_azim(d)], dim=-1)))
            spectrum = torch.where((~not_blocked)[..., None], att * spectrum, spectrum) * ok
        return d, spectrum, (not_blocked, evals)

    def bsdf(self, it, wo, active):
        k = torch.sigmoid(self.weight_net(it["p"]))
        x = rusin(it["wi"], wo)
        total = 0.0
        for i, lobe in enumerate(self.lobes):
            total = total + self.lobe_act(lobe(x)) * k[..., i:i + 1]
        return torch.where(active[..., None], total, 0.0)

    def direct(self, rays, *, primary, jitter=None, light_loc=None):
        """Direct lighting -> ``(rgb, hit, it, work)``; ``work`` holds per ray
        ``march_evals`` and, with shadow rays, ``shadow_evals`` and
        ``blocked``."""
        it, hit, evals = self.intersect(rays, primary=primary, jitter=jitter)
        d, spectrum, shadow = self.emitter(it, hit, light_loc)
        wo = to_local(it["frame"], d)
        val = self.bsdf(it, wo, hit) * spectrum
        work = {"march_evals": evals}
        if shadow is not None:
            work.update(shadow_evals=shadow[1], blocked=~shadow[0] & hit)
        return torch.where(hit[..., None], val, 0.0), hit, it, work


# ---- cameras -----------------------------------------------------------------

def tile_positions(x_start, y_start, chunk, device):
    offs = torch.arange(chunk, dtype=torch.float32, device=device)
    gx, gy = torch.meshgrid(x_start + offs, y_start + offs, indexing="ij")
    return torch.stack([gy, gx], dim=-1)


def camera_rays(c2w, focal, positions, size, jitter=None, noise: float = 1e-3):
    """``[N, c, c, 1, 6]`` pinhole rays (NeRF convention) of ``c2w [N, 3, 4]``
    through ``positions [c, c, 2]``, each moved by ``noise * (u - 1/2)`` for
    the uniforms ``jitter [c, c, 1, 2]``."""
    pos = positions[..., None, :]
    if jitter is not None:
        pos = pos + noise * jitter - noise / 2.0
    u, v = pos[..., 0:1], pos[..., 1:2]
    d = torch.cat([(u - size * 0.5) / focal, -(v - size * 0.5) / focal,
                   -torch.ones_like(u)], dim=-1)
    r_d = normalize(torch.einsum("...j,nij->n...i", d, c2w[:, :3, :3]))
    r_o = c2w[:, :3, 3][:, None, None, None, :].expand(r_d.shape)
    return torch.cat([r_o, r_d], dim=-1)


def tile_jitter(key: int, idx: int, chunk: int, device):
    """The uniforms that jitter the pixels of tile ``idx`` of a view rendered
    under ``key``: the tile's generator is seeded from ``(key, idx)``."""
    seed = int(np.random.SeedSequence([key, idx]).generate_state(1, np.uint64)[0])
    g = torch.Generator(device=device).manual_seed(seed & ((1 << 63) - 1))
    return torch.rand((chunk, chunk, 1, 2), generator=g, device=device)


def focal_length(size: int, camera_angle_x: float) -> float:
    return 0.5 * size / math.tan(0.5 * camera_angle_x)
