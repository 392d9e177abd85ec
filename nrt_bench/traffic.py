"""The one traffic generator: every mix is a data file under
``nrt_bench/traffic`` whose parameters this module reads.

Cameras orbit the origin at a fixed distance (``dist``), looking at it, with
the world's up axis ``up`` ("y": the NeRF-synthetic convention, "z": the
mesh datasets' upper hemisphere).  A mix's views come in cycles of
``cycle`` views; the elevations and azimuths of a cycle are a Latin
hypercube over their ranges, drawn from the seed, so every seed asks for the
same spread of views in another order.  A view may carry a point light
placed as the nerv-format datasets place a frame's light: on a sphere of
``radius`` about the origin, in the camera's direction moved by ``noise``
times a standard normal draw.  View ``i`` of a seed depends on the seed and
``i`` alone, so a window may take as many views as it reaches.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent numpy generator for each stream of a seed."""
    return np.random.default_rng(np.random.SeedSequence([seed & (2 ** 64 - 1), *stream]))


def c2w(elev_deg: float, azim_deg: float, dist: float, up: str) -> np.ndarray:
    """``[3, 4]`` camera-to-world of a camera at (elev, azim, dist) looking at
    the origin along its -z axis."""
    e, a = math.radians(elev_deg), math.radians(azim_deg)
    if up == "y":
        pos = np.asarray([dist * math.cos(e) * math.sin(a), dist * math.sin(e),
                          dist * math.cos(e) * math.cos(a)])
        world_up = [0.0, 1.0, 0.0]
    else:
        pos = np.asarray([dist * math.cos(e) * math.cos(a), dist * math.cos(e) * math.sin(a),
                          dist * math.sin(e)])
        world_up = [0.0, 0.0, 1.0]
    forward = pos / np.linalg.norm(pos)
    right = np.cross(world_up, forward)
    right = right / max(np.linalg.norm(right), 1e-9)
    m = np.zeros((3, 4))
    m[:, 0], m[:, 1], m[:, 2], m[:, 3] = right, np.cross(forward, right), forward, pos
    return m.astype(np.float32)


def focal(mix: dict) -> float:
    return 0.5 * mix["size"] / math.tan(0.5 * mix["camera_angle_x"])


def hypercube(mix: dict, rng: np.random.Generator, n: int) -> list:
    """``n`` (elev, azim) pairs, a Latin hypercube over the mix's ranges."""
    (e0, e1), (a0, a1) = mix["elev"], mix["azim"]
    strata = (np.arange(n) + rng.uniform(size=(2, n))) / n
    elev = e0 + (e1 - e0) * strata[0][rng.permutation(n)]
    azim = a0 + (a1 - a0) * strata[1]
    order = rng.permutation(n)
    return list(zip(elev[order].tolist(), azim[order].tolist()))


class Views:
    """The views of a render mix, made on demand: ``views[i]`` is a dict of
    ``c2w [3, 4]``, ``light`` (a point light's ``[3]`` location, or None) and
    ``key`` (the render's jitter seed).  Cycle ``c``'s poses come from a
    stream of ``(seed, stream, c)`` and view ``i``'s light and key from one
    of ``(seed, stream, i)``."""

    def __init__(self, mix: dict, seed: int, stream: int = 0):
        self.mix, self.seed, self.stream = mix, seed, stream
        self.cycles = {}

    def __getitem__(self, i: int) -> dict:
        mix = self.mix
        c, j = divmod(i, mix["cycle"])
        if c not in self.cycles:
            self.cycles[c] = hypercube(mix, rng_for(self.seed, 1, self.stream, c), mix["cycle"])
        elev, azim = self.cycles[c][j]
        m = c2w(elev, azim, mix["dist"], mix["up"])
        rng = rng_for(self.seed, 5, self.stream, i)
        light = None
        if mix.get("light"):
            d = m[:, 3] / np.linalg.norm(m[:, 3]) + mix["light"]["noise"] * rng.normal(size=3)
            light = (mix["light"]["radius"] * d / np.linalg.norm(d)).astype(np.float32)
        return {"c2w": m, "light": light, "key": int(rng.integers(0, 2 ** 31))}


def sphere_ground_truth(mix: dict, seed: int, device) -> tuple:
    """The training split of a train mix: ``mix["views"]`` views of an
    analytic diffuse sphere (``gt``: radius, albedo, light direction and
    ambient term) at poses drawn from the seed -> ``(c2ws [V, 3, 4], images
    [V, S, S, 3], masks [V, S, S])``, numpy float32.  Made on ``device`` in
    float64, a view at a time."""
    from .reference.model import camera_rays, tile_positions
    gt, size = mix["gt"], mix["size"]
    poses = hypercube(mix, rng_for(seed, 0), mix["views"])
    c2ws = np.stack([c2w(e, a, mix["dist"], mix["up"]) for e, a in poses])
    light = torch.tensor(gt["light"], dtype=torch.float64, device=device)
    light = light / torch.linalg.norm(light)
    albedo = torch.tensor(gt["albedo"], dtype=torch.float64, device=device)
    pos = tile_positions(0.0, 0.0, size, device)
    images, masks = [], []
    for m in c2ws:
        rays = camera_rays(torch.from_numpy(m[None]).to(device), focal(mix), pos, size)
        rays = rays[0, :, :, 0].to(torch.float64)
        r_o, r_d = rays[..., :3], rays[..., 3:]
        b = torch.sum(r_o * r_d, -1)
        disc = b * b - (torch.sum(r_o * r_o, -1) - gt["radius"] ** 2)
        hit = disc > 0
        t = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
        normal = (r_o + t[..., None] * r_d) / gt["radius"]
        shade = gt["ambient"] + (1.0 - gt["ambient"]) * torch.clamp(normal @ light, 0.0, 1.0)
        images.append((hit[..., None] * albedo * shade[..., None]).float().cpu().numpy())
        masks.append(hit.float().cpu().numpy())
    return c2ws, np.stack(images), np.stack(masks)
