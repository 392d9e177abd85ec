"""Triangle-mesh shape: Moller-Trumbore over face chunks, or the native host ops.

Counterpart of ``neural_raytracing_tpu/shapes/mesh.py``: ``load_obj``,
``_moller_trumbore`` and ``TriangleMesh`` (closest hit with barycentric uv,
the geometric normal flipped to face the ray origin, the 1e-5 normal
offset; ``intersect_test`` any-hit before ``max_t``).  The default backend
(``"torch"``, the JAX package's ``"jax"``) computes on the rays' device: a
Python loop over chunks of ``chunk`` faces, where the JAX package scans
them, tracking the running minimum.  ``backend="native"`` sends the rays to
the host's C++/OpenMP ops (``..native``) and the results back to the rays'
device.

The mesh has no learnable parameter: its vertices and faces are buffers
outside the state dict (non-persistent), as the JAX ``init`` returns
``{}``, and ``.to(device)`` moves them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..interaction import Interaction
from ..ops.math import cross, normalize

EPS = 1e-8


def load_obj(path: str):
    """Minimal OBJ loader -> (verts [V, 3] float32, faces [F, 3] int32).

    Handles ``v`` / ``f`` records with polygon fan triangulation and the
    ``v/vt/vn`` index syntax (1-based and negative indices).
    """
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def _moller_trumbore(r_o, r_d, v0, v1, v2):
    """Batched ray x face-chunk intersection.

    r_o / r_d ``[..., 3]``; v0 / v1 / v2 ``[F, 3]``.  -> (t ``[..., F]``,
    inf where missed; the barycentrics u, v).
    """
    e1 = v1 - v0                                   # [F, 3]
    e2 = v2 - v0
    pv = cross(r_d[..., None, :], e2)
    det = torch.sum(e1 * pv, dim=-1)               # [..., F]
    small = torch.abs(det) < EPS
    inv_det = torch.where(small, 0.0, 1.0 / det)
    tv = r_o[..., None, :] - v0
    u = torch.sum(tv * pv, dim=-1) * inv_det
    qv = cross(tv, e1)
    v = torch.sum(r_d[..., None, :] * qv, dim=-1) * inv_det
    t = torch.sum(e2 * qv, dim=-1) * inv_det
    valid = ~small & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > EPS)
    return torch.where(valid, t, torch.inf), u, v


class TriangleMesh(nn.Module):
    """A static triangle mesh (no learnable geometry).

    ``intersect(rays, ...) -> (Interaction, hit)`` and ``intersect_test(rays,
    max_t, active) -> not blocked`` take the arguments the integrators and
    ``scene.sample_emitter`` hand any shape (``primary``, ``generator``,
    ``active``) and ignore them, as the JAX mesh ignores its key.
    """

    def __init__(self, verts, faces, chunk: int = 256, backend: str = "torch"):
        super().__init__()
        if backend not in ("torch", "native"):
            raise ValueError(f"unknown backend {backend!r} (torch or native)")
        self.chunk = int(chunk)
        self.backend = backend
        verts = torch.as_tensor(np.asarray(verts, np.float32))
        faces = torch.as_tensor(np.asarray(faces, np.int32))
        self.n_faces = faces.shape[0]
        # pad faces to a whole number of chunks with degenerate (all-0) triangles
        pad = (-faces.shape[0]) % self.chunk
        if pad:
            faces = torch.cat([faces, torch.zeros(pad, 3, dtype=torch.int32)])
        self.register_buffer("verts", verts, persistent=False)
        self.register_buffer("faces", faces, persistent=False)
        self.register_buffer("tris", verts[faces.long()], persistent=False)   # [F, 3, 3]

    @classmethod
    def from_obj(cls, path: str, **kwargs) -> "TriangleMesh":
        verts, faces = load_obj(path)
        return cls(verts, faces, **kwargs)

    def reset_parameters(self, generator: torch.Generator = None):
        pass

    def _scan_min(self, r_o, r_d, max_t):
        """-> (min t, face index or -1, uv) over the face chunks; ties take
        the first face, as ``jnp.argmin`` does."""
        batch = r_o.shape[:-1]
        best_t = torch.full(batch, float(max_t), dtype=torch.float32, device=r_o.device)
        best_i = torch.full(batch, -1, dtype=torch.int64, device=r_o.device)
        best_uv = torch.zeros(batch + (2,), dtype=torch.float32, device=r_o.device)
        for i0 in range(0, self.tris.shape[0], self.chunk):
            tri = self.tris[i0:i0 + self.chunk]
            t, u, v = _moller_trumbore(r_o, r_d, tri[:, 0], tri[:, 1], tri[:, 2])
            tc, ic = torch.min(t, dim=-1)
            uc = torch.gather(u, -1, ic[..., None])[..., 0]
            vc = torch.gather(v, -1, ic[..., None])[..., 0]
            better = tc < best_t
            best_uv = torch.where(better[..., None], torch.stack([uc, vc], dim=-1), best_uv)
            best_i = torch.where(better, ic + i0, best_i)
            best_t = torch.where(better, tc, best_t)
        return best_t, best_i, best_uv

    def _host(self, rays):
        return rays.detach().reshape(-1, 6).to("cpu", torch.float32)

    def intersect(self, rays: torch.Tensor, primary: bool = True, generator=None,
                  active=None, max_t: float = 1e10):
        """-> (Interaction, hit [...]) of the closest face before ``max_t``."""
        r_o, r_d = rays[..., :3], rays[..., 3:]
        batch = r_o.shape[:-1]
        if self.backend == "native":
            from .. import native
            t, _, _, n, hit = native.mesh_intersect(self._host(rays), self.verts.cpu(),
                                                    self.faces.cpu(), max_t)
            t, hit = t.reshape(batch).to(rays.device), hit.reshape(batch).to(rays.device)
            n = n.reshape(batch + (3,)).to(rays.device)
            t_safe = torch.where(hit, t, 0.0)
        else:
            best_t, best_i, _ = self._scan_min(r_o, r_d, max_t)
            hit = best_i >= 0
            t_safe = torch.where(hit, best_t, 0.0)
            tri = self.tris[torch.clamp_min(best_i, 0)]
            n = normalize(cross(tri[..., 1, :] - tri[..., 0, :], tri[..., 2, :] - tri[..., 0, :]))
            # the geometric normal faces the ray origin
            n = torch.where(torch.sum(n * r_d, dim=-1, keepdim=True) > 0, -n, n)
            t = best_t
        n = torch.where(hit[..., None], n, 0.0)
        p = r_o + t_safe[..., None] * r_d + n * 1e-5
        it = Interaction(p=p, t=t_safe).with_normals(n)
        return it._replace(wi=it.to_local(-r_d)), hit

    def intersect_test(self, rays: torch.Tensor, max_t=1e10, active=None):
        """True where no face blocks the ray before ``max_t`` (a number or a
        tensor of the rays' batch shape)."""
        r_o, r_d = rays[..., :3], rays[..., 3:]
        batch = r_o.shape[:-1]
        max_t_b = torch.as_tensor(max_t, dtype=torch.float32, device=rays.device).expand(batch)
        if self.backend == "native":
            from .. import native
            nb = native.mesh_intersect_test(self._host(rays), self.verts.cpu(),
                                            self.faces.cpu(), max_t_b.reshape(-1).cpu())
            return nb.reshape(batch).to(rays.device)
        best_t, best_i, _ = self._scan_min(r_o, r_d, 1e10)
        return ~((best_i >= 0) & (best_t < max_t_b))
