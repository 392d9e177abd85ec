"""The weights both sides run: made on the device from the seed, or read from
a checkpoint in the repository, by the benchmark itself.

``shapes(cfg)`` lists every leaf of a configuration by its dotted name (the
published params tree's paths: ``shape.shift.layers.0.w``,
``bsdf.bsdfs.3.mlp.out.b``, ``lights.color``, ...); the surface's kind
(``reference/surfaces/<kind>.py``) lists the ``shape.*`` leaves.  From a
seed, the leaves are drawn in two calls on one ``torch.Generator`` of the
device (the uniforms of every leaf, then the normals of the Fourier bases),
and each takes the first rule of ``cfg["weights"]["init"]`` whose pattern
matches its name:

- ``["zeros"]``;
- ``["uniform", lo, hi]``;
- ``["fan_in"]``: ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``, a bias by its
  layer's ``fan_in``;
- ``["xavier"]``: ``U(-a, a)``, ``a = sqrt(6 / (fan_in + fan_out))``;
- ``["normal", sigma]``: ``sigma * N(0, 1)``.
"""

from __future__ import annotations

import fnmatch
import hashlib
import math
from pathlib import Path

import torch

from .reference.surfaces import surface_kind

ROOT = Path(__file__).resolve().parent.parent


def net_shapes(prefix: str, net: dict) -> dict:
    enc, h, n = net["in_size"] + 2 * net["freqs"], net["hidden_size"], net["num_layers"]
    skip = net.get("skip", 3)
    out = {prefix + "B": (net["in_size"], net["freqs"]),
           prefix + "init.w": (enc, h), prefix + "init.b": (h,)}
    for i in range(n):
        fan_in = h + enc if (i % skip == 0 and i != n - 1) else h
        out[f"{prefix}layers.{i}.w"] = (fan_in, h)
        out[f"{prefix}layers.{i}.b"] = (h,)
    out[prefix + "out.w"] = (h, net["out"])
    out[prefix + "out.b"] = (net["out"],)
    return out


def shapes(cfg: dict) -> dict:
    out = surface_kind(cfg["surface"]).shapes(cfg["surface"])
    b = cfg["bsdf"]
    for i in range(b["lobes"]):
        out.update(net_shapes(f"bsdf.bsdfs.{i}.mlp.", b["lobe"]))
    out.update(net_shapes("bsdf.sp_var_fn.", b["weight_net"]))
    light = cfg["light"]
    if light["kind"] == "light_field":
        out.update(net_shapes("lights.mlp.", light["net"]))
        out["lights.color"] = (3,)
    else:
        out.update({"lights.intensity": (1, 3), "lights.location": tuple(light["location_shape"]),
                    "lights.const": (), "lights.linear": (), "lights.square": (),
                    "lights.scale": ()})
    if "occlusion_net" in cfg:
        out.update(net_shapes("occ.", cfg["occlusion_net"]))
    return out


def _rule(cfg: dict, name: str) -> list:
    for pattern, *rule in cfg["weights"]["init"]:
        if fnmatch.fnmatchcase(name, pattern):
            return rule
    raise ValueError(f"no init rule matches {name}")


def from_seed(cfg: dict, seed: int, device) -> dict:
    """``{name: float32 tensor on device}`` drawn from ``seed``."""
    leaves = shapes(cfg)
    names = sorted(leaves)
    sizes = [math.prod(leaves[k]) for k in names]
    g = torch.Generator(device=device).manual_seed(seed & (2 ** 63 - 1))
    uniform = torch.rand(sum(sizes), generator=g, device=device).split(sizes)
    bases = [k for k in names if _rule(cfg, k)[0] == "normal"]
    normal = torch.randn(sum(math.prod(leaves[k]) for k in bases), generator=g,
                         device=device).split([math.prod(leaves[k]) for k in bases])
    normal = dict(zip(bases, normal))
    out = {}
    for name, u in zip(names, uniform):
        shape = leaves[name]
        kind, *args = _rule(cfg, name)
        if kind == "zeros":
            w = torch.zeros(shape, device=device)
        elif kind == "uniform":
            w = args[0] + (args[1] - args[0]) * u.reshape(shape)
        elif kind in ("fan_in", "xavier"):
            w_shape = leaves[name[:-1] + "w"]
            if kind == "fan_in":
                bound = 1.0 / math.sqrt(w_shape[0])
            else:
                bound = math.sqrt(6.0 / (w_shape[0] + w_shape[1]))
            w = (2.0 * u.reshape(shape) - 1.0) * bound
        elif kind == "normal":
            w = args[0] * normal[name].reshape(shape)
        else:
            raise ValueError(f"unknown init rule {kind!r} for {name}")
        out[name] = w.contiguous()
    return out


def from_checkpoint(cfg: dict, device) -> dict:
    """The checkpoint ``cfg["weights"]["dir"]`` (one ``<component>.msgpack``
    a component), checked against its recorded sha256 digests."""
    from .reference.flax_msgpack import load_tree
    spec = cfg["weights"]
    directory = ROOT / spec["dir"]
    out = {}
    for comp, digest in sorted(spec["sha256"].items()):
        path = directory / f"{comp}.msgpack"
        got = hashlib.sha256(path.read_bytes()).hexdigest()
        if got != digest:
            raise RuntimeError(f"{path} has sha256 {got}, the configuration states {digest}")
        for k, v in load_tree(path).items():
            out[f"{comp}.{k}"] = torch.as_tensor(v, dtype=torch.float32).to(device)
    want = shapes(cfg)
    got_shapes = {k: tuple(v.shape) for k, v in out.items()}
    if got_shapes != want:
        raise RuntimeError(f"the checkpoint's leaves differ from the configuration's: "
                           f"{sorted(set(got_shapes.items()) ^ set(want.items()))[:6]}")
    return out


def make(cfg: dict, seed: int, device) -> dict:
    return from_seed(cfg, seed, device) if cfg["weights"]["from"] == "seed" \
        else from_checkpoint(cfg, device)
