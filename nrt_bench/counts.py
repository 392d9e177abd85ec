"""The yardstick's arithmetic: the card's published peaks, and the operations
the rays need, counted from a configuration's widths.

Operations are ``2 x`` the multiply-adds of the linear layers, as the port's
kernel table counts them.  An SDF evaluation, and what a march reads once,
are counted by the surface's kind (``reference/surfaces/<kind>.py``).  The
differentiable part of a training step counts three times its forward
operations (the forward, and a backward of twice that); recomputation is not
counted.
"""

from __future__ import annotations

from .reference.surfaces import surface_kind

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores and HBM3
# bandwidth, dense, at the full 700 W power limit
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def enc_size(net: dict) -> int:
    return net["in_size"] + 2 * net["freqs"]


def layer_macs(net: dict) -> list:
    """Multiply-adds per point of ``[init, layers 0..L-1, out]``."""
    enc, h, n = enc_size(net), net["hidden_size"], net["num_layers"]
    skip = net.get("skip", 3)
    hidden = [((h + enc) if (i % skip == 0 and i != n - 1) else h) * h for i in range(n)]
    return [enc * h] + hidden + [h * net["out"]]


def mlp_macs(net: dict) -> int:
    return sum(layer_macs(net))


def net_ops(net: dict) -> int:
    """Operations of one forward evaluation of a net at one point."""
    return 2 * mlp_macs(net)


def weight_bytes(net: dict) -> int:
    enc, h, n = enc_size(net), net["hidden_size"], net["num_layers"]
    return 4 * (net["in_size"] * net["freqs"] + mlp_macs(net) + h * (n + 1) + net["out"])


def sdf_ops(cfg: dict) -> int:
    """Operations of one SDF evaluation at one point."""
    return surface_kind(cfg["surface"]).eval_ops(cfg["surface"])


def shading_ops(cfg: dict) -> int:
    """Operations of a hit's shading: the weight net, every lobe and, for a
    learned light field, its net."""
    b = cfg["bsdf"]
    ops = net_ops(b["weight_net"]) + b["lobes"] * net_ops(b["lobe"])
    if cfg["light"]["kind"] == "light_field":
        ops += net_ops(cfg["light"]["net"])
    return ops


def bound_s(ops: float, n_bytes: float = 0.0) -> float:
    """The least seconds the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory bandwidth."""
    return max(ops / PEAK_F32, n_bytes / PEAK_BYTES)


def march_bytes(cfg: dict, rays: int, outputs: int = 2) -> int:
    """Bytes a march moves at least: each ray's origin and direction in, its
    ``outputs`` words out, and what the surface's kind reads once."""
    return 4 * rays * (6 + outputs) + surface_kind(cfg["surface"]).eval_bytes(cfg["surface"])


def train_step_ops(cfg: dict, rays: int, hits: int, march_evals: int, scan_evals: int) -> float:
    """Operations training steps need: the march (``march_evals`` SDF
    evaluations, no gradient), the silhouette scan (``scan_evals`` samples),
    and three times the differentiable forward: at every ray the SDF, its
    normal (an input gradient, as many operations again) and the SDF at the
    scan's minimum; at every hit the shading nets."""
    f = sdf_ops(cfg)
    forward = rays * 3 * f + hits * shading_ops(cfg)
    return march_evals * f + scan_evals * f + 3 * forward


def view_ops(cfg: dict, hits: int, march_evals: int, shadow_evals: int = 0,
             blocked: int = 0) -> float:
    """Operations a rendered view needs: the march, at every hit the SDF and
    its normal and the shading, the shadow march and, at every blocked
    shadow ray under learned occlusion, the occlusion net."""
    f = sdf_ops(cfg)
    ops = (march_evals + shadow_evals) * f + hits * (2 * f + shading_ops(cfg))
    if blocked and "occlusion_net" in cfg:
        ops += blocked * net_ops(cfg["occlusion_net"])
    return ops


def share(ops: float, seconds: float, n_bytes: float = 0.0):
    """``100 x`` the least time over the measured time, or None where
    nothing was measured."""
    if not ops or not seconds:
        return None
    return 100.0 * bound_s(ops, n_bytes) / seconds
