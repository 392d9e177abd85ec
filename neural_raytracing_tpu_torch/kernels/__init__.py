"""Hand-written CUDA kernels of the port and their plain versions.

Each kernel wrapper counts its launches in a plain integer attribute
(``fused_mlp_forward.launches``, ``fused_march.launches``, ...) so a run can
show which kernels its path went through.
"""

import contextlib

from torch import nn

from .composite import (
    composite_apply, composite_plain, fused_composite,
)
from .fused_march import (
    MIN_SCAN_LIMITS, fused_march, fused_march_bf16,
    fused_min_scan, fused_min_scan_bf16, fused_shadow_march,
    fused_shadow_march_bf16, march_info, march_plain, march_plan,
    march_slots_plain, min_scan_blocks_per_sm,
    min_scan_plain, min_scan_plan, min_scan_segments, shadow_info,
    shadow_march_plain, shadow_plan, shadow_slots_plain,
    sphere_sdf_eval_plain, supports,
)
from .fused_mlp import (
    TILE_LIMITS, FusedSkipConnMLP, ckpt_forward_plain, dw_plan, f32_column_order,
    fused_mlp_apply, fused_mlp_backward,
    fused_mlp_ckpt_forward, fused_mlp_forward, fused_mlp_forward_bf16,
    fused_mlp_segment_backward, k1_route, mlp_backward, mlp_backward_plain,
    mlp_forward_bf16_operands, pack_tile_transposes, pack_tile_weights,
    segment_backward_plain, segment_bounds, segmented_backward, tile_backward_plain,
    tile_bwd_info, tile_bwd_widths, tile_dw_plain, tile_forward_plain, tile_info,
    tile_layout, tile_pack, tile_pack_key, tile_pack_plain, tile_pointers,
    tile_transpose_layout, tile_transposes, tile_transposes_plain, tile_widths,
)
from .fused_sdf import (
    FusedSphereSDF, fused_sphere_sdf, fused_sphere_sdf_apply, k5_route, k5_tile_info,
    k5_tile_spheres, sphere_sdf_plain,
)

KERNELS = {
    "fused_mlp_forward": fused_mlp_forward,
    "fused_march": fused_march,
    "fused_min_scan": fused_min_scan,
    "fused_mlp_backward": fused_mlp_backward,
    "fused_mlp_ckpt_forward": fused_mlp_ckpt_forward,
    "fused_mlp_segment_backward": fused_mlp_segment_backward,
    "fused_shadow_march": fused_shadow_march,
    "fused_sphere_sdf": fused_sphere_sdf,
    "fused_composite": fused_composite,
    # the bf16-operand variants of K1-K4
    "fused_mlp_forward_bf16": fused_mlp_forward_bf16,
    "fused_march_bf16": fused_march_bf16,
    "fused_min_scan_bf16": fused_min_scan_bf16,
    "fused_shadow_march_bf16": fused_shadow_march_bf16,
    # K1's tile reads its weights packed by this kernel, once per net and version
    "pack_tile_weights": pack_tile_weights,
    # ... and K6/K7's tile their transposes, packed by this one
    "pack_tile_transposes": pack_tile_transposes,
}
# the kernels with two routes (the tile and the general one), counted by route
ROUTED = ("fused_mlp_forward", "fused_mlp_forward_bf16", "fused_mlp_backward",
          "fused_mlp_ckpt_forward", "fused_mlp_segment_backward", "fused_sphere_sdf")


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0
    for name in ROUTED:
        KERNELS[name].route_launches = dict.fromkeys(KERNELS[name].route_launches, 0)


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def route_counts() -> dict:
    """The launches by route of K1, K1-bf16, K6, K7a, K7b and K5:
    ``{"fused_mlp_forward": {"tile": n, "general": n}, ...}``."""
    return {name: dict(KERNELS[name].route_launches) for name in ROUTED}


def _launch_table() -> dict:
    """Every launch count: by kernel, and by (kernel, route)."""
    table = {name: fn.launches for name, fn in KERNELS.items()}
    table.update({(name, route): n for name in ROUTED
                  for route, n in KERNELS[name].route_launches.items()})
    return table


@contextlib.contextmanager
def launches_apart():
    """Take the launches counted in the block out of ``launch_counts`` and
    ``route_counts`` into a dict of their own (the value yielded), for
    ``add_launches``: a CUDA graph's capture counts launches it records and
    does not make, and each replay makes them."""
    before = _launch_table()
    taken = {}
    try:
        yield taken
    finally:
        after = _launch_table()
        taken.update({k: after[k] - n for k, n in before.items() if after[k] != n})
        add_launches({k: -n for k, n in taken.items()})


def add_launches(counts: dict) -> None:
    """Add a ``launches_apart`` dict to the launch counts."""
    for key, n in counts.items():
        if isinstance(key, tuple):
            KERNELS[key[0]].route_launches[key[1]] += n
        else:
            KERNELS[key].launches += n


def set_kernel_mode(module: nn.Module, mode: str):
    """Set every fused MLP's and FusedSphereSDF's ``mode``, every SDF's
    ``fused_loops`` and every NeRF-family shape's compositing ``fused`` in
    ``module`` to ``mode`` ("auto", "force" or "off")."""
    from ..shapes.nerf import NeRFLE, PartialNeRF, PlainNeRF
    from ..shapes.sdf import SDF
    if mode not in ("auto", "force", "off"):
        raise ValueError(f"mode must be 'auto', 'force' or 'off', got {mode!r}")
    for m in module.modules():
        if isinstance(m, (FusedSkipConnMLP, FusedSphereSDF)):
            m.mode = mode
        elif isinstance(m, SDF):
            m.fused_loops = mode
            if isinstance(m.module, FusedSphereSDF):   # not a registered child
                m.module.mode = mode
        elif isinstance(m, (PlainNeRF, PartialNeRF, NeRFLE)):
            m.fused = mode
