"""K2 fused sphere trace, K3 fused silhouette min-scan and K4 fused shadow
march through a SphereSDF, CUDA kernels for Hopper, with their plain
versions.

K2 replaces the TPU kernel ``neural_raytracing_tpu/kernels/fused_march.py``
(``fused_march``, body ``_build_march_kernel`` with ``_make_sdf_eval``), the
plain march (omega = 1) and the over-relaxed one (1 < omega < 2).  The
kernel (``csrc/fused_march.cu``) keeps persistent blocks (``march_plan``
launches one a SM), each with 128 ray slots (64 when hidden > 128): a step
evaluates the SDF of every live slot through the tiled SDF that K3 uses,
and a slot whose ray is done takes the next ray from a queue; once the
queue is dry the live slots move to the front and a step evaluates only
the first 128, 64 or 32 rows.
A ray's state (depth, previous SDF, last step, its omega, its evaluation
count) lives in global memory, so a ray's result depends on nothing but its
own evaluations.  ``march_plain`` below is its plain version (``SDF._march``'s
loops); ``march_slots_plain`` is a plain model of the kernel's schedule, for
tests.

K3 replaces ``fused_min_scan`` (body ``_build_minscan_kernel``): the index of
the earliest strict minimum of the SDF over the ``steps + 1`` samples
``t = step * i`` of each ray.  The kernel (``csrc/fused_minscan.cu``) shares
its SDF (``csrc/mlp_tiled.cuh`` over ``csrc/sphere_set.cuh``) with K2, a
register-tiled shift net: four samples of 32 rays (128 rows) share one
evaluation, each thread an 8 x 8 tile of a layer's output on the CUDA
cores, the weights streamed once per block and layer through shared memory
in the layout of ``kernels/fused_mlp.py`` ``tile_layout``, packed once per
net and weight version by the pack kernel K1 uses (``tile_pack``).
Every ray takes all samples; it is bound by the f32 FMA rate.  To fill
the card's last wave of blocks, each ray's samples may be split into
segments run by separate blocks and merged by a second kernel
(``min_scan_plan`` picks the count from the ray count, the steps and the
block shape and occupancy the library reports).  ``min_scan_plain`` is its
plain version (the ``lax.scan`` of ``SDF.throughput``).  K3-bf16 runs the same scan with the shift net's
products on the tensor cores (``mma.sync`` m16n8k16, bf16 activations in
shared memory).

K4 replaces ``fused_shadow_march`` (body ``_build_shadow_kernel``): the loop
of ``SDF.intersect_test``, which differs from K2's in four places (depth
starts at ``1e2 * eps``, the hit test is a strict ``sd < eps``, the hit
step's distance is still applied, and the past-light exit gates a ray on
``depth < max_t``).  The kernel (``csrc/fused_shadow.cu``) runs on K2's
persistent slots (``csrc/march_slots.cuh``; ``shadow_plan``'s blocks and
slots) over the tiled SDF, with steps made for the thin tails of its small
launches (a 10,000-ray eval chunk, a 12,288-ray training call): the live
slots compact down to 8 rows (f32), a thin step puts each warp on its own
weight columns, the weights stream in larger chunks through three buffers
and all threads sum the sphere set.  A zero-direction ray (a masked light sample) never moves, so its one
evaluation decides it: it leaves with the plain loop's flag.  The ray's
depth and evaluation count live in global memory, so its flag depends on
nothing but its own evaluations.  ``shadow_march_plain`` is its plain
version; ``shadow_slots_plain`` models its schedule, for tests.

The three kernels take a ``SphereSDF`` or a ``FusedSphereSDF`` (the same
parameters) whose shift is a 3 -> 1 ``SkipConnMLP`` without a latent.
Nothing differentiates through either kernel: every input is detached and
the outputs carry no gradient, as in the reference.

K2-bf16, K3-bf16 and K4-bf16 (``compute_dtype=torch.bfloat16``, the JAX
``SDF(march_dtype=bfloat16)``, counted as ``fused_march_bf16``,
``fused_min_scan_bf16`` and ``fused_shadow_march_bf16``) are the same
kernels over the bf16 operands of the JAX ``_make_sdf_eval``: the shift
net's matmul operands rounded to bf16, its skip layers reading ``act`` of
the ROUNDED encoding (K1-bf16 takes ``act`` of the float32 one), the weight
matrices cast once per call (K2-bf16 and K3-bf16 on the tensor cores);
the sphere set, the smooth-min, ``x @ B``, sin/cos, the biases and the
loops stay float32.  Their plain versions are
the three loops above over ``sphere_sdf_eval_plain(module, p,
torch.bfloat16)``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..nn.mlp import SkipConnMLP, check_compute_dtype
from ._build import library
from .fused_mlp import (
    ACT_CODES, MAX_LAYERS, check_cuda_f32, mlp_forward_bf16_operands, tile_pointers,
    weight_pointers,
)
from .fused_sdf import sphere_min_plain, sphere_sdf_plain

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = library("fused_march")
    lib.nrt_fused_march.argtypes = [
        _P, _P, _P, _P, _F, _P, _P,               # rays, interval, outputs
        _P, _P, _P,                               # ray states, queue, statistics
        _I, _I, _I, _F, _F,                       # rays, blocks, loop
        _I,                                       # bf16 operands
        _P, _P, _P, _I, _F, _I,                   # sphere set
        _I, _I, _I, _I, _I, _I, _I, _P,           # shift MLP (packed weights)
        _P]                                       # stream
    lib.nrt_fused_march.restype = _I
    lib.nrt_fused_march_info.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
    lib.nrt_fused_march_info.restype = _I
    return lib


def _minscan_lib() -> ctypes.CDLL:
    lib = library("fused_minscan")
    lib.nrt_fused_min_scan.argtypes = [
        _P, _P, _P, _P, _P, _P,                   # rays, step, output, segment states
        _I, _I, _I,                               # segments, n, steps
        _I,                                       # bf16 operands
        _P, _P, _P, _I, _F, _I,                   # sphere set
        _I, _I, _I, _I, _I, _I, _I, _P,           # shift MLP (packed weights)
        _P]                                       # stream
    lib.nrt_fused_min_scan.restype = _I
    lib.nrt_fused_min_scan_blocks_per_sm.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
    lib.nrt_fused_min_scan_blocks_per_sm.restype = _I
    return lib


def _shadow_lib() -> ctypes.CDLL:
    lib = library("fused_shadow")
    lib.nrt_fused_shadow_march.argtypes = [
        _P, _P, _P, _P,                           # rays, max_t, output
        _P, _P, _P,                               # ray states, queue, statistics
        _I, _I, _I, _I, _F, _F, _I,               # rays, blocks, slots, loop
        _I,                                       # bf16 operands
        _P, _P, _P, _I, _F, _I,                   # sphere set
        _I, _I, _I, _I, _I, _I, _I, _P,           # shift MLP (packed weights)
        _P]                                       # stream
    lib.nrt_fused_shadow_march.restype = _I
    lib.nrt_fused_shadow_march_info.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
    lib.nrt_fused_shadow_march_info.restype = _I
    return lib


def supports(module) -> bool:
    """True if ``module`` is a SphereSDF or FusedSphereSDF whose shift net
    the kernels run (a registered activation: a custom callable's shift
    net marches by the plain loop)."""
    from ..shapes.sdf import SphereSDF
    from .fused_sdf import FusedSphereSDF
    if not isinstance(module, (SphereSDF, FusedSphereSDF)):
        return False
    mlp = module.shift
    return (isinstance(mlp, SkipConnMLP) and mlp.latent_size == 0
            and mlp.in_size == 3 and mlp.out_size == 1 and mlp.activation_name is not None)


def _spheres(module, device):
    """Check the SphereSDF's sphere tensors on ``device`` -> (the C arguments
    of the sphere set, the tensors they point into)."""
    tfs = (module.tfs.detach() + torch.eye(3, device=module.tfs.device)).contiguous()
    centers = module.centers.detach().contiguous()
    radii = module.radii.detach().contiguous()
    n_sph = tfs.shape[0]
    check_cuda_f32("tfs", tfs, (n_sph, 3, 3), device)
    check_cuda_f32("centers", centers, (n_sph, 3), device)
    check_cuda_f32("radii", radii, (n_sph,), device)
    args = (tfs.data_ptr(), centers.data_ptr(), radii.data_ptr(), n_sph,
            float(module.k), int(module.stable_min))
    return args, (tfs, centers, radii)


def _net_args(mlp, ptrs):
    return (mlp.in_size, mlp.freqs, mlp.hidden_size, mlp.num_layers, mlp.skip,
            mlp.out_size, ACT_CODES[mlp.activation_name], ptrs)


def _sphere_set(module, device):
    """Check the SphereSDF's tensors on ``device`` -> (the C arguments of the
    sphere set and the float32 shift net of ``csrc/mlp.cuh``, the tensors
    they point into)."""
    args, tensors = _spheres(module, device)
    mlp = module.shift
    weights = [w.detach() for w in mlp.flat_weights()]
    ptrs = weight_pointers(mlp, mlp.B.detach(), weights, device)
    return args + _net_args(mlp, ptrs), tensors + (weights,)


def _rays(r_o: torch.Tensor, r_d: torch.Tensor):
    ro = r_o.detach().reshape(-1, 3).contiguous()
    rd = r_d.detach().reshape(-1, 3).contiguous()
    n = ro.shape[0]
    check_cuda_f32("r_o", ro, (n, 3))
    check_cuda_f32("r_d", rd, (n, 3), ro.device)
    return ro, rd, n


def check_omega(omega: float) -> None:
    if not 1.0 <= omega < 2.0:
        raise ValueError(f"omega must lie in [1, 2), got {omega}")


def sphere_sdf_eval_plain(module, p: torch.Tensor,
                          compute_dtype=torch.float32) -> torch.Tensor:
    """The SphereSDF as K2-K4 evaluate it with ``compute_dtype`` operands
    (the JAX ``_make_sdf_eval``): ``p [..., 3] -> [...]``, no gradient.  The
    smooth-min of the spheres in float32, plus the shift net, whose matmul
    operands are rounded to bf16 for bf16, with ``act`` of the rounded
    encoding on the skip layers.  The plain version of the bf16 kernels, as
    the ``sdf`` of ``march_plain``, ``min_scan_plain`` and
    ``shadow_march_plain``."""
    mlp = module.shift
    with torch.no_grad():
        if check_compute_dtype(compute_dtype) == torch.float32:
            return sphere_sdf_plain(module, p, module.centers, module.radii,
                                    module.tfs, mlp.B, mlp.flat_weights())
        shift = mlp_forward_bf16_operands(mlp, p, mlp.B, mlp.flat_weights(),
                                          act_of_rounded_enc=True)
        return (sphere_min_plain(module, p, module.centers, module.radii, module.tfs)
                + shift[..., 0])


@torch.no_grad()
def march_plain(sdf, r_o: torch.Tensor, r_d: torch.Tensor, max_t,
                t_start=None, *, max_steps: int, epsilon: float,
                omega: float = 1.0):
    """Plain sphere trace, the plain version of K2.

    ``sdf(p[..., 3]) -> [...]``.  ``max_t`` is a scalar or per-ray;
    ``t_start`` (per-ray, optional) starts the march there (bounded mode).
    With ``omega > 1`` each step is ``omega * sd`` until it fails (the new
    and the previous bounding spheres no longer overlap, or the point lies
    deeper than ``epsilon`` inside); a failed step is taken back and the ray
    marches plainly from there, and it cannot hit on the step that failed
    (the JAX ``SDF._march``'s relaxed loop).  With ``omega = 1`` nothing
    fails and ``omega * sd == sd``: the plain loop.
    Returns ``(depths, hit, evals)``: ``evals`` counts, per ray, the steps on
    which the ray still needed an SDF evaluation.
    """
    check_omega(omega)
    batch = r_o.shape[:-1]
    device = r_o.device
    if t_start is None:
        depths = torch.zeros(batch, device=device)
    else:
        depths = torch.as_tensor(t_start, dtype=torch.float32,
                                 device=device).expand(batch).clone()
    max_t = torch.as_tensor(max_t, dtype=torch.float32, device=device).expand(batch)
    remaining = torch.ones(batch, dtype=torch.bool, device=device)
    hit = torch.zeros(batch, dtype=torch.bool, device=device)
    evals = torch.zeros(batch, dtype=torch.int32, device=device)
    prev_sd = torch.zeros(batch, device=device)
    step_len = torch.zeros(batch, device=device)
    om = torch.full(batch, omega, dtype=torch.float32, device=device)
    for _ in range(max_steps):
        remaining = remaining & (depths < max_t)
        evals += remaining
        sd = sdf(r_o + r_d * depths[..., None])
        fail = remaining & (om > 1.0) & (
            (torch.abs(sd) + torch.abs(prev_sd) <= step_len) | (sd < -epsilon))
        hits = remaining & ~fail & (sd <= epsilon)
        new_step = torch.where(fail, (1.0 - om) * step_len, om * sd)
        om = torch.where(fail, 1.0, om)
        hit = hit | hits
        remaining = remaining & ~hits
        depths = torch.where(remaining, depths + new_step, depths)
        step_len = torch.where(remaining, new_step, step_len)
        prev_sd = torch.where(remaining, sd, prev_sd)
    return depths, hit, evals


@torch.no_grad()
def march_slots_plain(sdf, r_o: torch.Tensor, r_d: torch.Tensor, max_t,
                      t_start=None, *, slots: int, max_steps: int, epsilon: float,
                      omega: float = 1.0):
    """A plain model of K2's schedule in one block of ``slots`` slots, for
    tests; not on any path.

    The kernel's control flow (``csrc/fused_march.cu``): a free slot takes
    rays from a queue in order until one needs an evaluation (a ray with no
    steps or ``t_start >= max_t`` resolves at once); each step evaluates
    ``sdf`` on the points of the live slots only, and each of them takes
    ``march_plain``'s step with its own relaxation state and evaluation
    count, both starting afresh when the ray enters its slot; a ray that
    hits, leaves its interval or has had ``max_steps`` evaluations frees its
    slot.  Once the queue is dry the live slots move to the front and the
    step covers the first ``slots``, ``slots / 2``, ... rows that hold them
    (down to 32).  Returns ``(depths, hit, evals, schedule)``: the first
    three as ``march_plain``'s, ``schedule`` the (live slots, rows) of each
    step.
    """
    check_omega(omega)
    batch = r_o.shape[:-1]
    o, d = r_o.reshape(-1, 3), r_d.reshape(-1, 3)
    n, device = o.shape[0], r_o.device
    t0 = torch.zeros(n, device=device) if t_start is None else torch.as_tensor(
        t_start, dtype=torch.float32, device=device).expand(batch).reshape(-1)
    mt = torch.as_tensor(max_t, dtype=torch.float32, device=device).expand(batch).reshape(-1)
    depths, hit = t0.clone(), torch.zeros(n, dtype=torch.bool, device=device)
    evals = torch.zeros(n, dtype=torch.int32, device=device)
    prev, slen = torch.zeros(n, device=device), torch.zeros(n, device=device)
    om = torch.full((n,), omega, dtype=torch.float32, device=device)
    slot, queue, schedule = [-1] * slots, 0, []
    while True:
        for s in range(slots):                       # refill
            while slot[s] < 0 and queue < n:
                g, queue = queue, queue + 1
                if max_steps > 0 and bool(t0[g] < mt[g]):
                    prev[g], slen[g], om[g], evals[g] = 0.0, 0.0, omega, 0
                    slot[s] = g
        live = [g for g in slot if g >= 0]
        if not live:
            break
        rows = slots
        while rows // 2 >= 32 and len(live) <= rows // 2:
            rows //= 2
        if rows < slots:                             # compact
            slot = live + [-1] * (slots - len(live))
        schedule.append((len(live), rows))
        g = torch.tensor(live, device=device)
        sd = sdf(o[g] + d[g] * depths[g][:, None])
        evals[g] += 1
        fail = (om[g] > 1.0) & ((torch.abs(sd) + torch.abs(prev[g]) <= slen[g])
                                | (sd < -epsilon))
        hits = ~fail & (sd <= epsilon)
        step = torch.where(fail, (1.0 - om[g]) * slen[g], om[g] * sd)
        go = ~hits
        hit[g[hits]] = True
        gg = g[go]
        depths[gg] = depths[gg] + step[go]
        slen[gg], prev[gg] = step[go], sd[go]
        om[gg] = torch.where(fail[go], 1.0, om[gg])
        done = hits.clone()
        done[go] = (evals[gg] >= max_steps) | ~(depths[gg] < mt[gg])
        finished = set(g[done].tolist())
        slot = [-1 if s in finished else s for s in slot]
    return depths.reshape(batch), hit.reshape(batch), evals.reshape(batch), schedule


def fused_march(module, r_o: torch.Tensor, r_d: torch.Tensor, max_t, *,
                max_steps: int, epsilon: float, omega: float = 1.0,
                t_start=None, compute_dtype=torch.float32, stats=None):
    """Launch K2 on CUDA tensors.  Returns ``(depths [...], hit [...])``.

    ``max_t`` is a scalar (unbounded) or, with ``t_start``, a per-ray end of
    the ``[t_start, max_t]`` interval (bounded); ``omega`` in [1, 2) is the
    over-relaxation of ``march_plain``; ``compute_dtype=torch.bfloat16``
    launches K2-bf16 (counted as ``fused_march_bf16``).  The shift net's
    weights are packed once per weight version (``tile_pack``).  ``stats``, an
    int64 CUDA tensor ``[3]``, gets the launch's tile steps, rows evaluated
    and live rows added to it.  Launches on the current stream and does not
    synchronise.
    """
    check_omega(omega)
    bf16 = check_compute_dtype(compute_dtype) == torch.bfloat16
    if not supports(module):
        raise ValueError("fused_march supports SphereSDF surfaces with a "
                         "3 -> 1 shift net and no latent")
    check_min_scan_widths(module, "fused_march")
    batches = r_o.shape[:-1]
    device = r_o.device
    ro, rd, n = _rays(r_o, r_d)
    if t_start is None:
        if isinstance(max_t, torch.Tensor) and max_t.numel() != 1:
            raise ValueError("unbounded fused_march takes a scalar max_t")
        t0 = mt = None
        scalar_max_t = float(max_t)
    else:
        t0 = torch.as_tensor(t_start, dtype=torch.float32, device=device
                             ).detach().expand(batches).reshape(-1).contiguous()
        mt = torch.as_tensor(max_t, dtype=torch.float32, device=device
                             ).detach().expand(batches).reshape(-1).contiguous()
        check_cuda_f32("t_start", t0, (n,), device)
        check_cuda_f32("max_t", mt, (n,), device)
        scalar_max_t = 0.0

    if stats is not None:
        check_cuda_f32("stats", stats, (3,), device, torch.int64)
    # the tensors stay alive until the launch
    spheres, _tensors = _spheres(module, device)
    mlp = module.shift
    ptrs = tile_pointers(mlp, mlp.B, mlp.flat_weights(), device, compute_dtype)
    depths = torch.empty(n, device=device, dtype=torch.float32)
    hit = torch.empty(n, device=device, dtype=torch.bool)
    state = torch.empty(n, 4, device=device, dtype=torch.float32)
    queue = torch.empty(1, device=device, dtype=torch.int32)
    blocks = march_plan(n, device)
    with torch.cuda.device(device):
        rc = _lib().nrt_fused_march(
            ro.data_ptr(), rd.data_ptr(),
            None if t0 is None else t0.data_ptr(),
            None if mt is None else mt.data_ptr(), scalar_max_t,
            depths.data_ptr(), hit.data_ptr(), state.data_ptr(), queue.data_ptr(),
            None if stats is None else stats.data_ptr(), n, blocks, max_steps, epsilon,
            float(omega), int(bf16), *spheres, *_net_args(mlp, ptrs),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_march: CUDA error {rc} at launch")
    if n > 0:
        (fused_march_bf16 if bf16 else fused_march).launches += 1
    return depths.reshape(batches), hit.reshape(batches)


def fused_march_bf16(module, r_o: torch.Tensor, r_d: torch.Tensor, max_t, **kw):
    """Launch K2-bf16: ``fused_march`` with bf16 operands."""
    return fused_march(module, r_o, r_d, max_t, compute_dtype=torch.bfloat16, **kw)


fused_march.launches = 0
fused_march_bf16.launches = 0


@torch.no_grad()
def min_scan_plain(sdf, r_o: torch.Tensor, r_d: torch.Tensor, step, *,
                   steps: int) -> torch.Tensor:
    """Plain silhouette min-scan, the plain version of K3.

    ``sdf(p[..., 3]) -> [...]``; ``step`` is the float32 sample spacing (a
    number or a 0-d tensor).  Returns, per ray, the index of the earliest
    strict minimum of the SDF over ``t = step * i``, ``i = 0..steps``, as
    float32.
    """
    step = torch.as_tensor(step, dtype=torch.float32, device=r_o.device).reshape(())
    mn = sdf(r_o)
    idx = torch.zeros(mn.shape, dtype=torch.int32, device=r_o.device)
    for i in range(1, steps + 1):
        sd = sdf(r_o + (step * float(i)) * r_d)
        idx = torch.where(sd < mn, i, idx)
        mn = torch.minimum(mn, sd)
    return idx.to(torch.float32)


# K2's and K3's widths: the limits of csrc/mlp_tiled.cuh, csrc/fused_march.cu
# and csrc/fused_minscan.cu
MIN_SCAN_LIMITS = {"hidden_size": 256, "freqs": 128, "num_layers": MAX_LAYERS,
                   "spheres": 1024}


def check_min_scan_widths(module, kernel: str = "fused_min_scan") -> None:
    """Raise ValueError, naming the limit, if K3 (or K2, which shares its
    tile: ``kernel``) cannot take ``module``'s shift net or sphere set
    (checked before anything about devices)."""
    mlp = module.shift
    sizes = {"hidden_size": mlp.hidden_size, "freqs": mlp.freqs,
             "num_layers": mlp.num_layers, "spheres": module.centers.shape[0]}
    for name, limit in MIN_SCAN_LIMITS.items():
        if sizes[name] > limit:
            raise ValueError(f"{kernel} takes at most {name} = {limit}, "
                             f"got {sizes[name]}")


# samples of one ray per evaluation (NRT_TILE_U of csrc/mlp_tiled.cuh)
MIN_SCAN_SAMPLES = 4
# the most segments K3 splits a ray's samples into
MIN_SCAN_MAX_SEGMENTS = 8


@functools.lru_cache(maxsize=None)
def _launch_shape(bf16: bool, freqs: int, hidden: int, n_spheres: int,
                  device: int) -> tuple[int, int]:
    """(rays a block, blocks an SM) of K3 for this net on ``device``, as the
    library launches it."""
    rays = _I(0)
    with torch.cuda.device(device):
        blocks = _minscan_lib().nrt_fused_min_scan_blocks_per_sm(
            int(bf16), freqs, hidden, n_spheres, ctypes.byref(rays))
    if blocks <= 0:
        raise RuntimeError(f"nrt_fused_min_scan_blocks_per_sm: CUDA error {-blocks}")
    return rays.value, blocks


def _module_launch_shape(module, compute_dtype, device: int) -> tuple[int, int]:
    check_min_scan_widths(module)
    bf16 = check_compute_dtype(compute_dtype) == torch.bfloat16
    mlp = module.shift
    return _launch_shape(bf16, mlp.freqs, mlp.hidden_size, module.centers.shape[0], device)


def min_scan_blocks_per_sm(module, compute_dtype=torch.float32) -> int:
    """Blocks of K3 (K3-bf16) for ``module`` that fit on one SM of the
    current device (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    return _module_launch_shape(module, compute_dtype, torch.cuda.current_device())[1]


def min_scan_plan(module, n: int, steps: int, compute_dtype, device: torch.device) -> int:
    """The segments K3 (K3-bf16) splits each ray's samples into for ``n``
    rays of ``steps + 1`` samples on the CUDA ``device``: its block shape
    and occupancy from the library, through ``min_scan_segments``."""
    if n <= 0 or steps < 0:
        return 1
    rays, blocks = _module_launch_shape(module, compute_dtype, device.index)
    slots = blocks * torch.cuda.get_device_properties(device).multi_processor_count
    return min_scan_segments(-(-n // rays), steps // MIN_SCAN_SAMPLES + 1, slots)


def min_scan_segments(blocks: int, groups: int, slots: int) -> int:
    """Into how many segments K3 splits each ray's ``groups`` sample groups
    (``MIN_SCAN_SAMPLES`` samples each), given its ``blocks`` ray blocks and
    the ``slots`` blocks the card holds at once: the count, up to
    ``MIN_SCAN_MAX_SEGMENTS`` and with at least two groups a segment, that
    minimises the waves of blocks times the groups of the longest segment
    (plus a quarter group for a block's fixed work and the merge)."""
    best, best_cost = 1, float("inf")
    for seg in range(1, MIN_SCAN_MAX_SEGMENTS + 1):
        if seg > 1 and groups < 2 * seg:
            break
        cost = -(-blocks * seg // slots) * (-(-groups // seg) + 0.25)
        if cost < best_cost:
            best, best_cost = seg, cost
    return best


@functools.lru_cache(maxsize=None)
def _march_info(bf16: bool, freqs: int, hidden: int, n_spheres: int, device: int) -> dict:
    info = (_I * 5)()
    with torch.cuda.device(device):
        rc = _lib().nrt_fused_march_info(int(bf16), freqs, hidden, n_spheres, info)
    if rc != 0 or info[0] <= 0:
        raise RuntimeError(f"nrt_fused_march_info: CUDA error {rc}, {info[0]} blocks per SM")
    return dict(blocks_per_sm=info[0], slots=info[1], registers=info[2],
                local_bytes=info[3], smem_bytes=info[4])


def march_info(module, compute_dtype=torch.float32, device=None) -> dict:
    """K2's (K2-bf16's) kernel for ``module`` on the CUDA ``device`` (the
    current one by default), as the library reports it: ``blocks_per_sm``
    (its occupancy), ``slots`` (the rays a block marches at once),
    ``registers`` a thread, ``local_bytes`` (local memory a thread: stack
    frame and spills; ptxas's log tells them apart) and
    ``smem_bytes`` (dynamic shared memory a block)."""
    check_min_scan_widths(module, "fused_march")
    bf16 = check_compute_dtype(compute_dtype) == torch.bfloat16
    index = torch.cuda.current_device() if device is None else torch.device(device).index
    mlp = module.shift
    return _march_info(bf16, mlp.freqs, mlp.hidden_size, module.centers.shape[0], index)


def march_plan(n: int, device: torch.device) -> int:
    """The persistent blocks K2 and K4 (and their bf16 variants) launch for
    ``n`` rays on the CUDA ``device``: one a SM, at most one a ray.  K2 fits
    twice on an SM (``march_info``), but one block a SM marches faster: a
    step's cost has a large fixed part, so the tail is shorter in fewer,
    fuller blocks; K4's wider weight stream fits once (``shadow_info``)."""
    if n <= 0:
        return 0
    return min(n, torch.cuda.get_device_properties(device).multi_processor_count)


def shadow_plan(n: int, device: torch.device, slots: int) -> tuple:
    """``(blocks, slots)`` of K4 (K4-bf16) for ``n`` rays on the CUDA
    ``device``, whose kernel holds ``slots`` rays a block (``shadow_info``):
    ``march_plan``'s blocks, and the slots a block fills: at most 64 where
    one fill of the kernel's slots would hold every ray (a NeRV eval chunk or
    training call: the queue never refills, and a block's first steps then
    evaluate 64 rows, not 128), else all of them."""
    blocks = march_plan(n, device)
    return blocks, (min(64, slots) if n <= slots * blocks else slots)


def fused_min_scan(module, r_o: torch.Tensor, r_d: torch.Tensor, step, *,
                   steps: int, compute_dtype=torch.float32) -> torch.Tensor:
    """Launch K3 on CUDA tensors.  Returns the argmin index ``[...]`` as f32.

    ``step`` is the float32 sample spacing, a number or a 0-d tensor (on the
    card it is read there, so a jittered step costs no synchronisation).
    ``compute_dtype=torch.bfloat16`` launches K3-bf16 (counted as
    ``fused_min_scan_bf16``).  The shift net's weights are packed once per
    weight version (``tile_pack``).  Launches on the current stream and does
    not synchronise.
    """
    bf16 = check_compute_dtype(compute_dtype) == torch.bfloat16
    if not supports(module):
        raise ValueError("fused_min_scan supports SphereSDF surfaces with a "
                         "3 -> 1 shift net and no latent")
    check_min_scan_widths(module)
    batches = r_o.shape[:-1]
    device = r_o.device
    ro, rd, n = _rays(r_o, r_d)
    step_t = torch.as_tensor(step, dtype=torch.float32, device=device
                             ).detach().reshape(1).contiguous()
    check_cuda_f32("step", step_t, (1,), device)
    # the tensors stay alive until the launch
    spheres, _tensors = _spheres(module, device)
    mlp = module.shift
    ptrs = tile_pointers(mlp, mlp.B, mlp.flat_weights(), device, compute_dtype)
    idx = torch.empty(n, device=device, dtype=torch.float32)
    segments = min_scan_plan(module, n, steps, compute_dtype, device)
    part_m = torch.empty(segments * n if segments > 1 else 0, device=device)
    part_i = torch.empty_like(part_m, dtype=torch.int32)
    with torch.cuda.device(device):
        rc = _minscan_lib().nrt_fused_min_scan(
            ro.data_ptr(), rd.data_ptr(), step_t.data_ptr(), idx.data_ptr(),
            part_m.data_ptr() if segments > 1 else None,
            part_i.data_ptr() if segments > 1 else None,
            segments, n, steps, int(bf16), *spheres, *_net_args(mlp, ptrs),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_min_scan: CUDA error {rc} at launch")
    if n > 0:
        (fused_min_scan_bf16 if bf16 else fused_min_scan).launches += 1
    return idx.reshape(batches)


def fused_min_scan_bf16(module, r_o: torch.Tensor, r_d: torch.Tensor, step, **kw):
    """Launch K3-bf16: ``fused_min_scan`` with bf16 operands."""
    return fused_min_scan(module, r_o, r_d, step, compute_dtype=torch.bfloat16, **kw)


fused_min_scan.launches = 0
fused_min_scan_bf16.launches = 0


@torch.no_grad()
def shadow_march_plain(sdf, r_o: torch.Tensor, r_d: torch.Tensor, max_t, *,
                       max_steps: int, epsilon: float,
                       past_light_exit: bool = True):
    """Plain shadow march, the plain version of K4 (``SDF.intersect_test``).

    ``sdf(p[..., 3]) -> [...]``; ``max_t`` is a scalar or per-ray.  Returns
    ``(not_blocked [...], evals [...])``: ``evals`` counts, per ray, the
    steps on which the ray was live and needed an SDF evaluation.
    """
    batch = r_o.shape[:-1]
    device = r_o.device
    max_t = torch.as_tensor(max_t, dtype=torch.float32, device=device).expand(batch)
    depths = torch.full(batch, 1e2 * epsilon, dtype=torch.float32, device=device)
    remaining = torch.ones(batch, dtype=torch.bool, device=device)
    evals = torch.zeros(batch, dtype=torch.int32, device=device)
    for _ in range(max_steps):
        live = remaining & (depths < max_t) if past_light_exit else remaining
        evals += live
        dists = sdf(r_o + r_d * depths[..., None])
        hits = live & (dists < epsilon)
        depths = torch.where(live, depths + dists, depths)
        remaining = remaining & ~hits
    return (depths >= max_t) | remaining, evals


@torch.no_grad()
def shadow_slots_plain(sdf, r_o: torch.Tensor, r_d: torch.Tensor, max_t, *,
                       slots: int, max_steps: int, epsilon: float,
                       past_light_exit: bool = True, min_rows: int = 8):
    """A plain model of K4's schedule in one block of ``slots`` slots, for
    tests; not on any path.

    The kernel's control flow (``csrc/fused_shadow.cu`` on the slots of
    ``csrc/march_slots.cuh``): a free slot takes rays from a queue in order
    until one needs an evaluation (a ray with no steps, or with the exit one
    whose ``1e2 * epsilon`` start is not below ``max_t``, resolves at once,
    not blocked); each step evaluates ``sdf`` on the points of the live
    slots only, and each of them takes ``shadow_march_plain``'s step with its
    own evaluation count; a ray leaves its slot when it hits (not blocked if
    its advanced depth reaches ``max_t``), with the exit when its depth
    reaches ``max_t``, after ``max_steps`` evaluations, or after its first
    evaluation if its direction is zero (its point never moves, so no later
    step can hit); the last three are not blocked.  Once the queue is dry
    the live slots move to the front and the step covers the first
    ``slots``, ``slots / 2``, ... rows that hold them, down to ``min_rows``
    (8 in K4, 32 in K4-bf16).
    Returns ``(not_blocked, evals, schedule)``: ``not_blocked`` as
    ``shadow_march_plain``'s, ``evals`` the evaluations the kernel makes
    (one for a zero-direction ray), ``schedule`` the (live slots, rows) of
    each step.
    """
    batch = r_o.shape[:-1]
    o, d = r_o.reshape(-1, 3), r_d.reshape(-1, 3)
    n, device = o.shape[0], r_o.device
    mt = torch.as_tensor(max_t, dtype=torch.float32, device=device).expand(batch).reshape(-1)
    depth0 = torch.tensor(1e2 * epsilon, dtype=torch.float32)
    depths = torch.full((n,), float(depth0), device=device)
    evals = torch.zeros(n, dtype=torch.int32, device=device)
    not_blocked = torch.ones(n, dtype=torch.bool, device=device)
    still = d.abs().sum(dim=-1) == 0
    slot, queue, schedule = [-1] * slots, 0, []
    while True:
        for s in range(slots):                       # refill
            while slot[s] < 0 and queue < n:
                g, queue = queue, queue + 1
                if max_steps > 0 and (not past_light_exit or bool(depth0 < mt[g])):
                    slot[s] = g
        live = [g for g in slot if g >= 0]
        if not live:
            break
        rows = slots
        while rows // 2 >= min_rows and len(live) <= rows // 2:
            rows //= 2
        if rows < slots:                             # compact
            slot = live + [-1] * (slots - len(live))
        schedule.append((len(live), rows))
        g = torch.tensor(live, device=device)
        sd = sdf(o[g] + d[g] * depths[g][:, None])
        evals[g] += 1
        depths[g] = depths[g] + sd
        hits = sd < epsilon
        not_blocked[g[hits]] = depths[g[hits]] >= mt[g[hits]]
        done = hits | (evals[g] >= max_steps) | still[g]
        if past_light_exit:
            done |= ~(depths[g] < mt[g])
        finished = set(g[done].tolist())
        slot = [-1 if s in finished else s for s in slot]
    return not_blocked.reshape(batch), evals.reshape(batch), schedule


@functools.lru_cache(maxsize=None)
def _shadow_info(bf16: bool, freqs: int, hidden: int, n_spheres: int, device: int) -> dict:
    info = (_I * 5)()
    with torch.cuda.device(device):
        rc = _shadow_lib().nrt_fused_shadow_march_info(int(bf16), freqs, hidden, n_spheres,
                                                       info)
    if rc != 0 or info[0] <= 0:
        raise RuntimeError(f"nrt_fused_shadow_march_info: CUDA error {rc}, "
                           f"{info[0]} blocks per SM")
    return dict(blocks_per_sm=info[0], slots=info[1], registers=info[2],
                local_bytes=info[3], smem_bytes=info[4])


def shadow_info(module, compute_dtype=torch.float32, device=None) -> dict:
    """K4's (K4-bf16's) kernel for ``module`` on the CUDA ``device``, as the
    library reports it, with the keys of ``march_info``."""
    check_min_scan_widths(module, "fused_shadow_march")
    bf16 = check_compute_dtype(compute_dtype) == torch.bfloat16
    index = torch.cuda.current_device() if device is None else torch.device(device).index
    mlp = module.shift
    return _shadow_info(bf16, mlp.freqs, mlp.hidden_size, module.centers.shape[0], index)


def fused_shadow_march(module, r_o: torch.Tensor, r_d: torch.Tensor, max_t, *,
                       max_steps: int, epsilon: float,
                       past_light_exit: bool = True,
                       compute_dtype=torch.float32, stats=None) -> torch.Tensor:
    """Launch K4 on CUDA tensors.  Returns ``not_blocked [...]`` (bool).

    ``max_t`` is a scalar or per-ray; ``compute_dtype=torch.bfloat16``
    launches K4-bf16 (counted as ``fused_shadow_march_bf16``).  The shift
    net's weights are packed once per weight version (``tile_pack``);
    ``shadow_plan`` gives the blocks and their slots.  ``stats``, an int64
    CUDA tensor
    ``[3]``, gets the launch's tile steps, rows evaluated and live rows added
    to it.  Launches on the current stream and does not synchronise.
    """
    bf16 = check_compute_dtype(compute_dtype) == torch.bfloat16
    if not supports(module):
        raise ValueError("fused_shadow_march supports SphereSDF surfaces with a "
                         "3 -> 1 shift net and no latent")
    check_min_scan_widths(module, "fused_shadow_march")
    batches = r_o.shape[:-1]
    device = r_o.device
    ro, rd, n = _rays(r_o, r_d)
    mt = torch.as_tensor(max_t, dtype=torch.float32, device=device
                         ).detach().expand(batches).reshape(-1).contiguous()
    check_cuda_f32("max_t", mt, (n,), device)
    if stats is not None:
        check_cuda_f32("stats", stats, (3,), device, torch.int64)
    # the tensors stay alive until the launch
    spheres, _tensors = _spheres(module, device)
    mlp = module.shift
    ptrs = tile_pointers(mlp, mlp.B, mlp.flat_weights(), device, compute_dtype)
    not_blocked = torch.empty(n, device=device, dtype=torch.bool)
    state = torch.empty(n, 2, device=device, dtype=torch.float32)
    queue = torch.empty(1, device=device, dtype=torch.int32)
    blocks, slots = shadow_plan(n, device, shadow_info(module, compute_dtype, device)["slots"])
    with torch.cuda.device(device):
        rc = _shadow_lib().nrt_fused_shadow_march(
            ro.data_ptr(), rd.data_ptr(), mt.data_ptr(), not_blocked.data_ptr(),
            state.data_ptr(), queue.data_ptr(),
            None if stats is None else stats.data_ptr(), n, blocks, slots, max_steps, epsilon,
            1e2 * epsilon, int(past_light_exit), int(bf16), *spheres,
            *_net_args(mlp, ptrs), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_shadow_march: CUDA error {rc} at launch")
    if n > 0:
        (fused_shadow_march_bf16 if bf16 else fused_shadow_march).launches += 1
    return not_blocked.reshape(batches)


def fused_shadow_march_bf16(module, r_o: torch.Tensor, r_d: torch.Tensor, max_t, **kw):
    """Launch K4-bf16: ``fused_shadow_march`` with bf16 operands."""
    return fused_shadow_march(module, r_o, r_d, max_t, compute_dtype=torch.bfloat16,
                              **kw)


fused_shadow_march.launches = 0
fused_shadow_march_bf16.launches = 0
