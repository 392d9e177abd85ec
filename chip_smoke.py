"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each of which fails loudly (a non-zero exit and no result line):
  1. the card's name and power limit; build the CUDA kernels from
     neural_raytracing_tpu_torch/csrc (nvcc, sm_90a) and print the build time;
  2. K1 fused_mlp_forward against its plain version on each of the four
     flagship nets at full width, 65,536 seeded points each, on the tile
     (csrc/fused_mlp_tile.cu): its float32 outputs the same bits as the
     parent's kernel (the general route, csrc/fused_mlp.cu) with their
     digests; in turns beside the parent's kernel its ms, the plain ms, the
     bound, TFLOP/s and the share of the bound, the kernel as the library
     reports it (rows a block, registers, local and shared memory, blocks a
     SM); the same at the rows the main paths launch it at (K1_PATH_ROWS);
     one eval tile's 11 launches; then the pack kernel (pack_tile_weights)
     against its plain version bit for bit;
  3. K2 fused_march against its plain version on a 256x256 NeRFCamera view
     (65,536 rays) through the full 128-sphere set with a non-zero 8x128
     shift: bounded (256 steps, march_bound 1.2) and unbounded (64 steps),
     with the library's occupancy, registers and local memory, the live
     share of the rows its steps evaluated, evaluations/ms, and its depths
     and hits the same bit for bit in a second launch and under a random
     permutation of the rays;
 3b. K2 and K2-bf16 at the shapes the main paths launch them at (one
     flagship eval tile of 16,384 rays, bounded, 256 steps; a validation
     tile, unbounded, 64 steps; the 38,400 rays of a training step, 64
     steps; the NeRV checkpoint's 65,536 orbit rays at omega 1.4, 128 steps;
     phase 3's bounded view): the SDF evaluations per ray (mean, median,
     99th percentile, most), K2 against march_plain as phase 3 holds it,
     both kernels' ms, evaluations/ms and live share, each also with two
     blocks a SM; then the ms of one step by the rows a block evaluates (128,
     64, 32; a block a SM; two), on rays that converge on the surface and
     never finish (unending_rays);
  4. the eval slice: the flagship eval scene of scripts/nerf_synthetic.py
     (max_steps 256, march_bound 1.2) renders 3 views at 256x256 through
     pathtrace with the kernels, launch counts reset just before and read
     just after, then again with every kernel switched off; one validation
     view (64 steps, unbounded) the same way;
  5. K3 fused_min_scan against min_scan_plain on the 38,400 rays of 6 views
     x an 80^2 crop at unit distance (128 steps of 2.2/128), surface of 3,
     and timed on the half-res grid (9,600 rays): TFLOP/s, share of the
     bound, blocks per SM, the indices that differ, the time before the
     redesign beside, a
     leaky_relu twin (the epilogue's cost) and each shape with one sample
     segment a ray (the split's gain, in the same call);
  6. K6 fused_mlp_backward (segments 0) and K7 fused_mlp_ckpt_forward +
     fused_mlp_segment_backward (segments 4) on the tile
     (csrc/fused_mlp_bwd_tile.cu) against the autograd recompute backward
     on the weight net, one lobe and the light field, 38,400 rows, dx/dW/db
     the same bits in a second run; in turns with the parent's kernels (the
     general route, csrc/fused_mlp_bwd.cu) and the plain versions; each
     tile kernel's device ms and launches (store forward, chain, dW, its
     reduction) and each product's share of its bound; the transposed
     pack (pack_tile_transposes) against its plain version bit for bit;
  7. the training slice: the flagship training scene (max_steps 64,
     throughput_steps 128, dist 2.2, AdamW 8e-5 / 8e-4 / 8e-5, 6 views x
     80^2 crops, mask weight 15, SSIM, eikonal) on ground truth made here (8
     views of an analytic diffuse sphere): one step with the kernels against
     one with every kernel off from the same state; 20 iterations of train
     through the kernels (launch counts reset just before, read just after);
     3 iterations each with K6, K7 and everything plain; a profile of one
     step; the step with each backward route of the shading nets (the
     autograd recompute, K6, K7) timed in turns, then one profile each
     (device busy ms, launches), every net on the tile route; evaluate on 2
     views;
  8. K4 fused_shadow_march against shadow_march_plain at the shapes the NeRV
     paths launch it at (shadow_shapes), on the shadow rays of the trained
     NeRV scene (scripts/models_seed_dir/nerv_mesh_gear_mirror200b) from the
     march end points (the hit points where a ray hit) of the camera rays
     towards the light, as the render casts them: (a) the four 100^2 eval
     chunks of one 200x200 view at distance 2, light 0 (10,000 rays a launch,
     128 steps, past-light exit), (b) 3 views x 64^2 crops, one light each
     (12,288 rays, 64 steps), (c) the whole view in one launch (the table's
     shape), (d) (c) without the exit; at each: the SDF evaluations per ray
     (mean, median, 99th percentile, most), blocked fraction (in (0, 1)
     over each shape's launches, so the comparisons are not empty), not-blocked
     agreement, the same flags bit for bit in a second launch and under a
     permutation, zero-direction rays (the directions of the rays whose
     camera ray missed, and of every 97th, set to zero) equal to the plain
     loop's, ms a launch, plain ms, bound ms, evaluations/ms, tile steps and
     the live share of the rows, and the schedule model's ms (slot_model);
     the kernel as the library reports it, and one step's ms by the rows a
     block evaluates (128, 64, 32, 16, 8; bf16 128, 64, 32);
  9. K5 fused_sphere_sdf on the tile (csrc/fused_sdf.cu, K1's f32 tile)
     against SphereSDF.forward on 65,536 seeded points with the trained
     shape weights, and one backward and one double backward through its
     autograd.Function against the plain version; then on phase 3's
     non-zero surface at a NeRV eval chunk's 10,000 points (the path's) and
     65,536: the tile and the general route (the parent's kernel) against
     the plain version, their digests (the same bits), both timed in turns
     (ms a call, 20 calls back to back) beside the tile kernel's device
     time, the plain ms, the bound and its share, the tile's occupancy;
 10. the NeRV eval: workloads.nerv.build_scene(max_steps=128,
     march_bound=1.2) loaded from the checkpoint renders 3 views at 200x200
     through evaluate with light_update (the checkpoint's 3 lights), with
     learned and with hard shadows, each with the kernels (launch counts
     reset just before, read just after) and with every kernel off; a
     profile of one view; one view again with fused_sdf=True (K5, on the
     tile: k1_routes) and its profile;
 11. NeRV training: build_scene(max_steps=64, occlusion="learned") from the
     checkpoint, AdamW 4e-5 for every group, on ground truth made here (8
     views of an analytic sphere, each lit by its own point light):
     calibrate_exposure; one step with the kernels against one with every
     kernel off from the same state; 20 iterations of train with
     rand_uv_mask, tone mapping and light_update (counts reset just before,
     read just after); evaluate in both shadow modes on 2 views;
 12. K8 fused_composite against composite_plain at the ragged shapes
     (COMPOSITE_RAGGED) and no rays, then at the NeRFLE eval-tile shape
     [64, 10,000] and the training shape [64, 1,024] (sigma relu(normal), rgb
     sigmoid(normal), ts linspace(0, 2, 64), seeded), the same bits in a
     second launch, and one backward through its autograd.Function against
     autograd through the plain version; kernel and plain version timed in
     turns by the profiler's device time on inputs that a call finds out of
     the L2 cache (CUDA events beside it; the entry's timed_by says which
     timed its ms and plain_ms);
 13. the NeRFLE eval: workloads.nerfle.build_scene() at full width, weights
     from seed 0, FoV cameras on the 8x8 colocated grid at distance 1, each
     view lit at 1.05 x its camera centre: 2 views at 200x200 through the
     twin's evaluate (chunk 100) with K8 (counts reset just before, read just
     after), the same with fused="off" (no K8 launch), one view with
     envmap=True, a profile of one view;
 14. NeRFLE training on ground truth made here (an analytic diffuse sphere
     under the colocated light, the 8x8 grid at 200x200): one MSE step of
     the twin with K8 against one with it off from the same state, then 20
     iterations of the twin's loop (4 views x 16^2 crops, AdamW 5e-4; counts
     reset just before, read just after), a profile of one step;
 15. K2 relaxed (omega 1.4) against the relaxed march_plain on the trained
     NeRV checkpoint: the primary rays of 4 workloads.render orbit frames at
     128x128 (--dist 1.0 --elev 20), 128 steps, unbounded and bounded
     (march_bound 1.2), with the evaluations per ray at omega 1.0 and 1.4
     and K2's time at both; then workloads.render.main for 4 frames with
     --omega 1.4 (counts reset just before, read just after) and 1.0;
 16. the bf16-operand variants, each against its plain version and beside
     its f32 kernel on the same inputs: K1-bf16 on the weight net, one lobe
     and the light field (65,536 seeded points and the path's rows, as
     phase 2 reports K1, beside the parent's kernel; its bound the larger
     of the tensor-core bound and the elementwise floor); K2-bf16 on phase 3's rays
     and non-zero surface, bounded (256 steps), unbounded (64) and omega 1.4;
     K3-bf16 at phase 5's shapes, as phase 5 reports K3, its bound the
     larger of the tensor-core bound and the elementwise floor (the SFU and
     f32 work of its softplus epilogue, encoding and spheres); K4-bf16 at
     phase 8's shapes as phase 8 holds K4, and a probe on phase 3's surface that
     reads K4's SDF at float32 resolution (the checkpoint's shift net is a
     constant, so its bf16 and f32 marches agree bit for bit); K2-bf16's and
     K4-bf16's bounds are the larger of the tensor-core bound and the
     elementwise floor, as K3-bf16's;
 17. the mixed-precision flagship (bf16 weight net, lobes and light field,
     march_dtype bf16, the shift net f32): 3 eval views and one training
     step against everything plain in the same precision (plain_kernels), 12
     steps of train (counts reset just before, read just after: the bf16
     variants launched, the f32 K2/K3/K4 not), beside the f32
     configuration's images and loss, and its ms/view and ms/step timed in
     turns with the bf16 ones (bf16, f32, f32, bf16); a profile of one bf16
     step (phases 7 and 17 print the step times before K3's redesign
     beside theirs);
 18. the NeRV eval of phase 10 with march_dtype bf16, learned and hard
     shadows: ms/view, PSNR against the f32 render, hit and not-blocked
     agreement on one view;
 19. the colocate workload (workloads.colocate) on data made here by the
     generator twin (workloads.make_dataset): (a) the bunny's 8x8 colocated
     grid and one camera row of the relight grid at 200x200, in memory,
     with no launch of K1-K5 (the procedural SDF takes the plain loops),
     a pixel probe (mask coverage, the median of the lit pixels; fails on
     black data) and the black render's PSNR; (b) one training step of
     build_scene() at full width with seed-0 weights (4 views x 64^2 crops,
     the colocated light, extra_loss) against the same step with every
     kernel off, as phases 7 and 11 hold theirs; (c) 20 steps of train
     (counts reset just before, read just after: K1 on the tile, K2, K3,
     K4), ms/step, a profile of one step and K1-K4's device ms a launch;
     (d) the hard-shadow test on 2 views through evaluate with the light
     update, kernels against every kernel off (phase 4's tolerances),
     ms/view, a profile of one view; (e) the relight grid's 4 brightest
     views of that row, their PSNR beside the black render's (a pipeline
     check after 20 steps, not a quality figure);
 20. the DTU workload (workloads.dtu) on data made here by the generator
     twin (workloads.make_dtu_dataset): (a) 16 views at 200x200, in
     memory, with no launch of K1-K5, the seconds a view and a pixel probe,
     through the projection decomposition (dtu_dataset with the source size
     matched to the generator's); (b) one reduced step (3 views x 48^2 at
     the centre, mask weight 10) on the device data path, its draws pinned,
     against the same step inside plain_kernels(); (c) training at full
     width, 3 x 96^2 mask-centred crops (27,648 rays a step): 10 counted
     steps on each data path (K1 on the tile, K2, K3), then the host and
     the device data path in turns (data_path_turns); (d) a masked test
     view at 200x200, 128 steps bounded by 1.2, kernels against every
     kernel off; (e) workloads.render.main --workload dtu, one 128x128
     frame of the trained scene (counts reset just before, read just
     after);
 21. the NeRV generator twin (workloads.make_nerv_dataset: 12 train and 4
     test views at 64x64, no K1-K5 launch), then workloads.nerv.run on its
     data for 10 steps on the host data path and 10 on the device data
     path (per-view lights from the data; counts reset just before each,
     read just after: K1-K4), the second followed by one test view in both
     shadow modes; then the two paths in turns on the trained scene.
Phase 7 also runs the flagship step on the device data path (10 counted
steps) and the two paths in turns, then the workload's own entry,
workloads.nerf_synthetic.run, at full width on its GT (6 steps: the
half-res min-scan for 3, then full resolution; the device data path,
weight_reg and sat_guard, a validation render every 3 steps, one test
view; counts reset just before, read just after: K1-K3) and one 128x128
frame of workloads.render.main --workload nerf over the scene it
trained.  data_path_turns times host, device,
device, host (10 steps each, ms/step on the host's clock), then profiles 3
steps of each (device busy ms, idle share, launches a step; K1-K4's ms a
launch) and counts the calls that wait for the card (sync_sites), which
must be no more on the device path than on the host path.
Every counted run of a main path also holds K1's route counts (every fused
net takes the tile: k1_routes) and the pack's launches (none in an eval
view after the first, at most one a packed net and training step:
packed_nets), and
every profile prints K1's and the pack's device ms and launches.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.

Tolerances: K1 |kernel - plain| <= 1e-4 |plain| + 1e-5 + 4e-7 max|x.B| (the
float32 rounding of the Fourier argument x.B, amplified by the net), and
its float32 outputs equal to the parent kernel's bit for bit (the same
fmaf sums in the same order); the pack equal to its plain version bit for
bit; K2 hit
agreement >= 99% and |depth difference| <= 1e-3 where both hit (float32
sums in another order, accumulated over up to 256 steps), and K2's and
K2-bf16's depths equal bit for bit across launches and permutations (a
ray's result depends on its own evaluations only); the eval slice's
images finite, hit fraction > 0, mask agreement >= 99% and mean |difference|
<= 1e-3 between the kernel and plain renders; K3 index agreement >= 99.9%
and |sd difference| <= 1e-5 where the indices differ (near ties); K6/K7 dx
within 1e-4 of max |plain| on all but 0.1% of the rows, every dW/db within
1e-3 relative L2 (float32 sums in another order, atomics in a varying one;
a pre-activation within rounding of a leaky_relu kink takes the other slope
in one order and moves its row); the training step: loss within 1e-4 (relative), at most
0.1% of the rays with another hit flag, each component's gradient within
1e-2 relative L2 (the kernels sum in another order, and a flipped hit or a
near-tie argmin moves its ray's whole contribution); K4 not-blocked
agreement >= 99.9% (a step that lands within rounding of eps goes either
way), its flags the same bit for bit across launches and permutations, and
zero-direction rays exactly the plain loop's (one evaluation decides them);
K5 as K1, its derivatives within 1e-4 of max|plain| (the backward
recomputes through the plain version), and its two routes the same bits
(float32 digests: the same spheres' order and the tile's sums); the NeRV renders and step as the
flagship's, the occlusion net's gradient included; K8 2e-5 absolute + 2e-5
relative (as tests/test_kernels.py holds the TPU kernel; its segments'
products meet in another order than the cumprod), the same bits in a second
launch, its gradients 1e-4 absolute + 1e-3 relative; the NeRFLE render with K8 against fused="off" mean
|difference| <= 1e-5 and max <= 1e-4 (only the compositing differs); the
NeRFLE step loss within 1e-5 relative and each component's gradient within
1e-4 relative L2; the colocate step and test as the NeRV ones, the Diffuse
and Conductor leaves held apart (an occlusion net that no blocked shadow
ray reaches takes a zero gradient on both paths); K2 relaxed as K2 (hit agreement >= 99%, |depth
difference| <= 1e-3 where both hit); the bf16 variants: a float32
difference (x.B by fmaf against a matmul, sums in another order) can tip a
bf16 rounding, which moves that operand by one bf16 step and its row from
there on, so K1-bf16 holds half of its rows within K1's tolerance and its
mean |error| below a quarter of the mean |bf16 - f32| of the plain
versions; K2-bf16 hit agreement >= 99%, |depth difference| <= 1e-3 on 99%
of the common hits and <= 1e-2 on 99.9% (a depth sums its steps' SDF
noise, and a tipped rounding near the surface can change a step, or a
relaxed step's failure, on a grazing ray); K3-bf16 index agreement >= 99%
and ties within 1e-3 (twice the bf16 noise of the shift, one bf16 step of
its output scale); K4-bf16 as K4; each
bf16 kernel must differ from its f32 kernel on a non-zero net (K1 by at
least half that mean gap); the bf16 flagship against plain-in-bf16 as
phases 4 and 7.

    python3 chip_smoke.py --k1

runs phases 1 and 2 and phase 16's K1-bf16 part only (K1's and K1-bf16's
checks and times; no result line).

    python3 chip_smoke.py --bwd

runs phases 1 and 6 only (K6's and K7's checks and times; no result
line).

    python3 chip_smoke.py --colocate

runs phases 1 and 19 only (no result line).

    python3 chip_smoke.py --dtu

runs phases 1 and 20 only (no result line).

    python3 chip_smoke.py --data-paths [ROUNDS]

runs phases 1, 20 and 21 only, with ROUNDS rounds (default 5: 10 pairs,
each path first in half of them) of the two data paths' turns, the device
path's wins and the host path's quartile spread (no result line).

    python3 chip_smoke.py --converge-nerv [ITERS]
    python3 chip_smoke.py --converge-dtu [ITERS]

run phase 1, then a quality drive on generated data: the NeRV generator
(64x64, 12 + 4 views) and workloads.nerv.run on the device data path for
ITERS steps (default 4,000; 3 x 64^2, no SSIM: the ground truth is dark),
its test in both shadow modes; or the DTU generator (16 views at 64x64) and
workloads.dtu.run on the device data path (3 x 32^2 crops, mask weight 10),
its masked test on the held-out views 0 and 10 and the four brightest
training views.  Each prints the PSNR and SSIM beside the black render's
PSNR, the PSNR over the pixels the ground truth lights, pixel probes of
the renders and the ground truth, and the wall time (no result line).

    python3 chip_smoke.py --converge [ITERS]

runs phase 1, then the quality drive of .claude/skills/verify/SKILL.md
through the port: the generator twin (bunny, 64x64, the 4x4 grid and the
whole relight grid, light scale 1.5), then the colocate twin (crops of 32,
4 views, --clip-norm 10 --stable-init --light-scale 1.5) for ITERS steps
(default 8,000), its hard-shadow test on the first 8 views and the relight
grid, each PSNR beside the black render's, with pixel probes of the renders
and the ground truth, and the wall time (no result line).

    python3 chip_smoke.py --march-times [DIR]

prints only K2's and K2-bf16's ms at phase 3b's shapes, K4's and K4-bf16's
ms a launch at phase 8's and K3's and K3-bf16's at phase 5's, with a digest
of K2's depths and hits, of K3's indices and of K4's flags, for the package
in DIR (this checkout's by default):
unpack another commit with git archive into the ignored scratch_trees/ and
run the two trees in turns in one call.

    python3 chip_smoke.py --turn-times [DIR]

prints only K8's device ms (cold inputs) at COMPOSITE_SHAPES and K5's ms a
call at phase 9's points through their default routes, with digests of
their outputs, and the device busy ms (median of three profiles) of one
NeRFLE eval view, one flagship training step, one NeRV eval view with
fused_sdf=True and one colocate training step, and the colocate generator's
ms a view, for the package in DIR: the same way, parent, change, change,
parent.

Needs torch with CUDA and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and the
# float32 rate outside the tensor cores, at the full 700 W power limit
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12       # dense bf16 on the tensor cores
N_POINTS = 65_536
SIZE = 256
ARTIFACTS = ROOT / "scripts" / "models_seed_dir" / "nerv_mesh_gear_mirror200b"
CHUNK = 128
FOCAL = 0.5 * SIZE / math.tan(0.5 * 0.6911)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_ms(torch, fn, reps: int):
    """-> (device milliseconds per call of ``fn``, what timed it): the
    device time of all its kernels under the profiler over ``reps`` calls,
    after one warm-up call, "profiler".  For kernels shorter than their
    launch, where CUDA events around a call time the host's launch path.
    The profiler traces the host too, as ``profile_step`` does: a session
    of the device alone once came back empty.  A session that records no
    device time is tried twice more; after that the time is taken by CUDA
    events, the host's launch included, and said so: "cuda_events"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False))
        if total > 0:
            return 1e-3 * total / reps, "profiler"
    print("  device_ms: three profiler sessions saw no device time; timed by CUDA "
          "events, the host's launch included (timed_by: cuda_events)")
    return cuda_ms(fn, reps), "cuda_events"


def bound_ms(n_bytes: float, flops: float):
    """-> (least milliseconds on the card, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def layer_macs(mlp) -> list:
    """Multiply-adds per point of [init, hidden 0..L-1, out]."""
    return [w.shape[0] * w.shape[1] for w in mlp.flat_weights()[0::2]]


def mlp_macs(mlp) -> int:
    """Multiply-adds of the net's linear layers for one point."""
    return sum(layer_macs(mlp))


def weight_bytes(mlp) -> int:
    return 4 * (mlp.B.numel() + sum(w.numel() for w in mlp.flat_weights()))


def flagship_nets():
    from neural_raytracing_tpu_torch.kernels import FusedSkipConnMLP
    # the flagship configurations; the shift net gets a uniform (non-zero)
    # init here so the comparison exercises its weights
    return {
        "sdf_shift 8x128 F32": FusedSkipConnMLP(
            in_size=3, out=1, num_layers=8, hidden_size=128, freqs=32,
            activation="softplus", init="uniform"),
        "weight_net 16x256 F128": FusedSkipConnMLP(
            in_size=3, out=8, num_layers=16, hidden_size=256, freqs=128,
            sigma=128.0, init="xavier"),
        "lobe 6x96 F64": FusedSkipConnMLP(
            in_size=3, out=3, num_layers=6, hidden_size=96, freqs=64),
        "light_field 10x256 F16": FusedSkipConnMLP(
            in_size=3, out=3, num_layers=10, hidden_size=256),
    }


# the rows K1 launches a net at on the main paths: a flagship eval tile, a
# flagship training step's rays, a NeRV eval chunk, a NeRV training step's rays
K1_PATH_ROWS = {"eval tile": 16_384, "training step": 38_400, "NeRV eval chunk": 10_000,
                "NeRV training": 12_288}
# each flagship net's K1 launches on one eval tile (11 in all; the 8 lobes
# share a shape)
EVAL_TILE_LAUNCHES = {"sdf_shift 8x128 F32": 1, "weight_net 16x256 F128": 1,
                      "lobe 6x96 F64": 8, "light_field 10x256 F16": 1}


def digest(t) -> str:
    import hashlib
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def in_turns(fns: dict, reps: int = 5) -> dict:
    """Median ms of each function of ``fns`` timed in turns (a, b, b, a)."""
    names = list(fns)
    times = {k: [] for k in names}
    for order in (names, names[::-1]):
        for k in order:
            times[k].append(cuda_ms(fns[k], reps))
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def k1_elementwise_ms(mlp) -> float:
    """Milliseconds per row of K1-bf16's work beside the tensor cores,
    counted from the code: the encoding twice (a sin and a cos per frequency
    on the SFU, x.B by 3 fmaf each), each activation ((L + 1) x hidden
    outputs and act(enc); leaky_relu 3 f32 operations, softplus 4 and an exp
    and a log1p on the SFU) with its bias add and bf16 rounding (2), the
    output layer's out x hidden fmaf on the CUDA cores; the larger of the
    SFU's and the f32 pipe's time."""
    n_act = (mlp.num_layers + 1) * mlp.hidden_size + mlp.enc_size
    softplus = mlp.activation_name == "softplus"
    sfu = 4 * mlp.freqs + (2 * n_act if softplus else 0)
    f32 = (6 * mlp.freqs + n_act * ((4 if softplus else 3) + 2)
           + mlp.out_size * mlp.hidden_size)
    return 1e3 * max(sfu / PEAK_SFU, f32 / PEAK_F32_OPS)


def k1_bound(mlp, n: int, dtype) -> dict:
    """K1's (K1-bf16's) least time on ``n`` rows: bound_ms and bound_by
    ("bytes"/"operations"); f32_bound_ms, the f32-FMA bound; and for
    K1-bf16, whose bound is the larger of the two, tensor_core_bound_ms and
    elementwise_floor_ms."""
    import torch
    macs = float(mlp_macs(mlp)) * n
    n_bytes = 4 * n * (mlp.in_size + mlp.out_size) + weight_bytes(mlp)
    f32_ms, f32_by = bound_ms(n_bytes, 2.0 * macs)
    if dtype == torch.float32:
        return dict(bound_ms=f32_ms, bound_by=f32_by, f32_bound_ms=f32_ms)
    tc_ms, tc_by, _ = bf16_bounds(n_bytes, macs)
    floor = n * k1_elementwise_ms(mlp)
    return dict(bound_ms=max(tc_ms, floor), bound_by=tc_by if tc_ms >= floor else "operations",
                f32_bound_ms=f32_ms, tensor_core_bound_ms=tc_ms, elementwise_floor_ms=floor)


def k1_net_report(torch, name, mlp, dtype, x) -> dict:
    """K1 (K1-bf16 with ``dtype`` bf16) of one net on the seeded points
    ``x``: against its plain version (and the f32 kernel and plain version,
    for K1-bf16's check); in turns beside the parent's kernel (the general
    route, ``csrc/fused_mlp.cu``) with the f32 outputs' digests against its;
    the plain ms and the bound; the kernel as the library reports it (its
    rows a block among it); then at each of K1_PATH_ROWS the ms, the
    parent's ms and the bound."""
    from neural_raytracing_tpu_torch.kernels import (
        fused_mlp_forward, mlp_forward_bf16_operands, tile_info,
    )
    from neural_raytracing_tpu_torch.nn import SkipConnMLP
    bf16 = dtype == torch.bfloat16
    label = f"K1{'-bf16' if bf16 else ''} {name}"
    ws = [w.detach() for w in mlp.flat_weights()]
    k1 = lambda xs, **kw: fused_mlp_forward(mlp, xs, mlp.B, ws, dtype, **kw)
    plain = ((lambda xs: mlp_forward_bf16_operands(mlp, xs, mlp.B, ws)) if bf16
             else (lambda xs: SkipConnMLP.forward(mlp, xs)))
    n = x.shape[0]
    r = dict(name=name)
    with torch.no_grad():
        got, parent, want = k1(x), k1(x, route="general"), plain(x)
        torch.cuda.synchronize()
        if bf16:
            got32 = fused_mlp_forward(mlp, x, mlp.B, ws)
            st = check_k1_bf16(label, got, want, got32, SkipConnMLP.forward(mlp, x))
            r.update(rows_ok=st["rows_ok"], mean_err=st["mean_err"])
            err = (got - want).abs()
        else:
            err = (got - want).abs()
            arg = (x @ mlp.B).abs().max().item()
            check(torch.isfinite(got).all().item(), f"{label}: non-finite output")
            check(bool((err <= 1e-4 * want.abs() + 1e-5 + 4e-7 * arg).all()),
                  f"{label}: max |err| {err.max().item():.3e} over tolerance")
        r.update(err=err.max().item(), digest=digest(got), parent_digest=digest(parent),
                 same_bits=bool(torch.equal(got, parent)))
        t = in_turns({"ms": lambda: k1(x), "parent_ms": lambda: k1(x, route="general")})
        t["plain_ms"] = cuda_ms(lambda: plain(x), 5)
    r.update(t)
    r.update(k1_bound(mlp, n, dtype))
    r["info"] = tile_info(mlp, dtype)
    print(f"{label}: {n} points, max |err| {r['err']:.3e}, tile {t['ms']:.4f} ms, parent's "
          f"kernel {t['parent_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}; f32-FMA {r['f32_bound_ms']:.4f}), "
          f"{2.0 * mlp_macs(mlp) * n / t['ms'] / 1e9:.1f} TFLOP/s, share of the bound "
          f"{r['bound_ms'] / t['ms']:.3f}; digest {r['digest']} (parent's "
          f"{r['parent_digest']}, same bits {r['same_bits']}); tile {r['info']}")
    r["path"] = {}
    for shape, rows in K1_PATH_ROWS.items():
        xs = x[:rows].contiguous()
        with torch.no_grad():
            got, want = k1(xs), plain(xs)
            if not bf16:
                check(bool(torch.equal(got, k1(xs, route="general"))),
                      f"{label} at {rows} rows: not the parent kernel's bits")
            check(bool(torch.isfinite(got).all()), f"{label} at {rows} rows: non-finite")
            pt = in_turns({"ms": lambda: k1(xs), "parent_ms": lambda: k1(xs, route="general")})
        pt["bound_ms"] = k1_bound(mlp, rows, dtype)["bound_ms"]
        r["path"][shape] = pt
        print(f"  {label} at the {shape} ({rows} rows): {pt['ms']:.4f} ms, parent's kernel "
              f"{pt['parent_ms']:.4f} ms, bound {pt['bound_ms']:.4f} ms, share "
              f"{pt['bound_ms'] / pt['ms']:.3f}, max |err| {(got - want).abs().max().item():.3e}")
    return r


def k1_totals(reports, nets) -> dict:
    """Phase 2's (16's) totals of K1 (K1-bf16) over ``nets``, the entry of
    the kernels line: at N_POINTS, and per launch of an eval tile (each net
    times its EVAL_TILE_LAUNCHES) as path_ms / path_bound_ms."""
    tot = {k: sum(reports[n][k] for n in nets)
           for k in ("ms", "parent_ms", "plain_ms", "bound_ms", "f32_bound_ms",
                     "tensor_core_bound_ms", "elementwise_floor_ms") if k in reports[nets[0]]}
    tot["err"] = max(reports[n]["err"] for n in nets)
    tot["bound_by"] = "operations"
    launches = sum(EVAL_TILE_LAUNCHES[n] for n in nets)
    tile = {k: sum(EVAL_TILE_LAUNCHES[n] * reports[n]["path"]["eval tile"][k] for n in nets)
            for k in ("ms", "parent_ms", "bound_ms")}
    tot.update(eval_tile_ms=tile["ms"], eval_tile_parent_ms=tile["parent_ms"],
               path_ms=tile["ms"] / launches, path_bound_ms=tile["bound_ms"] / launches)
    return tot


def pack_report(torch, dev) -> dict:
    """The pack kernel (pack_tile_weights) against its plain version
    (tile_pack_plain), bit for bit, on the four flagship nets in both
    operand types; its ms and the plain ms by the profiler's device time
    (a launch is shorter than its host call; device_ms), and the bound
    (bytes: the float32 weights read once, the packed buffer written
    once)."""
    from neural_raytracing_tpu_torch.kernels import (
        pack_tile_weights, tile_layout, tile_pack_plain,
    )
    gen = torch.Generator().manual_seed(3)
    tot = dict(ms=0.0, plain_ms=0.0, bytes=0.0, err=0.0)
    for name, mlp in flagship_nets().items():
        mlp.reset_parameters(gen)
        mlp.to(dev)
        ws = [w.detach() for w in mlp.flat_weights()]
        for dtype in (torch.float32, torch.bfloat16):
            got = pack_tile_weights(mlp, mlp.B, ws, dtype)
            want = tile_pack_plain(mlp, mlp.B, ws, dtype)
            torch.cuda.synchronize()
            for i, (a, b) in enumerate(zip(got, want, strict=True)):
                check(torch.equal(a, b), f"pack {name} {dtype}: slot {i} differs from the "
                      "plain pack")
            ms, tot["timed_by"] = device_ms(torch, lambda: pack_tile_weights(mlp, mlp.B, ws, dtype),
                                            5)
            plain_ms, _ = device_ms(torch, lambda: tile_pack_plain(mlp, mlp.B, ws, dtype), 5)
            n_bytes = weight_bytes(mlp) + tile_layout(mlp, dtype)[1]
            print(f"pack {name} {str(dtype)[6:]}: the same bits as the plain pack; device "
                  f"{ms:.4f} ms ({tot['timed_by']}), plain {plain_ms:.4f} ms, bound "
                  f"{1e3 * n_bytes / PEAK_BYTES:.4f} ms (bytes)")
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bytes"] += n_bytes
        mlp.cpu()
    tot["bound_ms"], tot["bound_by"] = 1e3 * tot["bytes"] / PEAK_BYTES, "bytes"
    print(f"pack, 4 nets x 2 operand types: {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} "
          f"ms, bound {tot['bound_ms']:.4f} ms")
    return tot


def phase_mlp(torch, dev):
    """Phase 2: K1 on the four flagship nets (k1_net_report), its totals,
    and the pack kernel."""
    gen = torch.Generator().manual_seed(1)
    reports = {}
    for name, mlp in flagship_nets().items():
        mlp.reset_parameters(gen)
        mlp.to(dev)
        x = (torch.rand(N_POINTS, 3, generator=gen) - 0.5).to(dev)
        reports[name] = k1_net_report(torch, name, mlp, torch.float32, x)
        mlp.cpu()
    tot = k1_totals(reports, list(reports))
    print(f"K1, 4 nets at {N_POINTS} points: tile {tot['ms']:.3f} ms, parent's kernel "
          f"{tot['parent_ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, bound "
          f"{tot['bound_ms']:.3f} ms (share {tot['bound_ms'] / tot['ms']:.3f}); one eval "
          f"tile (11 launches) {tot['eval_tile_ms']:.3f} ms, parent's kernel "
          f"{tot['eval_tile_parent_ms']:.3f} ms, bound {11 * tot['path_bound_ms']:.3f} ms")
    check(all(r["same_bits"] for r in reports.values()),
          "K1: the tile's float32 outputs are not the parent kernel's bits")
    tot["pack"] = pack_report(torch, dev)
    return tot


def view_rays(torch, dev, elev=30.0, azim=45.0):
    """The 65,536 rays of one 256x256 NeRFCamera view, flattened."""
    from neural_raytracing_tpu_torch.cameras import NeRFCamera, nerf_c2w
    from neural_raytracing_tpu_torch.render import _tile_positions
    c2w = torch.from_numpy(nerf_c2w(elev, azim, 2.0)[None, :3]).to(dev)
    rays = NeRFCamera(c2w, FOCAL).sample_positions(
        _tile_positions(0.0, 0.0, SIZE, dev), size=SIZE)
    return rays.reshape(-1, 6).contiguous()


def march_surface(torch, dev):
    """The full 128-sphere SphereSDF with a non-zero, moderate 8x128 shift
    and spheres large enough to cover part of a view (seed 2)."""
    from neural_raytracing_tpu_torch.shapes import SphereSDF
    gen = torch.Generator().manual_seed(2)
    module = SphereSDF(n=128, k=32.0, mlp=flagship_nets()["sdf_shift 8x128 F32"])
    module.reset_parameters(gen)
    with torch.no_grad():
        module.shift.out.w.mul_(0.1)
        module.shift.out.b.mul_(0.1)
        module.radii.copy_(0.3 + 0.5 * module.radii)
    return module.to(dev)


def march_kernel_report(torch, module, compute_dtype, run, n):
    """K2's (K2-bf16's) kernel as the library reports it (blocks per SM,
    slots, registers, spills), the share of the rows its steps evaluated
    that held a live ray (the launch statistics of one ``run(stats)``), and
    whether its depths and hits are the same bit for bit in a second launch
    and under a random permutation of the rays (``run(stats, perm)``)."""
    from neural_raytracing_tpu_torch.kernels import march_info
    info = march_info(module, compute_dtype)
    stats = torch.zeros(3, dtype=torch.int64, device=module.centers.device)
    d1, h1 = run(stats, None)
    d2, h2 = run(None, None)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(9)).to(d1.device)
    d3, h3 = run(None, perm)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=perm.device)
    same = (torch.equal(d1, d2) and torch.equal(h1, h2) and torch.equal(d1, d3[inv])
            and torch.equal(h1, h3[inv]))
    steps, rows, live = (int(x) for x in stats.tolist())
    return dict(blocks_per_sm=info["blocks_per_sm"], slots=info["slots"],
                registers=info["registers"], local_bytes=info["local_bytes"],
                tile_steps=steps, live_row_share=live / max(rows, 1), bitwise_same=same)


def march_kernel_line(r) -> str:
    return (f"{r['blocks_per_sm']} blocks per SM of {r['slots']} slots, "
            f"{r['registers']} registers, {r['local_bytes']} bytes of local memory a thread; "
            f"{r['tile_steps']} tile steps, live share of the rows evaluated "
            f"{r['live_row_share']:.3f}; bit for bit the same in a second launch "
            f"and under a permutation of the rays: {r['bitwise_same']}")


def phase_march(torch, dev):
    from neural_raytracing_tpu_torch.kernels import (
        fused_march, march_plain, set_kernel_mode,
    )
    from neural_raytracing_tpu_torch.shapes import march_interval

    module = march_surface(torch, dev)
    rays = view_rays(torch, dev)
    r_o, r_d = rays[:, :3].contiguous(), rays[:, 3:].contiguous()
    set_kernel_mode(module, "off")   # the plain march evaluates the plain shift
    per_eval_flops = 2.0 * mlp_macs(module.shift) + 31.0 * module.n
    results = {}
    for label, steps, bound in (("bounded", 256, 1.2), ("unbounded", 64, None)):
        if bound is None:
            t0, t1 = None, 10.0
        else:
            t0, t1 = march_interval(r_o, r_d, bound, 10.0)
        kernel = lambda: fused_march(module, r_o, r_d, t1, max_steps=steps,
                                     epsilon=1e-3, t_start=t0)
        plain = lambda: march_plain(module, r_o, r_d, t1, t0, max_steps=steps,
                                    epsilon=1e-3)
        depth, hit = kernel()
        pdepth, phit, evals = plain()
        torch.cuda.synchronize()
        agree = (hit == phit).float().mean().item()
        both = hit & phit
        derr = (depth - pdepth)[both].abs().max().item() if both.any() else 0.0
        frac = phit.float().mean().item()
        check(frac > 0, f"K2 {label}: no ray hit the surface")
        check(agree >= 0.99, f"K2 {label}: hit agreement {agree:.4f} < 0.99")
        check(derr <= 1e-3, f"K2 {label}: max |depth err| {derr:.3e} > 1e-3")

        def run(stats, perm):
            p = slice(None) if perm is None else perm
            return fused_march(module, r_o[p].contiguous(), r_d[p].contiguous(),
                               t1 if t0 is None else t1[p].contiguous(), max_steps=steps,
                               epsilon=1e-3, t_start=None if t0 is None else t0[p].contiguous(),
                               stats=stats)

        rep = march_kernel_report(torch, module, torch.float32, run, N_POINTS)
        check(rep["bitwise_same"], f"K2 {label}: depths differ between launches or "
              "under a permutation of the rays")
        ms = cuda_ms(kernel, 5)
        plain_ms = cuda_ms(plain, 3)
        n_evals = evals.sum().item()
        n_bytes = 4 * N_POINTS * (6 + (2 if bound else 0)) + 5 * N_POINTS \
            + weight_bytes(module.shift) + 4 * 13 * module.n
        b_ms, b_by = bound_ms(n_bytes, per_eval_flops * n_evals)
        print(f"K2 {label} ({steps} steps): hit fraction {frac:.4f}, hit "
              f"agreement {agree:.6f}, max |depth err| {derr:.3e}, SDF "
              f"evaluations needed {n_evals} ({n_evals / N_POINTS:.2f}/ray), "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms "
              f"({b_by}), {per_eval_flops * n_evals / ms / 1e9:.1f} TFLOP/s, "
              f"{n_evals / ms:,.0f} evaluations/ms; {march_kernel_line(rep)}")
        results[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, err=derr, evals_per_ms=n_evals / ms,
                              **{k: rep[k] for k in ("blocks_per_sm", "registers",
                                                     "local_bytes", "live_row_share")})
    return results


def march_shapes(torch, dev):
    """The shapes K2 is launched at on the main paths, each as (label, the
    SphereSDF, r_o, r_d, t_start, max_t, steps, omega): one 128^2 eval tile
    of the flagship (seed-0 weights, bounded, 256 steps) and one validation
    tile (unbounded, 64 steps), the 38,400 rays of a flagship training step
    (64 steps), the 65,536 orbit rays of the NeRV checkpoint at omega 1.4
    (128 steps, phase 15) and the 65,536 view rays of phase 3 through its
    seeded non-zero surface (bounded, 256 steps)."""
    from neural_raytracing_tpu_torch.kernels import set_kernel_mode
    from neural_raytracing_tpu_torch.render import _tile_positions
    from neural_raytracing_tpu_torch.shapes import march_interval
    from neural_raytracing_tpu_torch.workloads import nerf_synthetic, render

    flagship = nerf_synthetic.build_scene(max_steps=256, march_bound=1.2)
    flagship.init(torch.Generator().manual_seed(0), device=dev)
    seed0 = flagship.shape.module
    tile = view_rays(torch, dev).reshape(SIZE, SIZE, 6)[:CHUNK, :CHUNK].reshape(-1, 6)
    t_o, t_d = tile[:, :3].contiguous(), tile[:, 3:].contiguous()
    s_o, s_d = scan_rays(torch, dev)
    nerv = nerv_scene(torch, dev, 128, None, "learned").shape.module
    orbit = torch.cat([render.frame_camera(f, ORBIT_FRAMES, 1.0, 20.0).to(dev).sample_positions(
        _tile_positions(0.0, 0.0, ORBIT_SIZE, dev), size=ORBIT_SIZE).reshape(-1, 6)
        for f in range(ORBIT_FRAMES)])
    o_o, o_d = orbit[:, :3].contiguous(), orbit[:, 3:].contiguous()
    surface = march_surface(torch, dev)
    view = view_rays(torch, dev)
    v_o, v_d = view[:, :3].contiguous(), view[:, 3:].contiguous()
    for m in (seed0, nerv, surface):
        set_kernel_mode(m, "off")    # the plain march evaluates the plain shift
    return [("eval tile", seed0, t_o, t_d, *march_interval(t_o, t_d, 1.2, 10.0), 256, 1.0),
            ("validation tile", seed0, t_o, t_d, None, 10.0, 64, 1.0),
            ("training step", seed0, s_o, s_d, None, 10.0, 64, 1.0),
            ("relaxed orbit", nerv, o_o, o_d, None, 10.0, 128, OMEGA),
            ("table shape", surface, v_o, v_d, *march_interval(v_o, v_d, 1.2, 10.0), 256, 1.0)]


def eval_distribution(evals) -> dict:
    """Mean, median, 99th percentile and maximum of the SDF evaluations per
    ray, and their sum."""
    import torch
    e = evals.double().flatten()
    q = torch.quantile(e, torch.tensor([0.5, 0.99], dtype=e.dtype, device=e.device),
                       interpolation="higher").tolist()
    return dict(mean=e.mean().item(), p50=q[0], p99=q[1], max=int(evals.max().item()),
                total=int(evals.sum().item()))


class two_blocks_per_sm:
    """Within this context K2 launches two persistent blocks a SM (as many as
    fit; at most one a ray) instead of march_plan's one: the other grid,
    timed in the same call."""

    def __enter__(self):
        import torch
        self.fm = sys.modules["neural_raytracing_tpu_torch.kernels.fused_march"]
        self.saved = self.fm.march_plan
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.fm.march_plan = lambda n, device: min(n, 2 * sms)
        return self

    def __exit__(self, *exc):
        self.fm.march_plan = self.saved


def phase_march_shapes(torch, dev):
    """K2 and K2-bf16 at the shapes the main paths launch them at
    (march_shapes): the SDF evaluations each ray needs (march_plain's
    count), K2 against march_plain as phase 3 holds it, both kernels' times,
    evaluations/ms and the live share of the rows their steps evaluated; each
    also with two blocks a SM."""
    from neural_raytracing_tpu_torch.kernels import (
        fused_march, fused_march_bf16, march_plain, march_plan,
    )
    out = {}
    for label, module, r_o, r_d, t0, t1, steps, omega in march_shapes(torch, dev):
        n = r_o.shape[0]
        kw = dict(max_steps=steps, epsilon=1e-3, t_start=t0, omega=omega)
        pdepth, phit, evals = march_plain(module, r_o, r_d, t1, t0, max_steps=steps,
                                          epsilon=1e-3, omega=omega)
        stats, stats16 = (torch.zeros(3, dtype=torch.int64, device=dev) for _ in range(2))
        depth, hit = fused_march(module, r_o, r_d, t1, stats=stats, **kw)
        depth16, hit16 = fused_march_bf16(module, r_o, r_d, t1, stats=stats16, **kw)
        torch.cuda.synchronize()
        agree = (hit == phit).float().mean().item()
        both = hit & phit
        derr = (depth - pdepth)[both].abs().max().item() if both.any() else 0.0
        check(agree >= 0.99, f"K2 {label}: hit agreement {agree:.4f} < 0.99")
        check(derr <= 1e-3, f"K2 {label}: max |depth err| {derr:.3e} > 1e-3")
        dist = eval_distribution(evals)
        kernel = lambda: fused_march(module, r_o, r_d, t1, **kw)
        kernel16 = lambda: fused_march_bf16(module, r_o, r_d, t1, **kw)
        ms, ms16 = cuda_ms(kernel, 5), cuda_ms(kernel16, 5)
        live, live16 = (int(x[2]) / max(int(x[1]), 1) for x in (stats.tolist(), stats16.tolist()))
        res = dict(n=n, steps=steps, omega=omega, dist=dist, ms=ms, bf16_ms=ms16,
                   evals_per_ms=dist["total"] / ms, bf16_evals_per_ms=dist["total"] / ms16,
                   live_row_share=live, bf16_live_row_share=live16,
                   blocks=march_plan(n, dev),
                   tile_steps=int(stats[0]), bf16_tile_steps=int(stats16[0]))
        with two_blocks_per_sm():
            res["two_blocks_ms"] = cuda_ms(kernel, 5)
            res["bf16_two_blocks_ms"] = cuda_ms(kernel16, 5)
        extra = (f"; two blocks a SM: K2 {res['two_blocks_ms']:.3f} ms, K2-bf16 "
                 f"{res['bf16_two_blocks_ms']:.3f} ms")
        print(f"K2 at the {label}: {n} rays, {steps} steps, omega {omega}; SDF "
              f"evaluations per ray mean {dist['mean']:.2f}, median {dist['p50']:.0f}, 99th "
              f"percentile {dist['p99']:.0f}, most {dist['max']} ({dist['total']} in all); "
              f"hit agreement {agree:.6f}, max |depth err| {derr:.3e}; K2 {ms:.3f} ms "
              f"({res['evals_per_ms']:,.0f} evaluations/ms, live share "
              f"{live:.3f}, {res['tile_steps']} tile steps), K2-bf16 {ms16:.3f} ms "
              f"({res['bf16_evals_per_ms']:,.0f} evaluations/ms, live share {live16:.3f}; "
              f"hit flags that differ from K2 {int((hit16 != hit).sum().item())}); "
              f"{res['blocks']} blocks{extra}")
        out[label] = res
    out["step ms"] = march_step_times(torch, dev)
    return out


def unending_rays(torch, n: int, dev):
    """``n`` rays from distance 2 towards the surface of march_surface: with
    eps -1 none hits and with max_t 1e30 none leaves, so each takes all its
    steps, its points converging on the surface, as a path's rays march near
    it (rays that march away double their depth a step).  -> (r_o, r_d)."""
    d = torch.nn.functional.normalize(
        torch.rand(n, 3, generator=torch.Generator().manual_seed(4)) + 0.2, dim=-1).to(dev)
    return (2.0 * d).contiguous(), (-d).contiguous()


def march_step_times(torch, dev):
    """Milliseconds of one K2 (K2-bf16) step by the rows it evaluates, with
    its blocks alone on the card: unending_rays take all 64 steps; one
    block with 128, 64 or 32 of them, and full blocks, one a SM or two."""
    from neural_raytracing_tpu_torch.kernels import fused_march
    module = march_surface(torch, dev)
    fm = sys.modules["neural_raytracing_tpu_torch.kernels.fused_march"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for label, blocks, n in (("one block, 128 rows", 1, 128), ("one block, 64 rows", 1, 64),
                             ("one block, 32 rows", 1, 32),
                             ("a block a SM, 128 rows", sms, 128 * sms),
                             ("two blocks a SM, 128 rows", 2 * sms, 256 * sms)):
        o, d = unending_rays(torch, n, dev)
        saved, fm.march_plan = fm.march_plan, lambda *a, b=blocks: b
        try:
            out[label] = [cuda_ms(lambda: fused_march(module, o, d, 1e30, max_steps=64,
                                                      epsilon=-1.0, compute_dtype=dt), 3) / 64
                          for dt in (torch.float32, torch.bfloat16)]
        finally:
            fm.march_plan = saved
    print("K2 step ms (f32, bf16) by the rows a block evaluates, 64 steps of unending rays: "
          + "; ".join(f"{k} {v[0]:.4f}, {v[1]:.4f}" for k, v in out.items()))
    return out


def one_block_step_ms(torch, module, run, rows: int, compute_dtype) -> float:
    """Milliseconds of one step of a slot kernel with one block of 128 slots
    on the card evaluating ``rows`` unending_rays: ``run(module, o, d,
    compute_dtype)`` launches 64 steps (eps -1, max_t 1e30)."""
    fm = sys.modules["neural_raytracing_tpu_torch.kernels.fused_march"]
    o, d = unending_rays(torch, rows, module.centers.device)
    saved = fm.march_plan, fm.shadow_plan
    fm.march_plan, fm.shadow_plan = (lambda *a: 1), (lambda *a: (1, 128))
    try:
        return cuda_ms(lambda: run(module, o, d, compute_dtype), 3) / 64
    finally:
        fm.march_plan, fm.shadow_plan = saved


def march_times_main(root: str):
    """``python3 chip_smoke.py --march-times [DIR]``: K2's and K2-bf16's ms at
    the path's shapes (march_shapes), and K4's and K4-bf16's ms a launch at
    theirs (shadow_shapes), and K3's and K3-bf16's at phase 5's, for the
    package in DIR (this checkout's by default), one JSON line, to compare
    two trees in one call; with a digest of K2's depths and hits at each
    shape, of K3's indices and of K4's flags (both operand types), to show
    two trees give the same bits."""
    import hashlib
    import torch
    sys.path.insert(0, str(Path(root).resolve()))
    import neural_raytracing_tpu_torch
    from neural_raytracing_tpu_torch.kernels import (
        _build, fused_march, fused_march_bf16, fused_shadow_march, fused_shadow_march_bf16,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build()
    from neural_raytracing_tpu_torch.kernels import fused_min_scan, fused_min_scan_bf16
    digest = hashlib.sha256()
    times = {}
    for label, module, r_o, r_d, t0, t1, steps, omega in march_shapes(torch, dev):
        kw = dict(max_steps=steps, epsilon=1e-3, t_start=t0, omega=omega)
        for k in (fused_march, fused_march_bf16):
            for t in k(module, r_o, r_d, t1, **kw):
                digest.update(t.cpu().numpy().tobytes())
        times[label] = [cuda_ms(lambda: fused_march(module, r_o, r_d, t1, **kw), 5),
                        cuda_ms(lambda: fused_march_bf16(module, r_o, r_d, t1, **kw), 5)]
    k2_digest = digest.hexdigest()[:16]
    digest = hashlib.sha256()
    surface = march_surface(torch, dev)
    s_o, s_d = scan_rays(torch, dev)
    scan_ms = []
    for k in (fused_min_scan, fused_min_scan_bf16):
        digest.update(k(surface, s_o, s_d, 2.2 / 128, steps=128).cpu().numpy().tobytes())
        scan_ms.append(cuda_ms(lambda: k(surface, s_o, s_d, 2.2 / 128, steps=128), 5))
    k3_digest = digest.hexdigest()[:16]
    shadow = {}
    digest = hashlib.sha256()
    module, shapes = shadow_shapes(torch, dev)
    for label, launches, steps, ple in shapes:
        kw = dict(max_steps=steps, epsilon=1e-3, past_light_exit=ple)
        for k in (fused_shadow_march, fused_shadow_march_bf16):
            for r_o, r_d, mt, _ in launches:
                digest.update(k(module, r_o, r_d, mt, **kw).cpu().numpy().tobytes())
        shadow[label] = [[cuda_ms(lambda: k(module, r_o, r_d, mt, **kw), 5)
                          for r_o, r_d, mt, _ in launches]
                         for k in (fused_shadow_march, fused_shadow_march_bf16)]
    print(json.dumps({"package": neural_raytracing_tpu_torch.__file__, "march_ms": times,
                      "shadow_ms": shadow, "min_scan_ms": scan_ms, "k2_digest": k2_digest,
                      "k3_digest": k3_digest, "k4_digest": digest.hexdigest()[:16]}))


def render_views(torch, scene, views, dev):
    """-> (images [V, 256, 256, 3], seconds per view) with the settings of
    training/eval.py's evaluate: chunk 128, bundle 1, background 0, jitter
    1e-3 from a seeded key per view."""
    import neural_raytracing_tpu_torch as T
    from neural_raytracing_tpu_torch.cameras import NeRFCamera, nerf_c2w
    from neural_raytracing_tpu_torch.integrators import Direct
    images, secs = [], []
    for i, (elev, azim) in enumerate(views):
        cam = NeRFCamera(torch.from_numpy(nerf_c2w(elev, azim, 2.0)[None, :3]), FOCAL)
        torch.cuda.synchronize()
        start = time.perf_counter()
        img, _ = T.pathtrace(scene, cam, Direct(training=False), size=SIZE,
                             chunk_size=CHUNK, bundle_size=1, background=0.0,
                             key=i, with_noise=1e-3, device=dev)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - start)
        images.append(img)
    return torch.stack(images), secs


def profile_step(torch, fn, label):
    """Device time by kernel and the idle share of one call of ``fn`` ->
    {busy_ms, wall_ms, launches} (None when the profiler saw no device
    time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start)
    # user annotations (Optimizer.step#...) span kernels already counted
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    busy_ms = 1e-3 * sum(e.self_device_time_total for e in kernels)
    if busy_ms == 0.0:
        print(f"  profile of {label}: the profiler saw no device time")
        return
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    rest = ranked[14:]
    print(f"  profile of {label}: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall "
          f"under the profiler (idle share {1 - busy_ms / wall_ms:.3f}), "
          f"{sum(e.count for e in kernels)} kernel launches; top kernels:")
    for e in ranked[:14]:
        print(f"    {1e-3 * e.self_device_time_total:9.3f} ms  x{e.count:<5d} {e.key[:100]}")
    print(f"    {1e-3 * sum(e.self_device_time_total for e in rest):9.3f} ms  "
          f"x{sum(e.count for e in rest):<5d} the other {len(rest)} kernels")
    k1 = {label: [e for e in kernels if any(k in e.key for k in keys)] for label, keys in (
        ("K1 tile", ("nrt_mlp_tile_f32_kernel",)), ("K1-bf16 tile", ("nrt_mlp_tile_bf16_kernel",)),
        ("K1 first kernel", ("nrt_fused_mlp_kernel",)), ("pack", ("nrt_mlp_tile_pack_kernel",)))}
    print("    K1: " + ", ".join(
        f"{label} {1e-3 * sum(e.self_device_time_total for e in es):.3f} ms x"
        f"{sum(e.count for e in es)}" for label, es in k1.items()))
    bwd = {part: [e for e in kernels if key in e.key] for part, key in BWD_PARTS.items()}
    if any(bwd.values()):
        print("    K6/K7 tile: " + ", ".join(
            f"{part} {1e-3 * sum(e.self_device_time_total for e in es):.3f} ms x"
            f"{sum(e.count for e in es)}" for part, es in bwd.items()))
    return dict(busy_ms=busy_ms, wall_ms=wall_ms, launches=sum(e.count for e in kernels))


def k1_routes(label) -> dict:
    """The launches by route of K1, K1-bf16 and the backward K6/K7 since the
    counts were reset: every fused net of the main paths takes the tile."""
    from neural_raytracing_tpu_torch.kernels import route_counts
    routes = route_counts()
    check(all(r["general"] == 0 for r in routes.values()),
          f"{label}: a fused net took a kernel's general route: {routes}")
    return routes


def packed_nets(scene) -> int:
    """The (net, operand type) pairs the tile kernels pack in ``scene``:
    each fused MLP at its compute dtype, and each SDF's shift net at its
    march dtype (K2-K4 read it from the same cache)."""
    from neural_raytracing_tpu_torch.kernels import FusedSkipConnMLP, supports
    from neural_raytracing_tpu_torch.shapes import SDF
    pairs = {(id(m), m.compute_dtype) for m in scene.modules()
             if isinstance(m, FusedSkipConnMLP)}
    pairs |= {(id(m.module.shift), m.march_dtype) for m in scene.modules()
              if isinstance(m, SDF) and supports(m.module)}
    return len(pairs)


def phase_slice(torch, dev, label, max_steps, march_bound, views, profile=False):
    from neural_raytracing_tpu_torch.kernels import (
        launch_counts, reset_launch_counts, set_kernel_mode,
    )
    from neural_raytracing_tpu_torch.workloads import nerf_synthetic
    scene = nerf_synthetic.build_scene(max_steps=max_steps, march_bound=march_bound)
    scene.init(torch.Generator().manual_seed(0), device=dev)
    render_views(torch, scene, views[:1], dev)      # warm-up, not counted
    reset_launch_counts()
    got, secs = render_views(torch, scene, views, dev)
    counts = launch_counts()
    routes = k1_routes(label)
    # the warm-up view packed every net's weights; the counted views reuse them
    check(counts["pack_tile_weights"] == 0, f"{label}: the views packed weights again")
    if profile:
        profile_step(torch, lambda: render_views(torch, scene, views[:1], dev),
                     "one view")
    set_kernel_mode(scene, "off")
    render_views(torch, scene, views[:1], dev)      # warm-up
    want, plain_secs = render_views(torch, scene, views, dev)
    set_kernel_mode(scene, "auto")

    for name in ("fused_mlp_forward", "fused_march"):   # the render's kernels
        check(counts[name] > 0, f"{label}: kernel {name} was not launched on the path")
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all()),
          f"{label}: non-finite image")
    mask, pmask = got.abs().sum(-1) > 0, want.abs().sum(-1) > 0
    frac = pmask.float().mean().item()
    agree = (mask == pmask).float().mean().item()
    diff = (got - want).abs()
    check(frac > 0, f"{label}: no pixel hit the surface")
    check(agree >= 0.99, f"{label}: mask agreement {agree:.4f} < 0.99")
    check(diff.mean().item() <= 1e-3, f"{label}: mean |diff| {diff.mean().item():.3e}")
    ms_view = 1e3 * sum(secs) / len(secs)
    plain_ms_view = 1e3 * sum(plain_secs) / len(plain_secs)
    print(f"{label}: {len(views)} view(s) 256x256, kernels {ms_view:.1f} ms/view "
          f"({SIZE * SIZE / (ms_view / 1e3):.0f} rays/s), plain "
          f"{plain_ms_view:.1f} ms/view ({SIZE * SIZE / (plain_ms_view / 1e3):.0f} "
          f"rays/s); per-view ms {[round(1e3 * s, 1) for s in secs]} / "
          f"{[round(1e3 * s, 1) for s in plain_secs]}; hit fraction "
          f"{frac:.4f}, mask agreement {agree:.6f}, mean |diff| "
          f"{diff.mean().item():.3e}, max |diff| {diff.max().item():.3e}; "
          f"launches {counts}; K1 routes {routes}")
    return counts


# ---- slice 2: the training step -----------------------------------------------

CROP_SIZE = 80
N_VIEWS = 6
N_RAYS = N_VIEWS * CROP_SIZE * CROP_SIZE          # 38,400 rays a step
LRS = {"shape": 8e-5, "bsdf": 8e-4, "lights": 8e-5}
# ground-truth views at unit distance (the NeRF-synthetic loader's
# normalisation): elevation, azimuth
TRAIN_VIEWS = [(20.0, 0.0), (35.0, 45.0), (-10.0, 90.0), (50.0, 135.0),
               (25.0, 180.0), (5.0, 225.0), (40.0, 270.0), (-20.0, 315.0)]
GT_RADIUS = 0.25


def silhouette_crop():
    """(u, v) of a crop halfway down one side of the view: it straddles the
    silhouette of the random-init surface (whose centre crop is all hit)."""
    return (SIZE - CROP_SIZE) // 2, SIZE // 16


def train_c2ws():
    import numpy as np
    from neural_raytracing_tpu_torch.cameras import nerf_c2w
    return np.stack([nerf_c2w(e, a, 1.0)[:3] for e, a in TRAIN_VIEWS]).astype(np.float32)


def crop_rays(torch, dev, c2ws, u, v):
    """[V, 80, 80, 1, 6] NeRFCamera rays of the crop at (u, v)."""
    from neural_raytracing_tpu_torch.cameras import NeRFCamera
    from neural_raytracing_tpu_torch.render import _tile_positions
    return NeRFCamera(torch.from_numpy(c2ws), FOCAL).to(dev).sample_positions(
        _tile_positions(float(u), float(v), CROP_SIZE, dev), size=SIZE)


def sphere_gt(torch, c2ws):
    """Ground truth made here with numpy: an analytic diffuse sphere of
    radius 0.25 at the origin, lit from one direction, over 256x256 views;
    masks from the ray-sphere test.  -> (images [V, 256, 256, 3], masks)."""
    import numpy as np
    from neural_raytracing_tpu_torch.cameras import NeRFCamera
    from neural_raytracing_tpu_torch.render import _tile_positions
    rays = NeRFCamera(torch.from_numpy(c2ws), FOCAL).sample_positions(
        _tile_positions(0.0, 0.0, SIZE, "cpu"), size=SIZE)[..., 0, :].numpy()
    r_o, r_d = rays[..., :3].astype(np.float64), rays[..., 3:].astype(np.float64)
    b = np.sum(r_o * r_d, -1)
    disc = b * b - (np.sum(r_o * r_o, -1) - GT_RADIUS ** 2)
    mask = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    normal = (r_o + t[..., None] * r_d) / GT_RADIUS
    light = np.asarray([0.4, 0.8, 0.45]) / np.linalg.norm([0.4, 0.8, 0.45])
    albedo = np.asarray([0.8, 0.55, 0.35])
    shade = 0.15 + 0.85 * np.clip(normal @ light, 0.0, 1.0)
    img = mask[..., None] * albedo * shade[..., None]
    return img.astype(np.float32), mask.astype(np.float32)


def scan_rays(torch, dev, half_res=False):
    """(r_o, r_d) [n, 3] of K3's training shape: 6 views x the 80^2
    silhouette crop at unit distance (38,400 rays), or its 2x-subsampled
    grid (9,600 rays, SDF.throughput_mode="half_res")."""
    u, v = silhouette_crop()
    rays = crop_rays(torch, dev, train_c2ws()[:N_VIEWS], u, v)
    if half_res:
        rays = rays[:, ::2, ::2]
    rays = rays.reshape(-1, 6)
    return rays[:, :3].contiguous(), rays[:, 3:].contiguous()


def check_scan(torch, label, module, sdf, r_o, r_d, step, steps, idx, pidx, agree_min,
               tie_max):
    """A min-scan's indices against the plain version's: agreement, and the
    two SDF values where they differ (near ties).  -> (agreement, max |sd
    difference|, indices that differ)."""
    differ = idx != pidx
    n_differ = int(differ.sum().item())
    err = 0.0
    if n_differ:
        s = torch.tensor(step, device=r_o.device)
        with torch.no_grad():
            sd = sdf(r_o[differ] + (idx[differ] * s)[:, None] * r_d[differ])
            psd = sdf(r_o[differ] + (pidx[differ] * s)[:, None] * r_d[differ])
        err = (sd - psd).abs().max().item()
    agree = 1.0 - n_differ / idx.numel()
    check(agree >= agree_min, f"{label}: index agreement {agree:.6f} < {agree_min}")
    check(err <= tie_max, f"{label}: |sd(kernel idx) - sd(plain idx)| {err:.3e} > {tie_max}")
    check(len(torch.unique(pidx)) > 1, f"{label}: every ray has the same argmin")
    return agree, err, n_differ


def cheap_activation_twin(module):
    """A copy of ``module`` whose shift net takes leaky_relu instead of its
    activation: the same widths and products with a nearly free epilogue,
    to time what the activation costs inside K3."""
    import copy
    from neural_raytracing_tpu_torch.nn.mlp import ACTIVATIONS
    twin = copy.deepcopy(module)
    twin.shift.activation_name = "leaky_relu"
    twin.shift.activation = ACTIVATIONS["leaky_relu"]
    return twin


def segment_split(torch, module, kernel, shapes, compute_dtype):
    """K3's sample segments on ``shapes`` ((r_o, r_d) pairs, 128 steps):
    -> ([segments the wrapper chooses], [ms of ``kernel`` with every ray in
    one segment]), the latter timed right after the chosen split, in the
    same call."""
    fm = sys.modules["neural_raytracing_tpu_torch.kernels.fused_march"]
    chosen = [fm.min_scan_plan(module, r_o.shape[0], 128, compute_dtype, r_o.device)
              for r_o, _ in shapes]
    saved, fm.min_scan_plan = fm.min_scan_plan, lambda *args: 1
    try:
        one = [cuda_ms(lambda: kernel(module, r_o, r_d, 2.2 / 128, steps=128), 5)
               for r_o, r_d in shapes]
    finally:
        fm.min_scan_plan = saved
    return chosen, one


# K3 and K3-bf16 before their redesign, measured by this script on an NVIDIA
# H100 80GB HBM3 (700 W) at 38,400 rays x 129 samples
K3_PREV_MS = {"f32": 120.85, "bf16": 112.77}
# the flagship training steps in the same run: f32 (phase 7), and bf16 and
# f32 timed in turns (phase 17)
PREV_STEP_MS = {"f32": 311.8, "bf16": 304.4, "bf16 call f32": 304.8}


def phase_minscan(torch, dev):
    """K3 against min_scan_plain on the 38,400 rays of 6 views x the 80^2
    silhouette crop at unit distance, 128 steps of 2.2/128, through the
    surface of phase 3; K3 alone on the half-res grid (9,600 rays)."""
    from neural_raytracing_tpu_torch.kernels import (
        fused_min_scan, min_scan_blocks_per_sm, min_scan_plain, set_kernel_mode,
    )
    module = march_surface(torch, dev)
    set_kernel_mode(module, "off")   # the plain scan evaluates the plain shift
    r_o, r_d = scan_rays(torch, dev)
    steps, step = 128, 2.2 / 128
    kernel = lambda: fused_min_scan(module, r_o, r_d, step, steps=steps)
    plain = lambda: min_scan_plain(module, r_o, r_d, step, steps=steps)
    idx, pidx = kernel(), plain()
    torch.cuda.synchronize()
    agree, err, n_differ = check_scan(torch, "K3", module, module, r_o, r_d, step, steps,
                                      idx, pidx, 0.999, 1e-5)
    ms = cuda_ms(kernel, 5)
    plain_ms = cuda_ms(plain, 2)
    per_sample = 2.0 * mlp_macs(module.shift) + 31.0 * module.n
    flops = float(N_RAYS) * (steps + 1) * per_sample
    n_bytes = 4 * N_RAYS * 7 + weight_bytes(module.shift) + 4 * 13 * module.n
    b_ms, b_by = bound_ms(n_bytes, flops)
    cheap = cheap_activation_twin(module)
    cheap_ms = cuda_ms(lambda: fused_min_scan(cheap, r_o, r_d, step, steps=steps), 5)
    h_o, h_d = scan_rays(torch, dev, half_res=True)
    half_ms = cuda_ms(lambda: fused_min_scan(module, h_o, h_d, step, steps=steps), 5)
    segs, one = segment_split(torch, module, fused_min_scan, [(r_o, r_d), (h_o, h_d)],
                              torch.float32)
    half_flops = float(h_o.shape[0]) * (steps + 1) * per_sample
    half_b, _ = bound_ms(4 * h_o.shape[0] * 7 + weight_bytes(module.shift)
                         + 4 * 13 * module.n, half_flops)
    blocks = min_scan_blocks_per_sm(module)
    print(f"K3 fused_min_scan: {N_RAYS} rays x {steps + 1} samples, index "
          f"agreement {agree:.6f} ({n_differ} indices differ from min_scan_plain), max "
          f"|sd difference| {err:.3e}, kernel {ms:.3f} ms (before the redesign: "
          f"{K3_PREV_MS['f32']} ms), plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms "
          f"({b_by}), {flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.3f} of the bound; "
          f"{blocks} blocks per SM; half-res {h_o.shape[0]} rays {half_ms:.3f} ms, bound "
          f"{half_b:.3f} ms, {half_flops / half_ms / 1e9:.1f} TFLOP/s, "
          f"{half_b / half_ms:.3f} of the bound; the same widths with a leaky_relu "
          f"shift {cheap_ms:.3f} ms (the softplus epilogue's cost: {ms - cheap_ms:.3f} ms); "
          f"sample segments {segs[0]} and {segs[1]}, with one segment a ray instead "
          f"{one[0]:.3f} and {one[1]:.3f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, err=err,
                segments=segs[0], one_segment_ms=one[0], half_res_one_segment_ms=one[1],
                half_res_ms=half_ms, half_res_bound_ms=half_b,
                blocks_per_sm=blocks, indices_differ=n_differ)


def kernel_profile(torch, fn, reps: int = 3) -> dict:
    """{kernel name: (device ms a call, launches a call)} of ``fn`` under the
    profiler over ``reps`` calls, after one warm-up call: a launch's mean
    ms times its launches a call, rounded (a trace may miss a launch)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (1e-3 * e.self_device_time_total / e.count * round(e.count / reps),
                    round(e.count / reps))
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.count > 0}


def host_ms(torch, fn, reps: int = 5) -> float:
    """Median host milliseconds of a call of ``fn`` that only launches (the
    card idle and synchronised before each)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - start))
    torch.cuda.synchronize()
    return sorted(times)[len(times) // 2]


# K6's and K7's tile kernels (csrc/fused_mlp_bwd_tile.cu) by the names the
# profiler gives them
BWD_PARTS = {"store forward": "nrt_bwd_store_fwd_kernel", "chain": "nrt_bwd_chain_kernel",
             "dW": "nrt_dw_kernel", "dW reduce": "nrt_dw_reduce_kernel",
             "transposed pack": "nrt_mlp_tile_pack_t_kernel"}


def bwd_parts(prof: dict) -> dict:
    """``kernel_profile``'s entries grouped into BWD_PARTS (ms, launches) and
    "other" (every other kernel)."""
    out = {part: [0.0, 0.0] for part in (*BWD_PARTS, "other")}
    for key, (ms, count) in prof.items():
        part = next((p for p, k in BWD_PARTS.items() if k in key), "other")
        out[part][0] += ms
        out[part][1] += count
    return out


def parts_line(parts: dict) -> str:
    return ", ".join(f"{p} {ms:.3f} ms x{count:g}" for p, (ms, count) in parts.items() if count)


def phase_backward(torch, dev):
    """K6 (segments 0) and K7 (segments 4) on the weight net, one lobe and
    the light field, 38,400 rows each with a seeded upstream gradient: on
    the tile (csrc/fused_mlp_bwd_tile.cu) against the autograd recompute
    backward, dW the same bits in two runs; in turns with the parent's
    kernels (the general route, csrc/fused_mlp_bwd.cu) and the plain
    versions; each sub-kernel's device ms and launches from the profiler and
    each product's share of its bound; the transposed pack against its
    plain version."""
    from neural_raytracing_tpu_torch.kernels import (
        ckpt_forward_plain, dw_plan, fused_mlp_backward, fused_mlp_ckpt_forward,
        fused_mlp_segment_backward, mlp_backward, pack_tile_transposes, route_counts,
        reset_launch_counts, segment_backward_plain, segment_bounds, tile_bwd_info,
        tile_transpose_layout, tile_transposes_plain,
    )
    from neural_raytracing_tpu_torch.nn import ACTIVATION_GRADS, mlp_forward

    gen = torch.Generator().manual_seed(3)
    nets = flagship_nets()
    names = ["weight_net 16x256 F128", "lobe 6x96 F64", "light_field 10x256 F16"]
    tot = {k: dict(ms=0.0, parent_ms=0.0, plain_ms=0.0, flops=0.0, bytes=0.0, err=0.0)
           for k in ("k6", "k7a", "k7b")}
    pack = dict(ms=0.0, plain_ms=0.0, flops=0.0, bytes=0.0, err=0.0)
    k6_parts = {p: [0.0, 0.0] for p in (*BWD_PARTS, "other")}
    k7b_parts = {p: [0.0, 0.0] for p in (*BWD_PARTS, "other")}
    for name in names:
        mlp = nets[name]
        mlp.reset_parameters(gen)
        mlp.to(dev)
        x = (torch.rand(N_RAYS, 3, generator=gen) - 0.5).to(dev)
        g = torch.randn(N_RAYS, mlp.out_size, generator=gen).to(dev)
        ws = [w.detach() for w in mlp.flat_weights()]

        def plain():   # the autograd recompute of _FusedMLP.backward
            xx = x.clone().requires_grad_()
            wr = [w.clone().requires_grad_() for w in ws]
            return torch.autograd.grad(mlp_forward(mlp, xx, mlp.B, wr), [xx] + wr, g)

        want = plain()
        for seg in (0, 4):
            label = f"{'K6' if seg == 0 else 'K7'} {name} (segments {seg})"
            reset_launch_counts()
            dx, grads = mlp_backward(mlp, x, g, mlp.B, ws, seg)
            routes = route_counts()
            torch.cuda.synchronize()
            check(all(r["general"] == 0 for r in routes.values()),
                  f"{label}: a kernel took the general route: {routes}")
            absm = max((a - b).abs().max().item() for a, b in zip([dx, *grads], want))
            # a pre-activation within rounding of a leaky_relu kink takes the
            # other slope in one of the two sum orders: that row's dx moves
            # by O(1), so dx is held row by row and the sums over rows in L2
            row_err = (dx - want[0]).abs().max(dim=-1).values
            off_rows = int((row_err > 1e-4 * want[0].abs().max()).sum().item())
            rel_l2 = max(((a - b).norm() / b.norm().clamp_min(1e-30)).item()
                         for a, b in zip(grads, want[1:]))
            check(off_rows <= 1e-3 * N_RAYS, f"{label}: {off_rows} rows of dx off "
                  "by more than 1e-4 max |plain|")
            check(rel_l2 <= 1e-3, f"{label}: dW/db rel L2 {rel_l2:.3e} > 1e-3")
            dx2, grads2 = mlp_backward(mlp, x, g, mlp.B, ws, seg)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip([dx, *grads], [dx2, *grads2]))
            check(same, f"{label}: dx/dW/db not the same bits in a second run")
            tot["k6" if seg == 0 else "k7b"]["err"] = max(
                tot["k6" if seg == 0 else "k7b"]["err"], absm)
            print(f"{label}: max |err| {absm:.3e}; dx rows off by > 1e-4 max|plain| "
                  f"{off_rows} of {N_RAYS}; worst dW/db rel L2 {rel_l2:.3e}; the same bits "
                  f"in a second run {same}; routes {routes}")
        del dx, grads, dx2, grads2
        macs = layer_macs(mlp)
        L = mlp.num_layers
        info = tile_bwd_info(mlp)
        dw_shapes = [(w.shape[0], w.shape[1]) for w in ws[0::2]]
        print(f"  {name}: tile kernels {info}; dW plan at {N_RAYS} rows "
              f"{dw_plan(N_RAYS, dw_shapes)}")
        # the transposed pack, bit for bit, and its device ms
        got, want_t = pack_tile_transposes(mlp, ws), tile_transposes_plain(mlp, ws)
        torch.cuda.synchronize()
        check(all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, want_t)),
              f"transposed pack {name}: differs from the plain pack")
        p_ms, _ = device_ms(torch, lambda: pack_tile_transposes(mlp, ws), 5)
        p_plain, _ = device_ms(torch, lambda: tile_transposes_plain(mlp, ws), 5)
        p_bytes = 4 * (sum(w.numel() for w in ws[0:2 * L + 1:2]) + tile_transpose_layout(mlp)[1])
        _add(pack, p_ms, p_plain, 0.0, p_bytes)
        del got, want_t
        # K6: tile, parent, plain in turns; its sub-kernels
        k6 = lambda route=None: fused_mlp_backward(mlp, x, g, mlp.B, ws, route=route)
        t = in_turns({"ms": k6, "parent_ms": lambda: k6("general"), "plain_ms": plain}, 3)
        flops = 6.0 * sum(macs) * N_RAYS
        io = 4 * N_RAYS * (2 * mlp.in_size + mlp.out_size) + 2 * weight_bytes(mlp)
        _add(tot["k6"], t["ms"], t["plain_ms"], flops, io)
        tot["k6"]["parent_ms"] += t["parent_ms"]
        parts = bwd_parts(kernel_profile(torch, k6))
        parent_launches = sum(c for _, c in kernel_profile(torch, lambda: k6("general")).values())
        host = host_ms(torch, k6)
        for p, (ms, count) in parts.items():
            k6_parts[p][0] += ms
            k6_parts[p][1] += count
        product_bound = 1e3 * 2.0 * sum(macs) * N_RAYS / PEAK_F32
        fwd_bound = 1e3 * 2.0 * sum(macs[:-1]) * N_RAYS / PEAK_F32
        shares = {p: b / parts[p][0] for p, b in (("store forward", fwd_bound),
                                                  ("chain", product_bound), ("dW", product_bound))
                  if parts[p][0] > 0}
        print(f"K6 {name}: tile {t['ms']:.3f} ms, parent's kernels {t['parent_ms']:.3f} ms, "
              f"autograd recompute {t['plain_ms']:.3f} ms, bound {1e3 * flops / PEAK_F32:.3f} "
              f"ms; launches a call: tile {sum(c for _, c in parts.values()):g}, parent's "
              f"{parent_launches:g}; the host's time in a call {host:.3f} ms; by kernel: "
              f"{parts_line(parts)}; share of each product's "
              f"bound ({product_bound:.3f} ms; the forward {fwd_bound:.3f}): "
              + ", ".join(f"{p} {v:.3f}" for p, v in shares.items()))
        # K7a: the boundary checkpoint forward
        segs = segment_bounds(L, 4)
        bounds = sorted({s0 for s0, _ in segs} | {L})
        k7a = lambda route=None: fused_mlp_ckpt_forward(mlp, x, mlp.B, ws, bounds, route=route)
        t = in_turns({"ms": k7a, "parent_ms": lambda: k7a("general"),
                      "plain_ms": lambda: ckpt_forward_plain(mlp, x, mlp.B, ws, bounds)}, 3)
        flops = 2.0 * sum(macs[:-1]) * N_RAYS
        io = 4 * N_RAYS * (mlp.in_size + mlp.enc_size + len(bounds) * mlp.hidden_size) \
            + weight_bytes(mlp)
        _add(tot["k7a"], t["ms"], t["plain_ms"], flops, io)
        tot["k7a"]["parent_ms"] += t["parent_ms"]
        print(f"K7a {name}: tile {t['ms']:.3f} ms, parent's kernel {t['parent_ms']:.3f} ms, "
              f"plain {t['plain_ms']:.3f} ms, bound {1e3 * flops / PEAK_F32:.3f} ms")
        # K7b: every segment, deepest first, on the inputs of one K7 run
        hs_at, enc = fused_mlp_ckpt_forward(mlp, x, mlp.B, ws, bounds)
        dact = ACTIVATION_GRADS[mlp.activation_name]
        gh = ((g @ ws[-2].t()) * dact(hs_at[L])).contiguous()
        seg_args = []
        for l0, l1 in reversed(segs):
            args = (mlp, x, mlp.B, ws, enc, hs_at[l0], gh, l0, l1)
            seg_args.append(args)
            gh = fused_mlp_segment_backward(*args)[0]
        k7b = lambda route=None: [fused_mlp_segment_backward(*a, route=route) for a in seg_args]
        t = in_turns({"ms": k7b, "parent_ms": lambda: k7b("general"),
                      "plain_ms": lambda: [segment_backward_plain(*a) for a in seg_args]}, 3)
        flops = sum(2.0 * N_RAYS * (sum(macs[1 + l0:l1]) + 2 * sum(macs[1 + l0:1 + l1]))
                    for l0, l1 in segs)
        io = sum(4 * N_RAYS * (mlp.in_size + mlp.enc_size + 4 * mlp.hidden_size)
                 + 2 * 4 * sum(ws[2 + 2 * k].numel() for k in range(l0, l1)) for l0, l1 in segs)
        _add(tot["k7b"], t["ms"], t["plain_ms"], flops, io)
        tot["k7b"]["parent_ms"] += t["parent_ms"]
        parts = bwd_parts(kernel_profile(torch, k7b))
        for p, (ms, count) in parts.items():
            k7b_parts[p][0] += ms
            k7b_parts[p][1] += count
        print(f"K7b {name} ({len(segs)} segments): tile {t['ms']:.3f} ms, parent's kernels "
              f"{t['parent_ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, bound "
              f"{1e3 * flops / PEAK_F32:.3f} ms; by kernel: {parts_line(parts)}")
        del want, hs_at, enc, gh, seg_args
        mlp.cpu()
        torch.cuda.empty_cache()
    for key, label in (("k6", "K6 fused_mlp_backward"), ("k7a", "K7a fused_mlp_ckpt_forward"),
                       ("k7b", "K7b fused_mlp_segment_backward (all segments)")):
        t = tot[key]
        t["bound_ms"], t["bound_by"] = bound_ms(t["bytes"], t["flops"])
        print(f"{label}, 3 nets x {N_RAYS} rows: tile {t['ms']:.3f} ms, parent's kernels "
              f"{t['parent_ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, bound "
              f"{t['bound_ms']:.3f} ms ({t['bound_by']}), {t['flops'] / t['ms'] / 1e9:.1f} "
              f"TFLOP/s, share of the bound {t['bound_ms'] / t['ms']:.3f}")
    print(f"K6, 3 nets, by kernel: {parts_line(k6_parts)}")
    print(f"K7b, 3 nets, by kernel: {parts_line(k7b_parts)}")
    print(f"K7a + K7b: tile {tot['k7a']['ms'] + tot['k7b']['ms']:.3f} ms, plain "
          f"{tot['k7a']['plain_ms'] + tot['k7b']['plain_ms']:.3f} ms")
    tot["k7a"]["err"] = tot["k7b"]["err"]
    pack["bound_ms"], pack["bound_by"] = 1e3 * pack["bytes"] / PEAK_BYTES, "bytes"
    print(f"transposed pack, 3 nets: the same bits as the plain pack; device {pack['ms']:.4f} "
          f"ms, plain {pack['plain_ms']:.4f} ms, bound {pack['bound_ms']:.4f} ms (bytes)")
    tot["pack"] = pack
    return tot


def _add(total, ms, plain_ms, flops, n_bytes):
    total["ms"] += ms
    total["plain_ms"] += plain_ms
    total["flops"] += flops
    total["bytes"] += n_bytes


def set_kernel_bwd(torch, scene, on: bool, segments: int = 4):
    """K6/K7 backward on the shading nets (the BSDF lobes, the weight net and
    the light field); the SDF shift keeps its differentiable backward."""
    from neural_raytracing_tpu_torch.kernels import FusedSkipConnMLP
    for part in (scene.bsdf, scene.lights):
        for m in part.modules():
            if isinstance(m, FusedSkipConnMLP):
                m.kernel_bwd = on
                m.kernel_bwd_segments = segments


# the shading nets' backward routes of a training step: (kernel_bwd, segments)
STEP_ROUTES = {"recompute": (False, 4), "K6": (True, 0), "K7": (True, 4)}


def step_routes(torch, scene, one_step, reps: int = 3):
    """The flagship step with each of STEP_ROUTES: the wall ms a step (host
    clock, synchronised; the median of ``reps`` steps a turn, the routes in
    turns a, b, c, c, b, a), then one profile each (device busy ms,
    launches); every shading net on the tile route."""
    from neural_raytracing_tpu_torch.kernels import reset_launch_counts

    def timed(route):
        set_kernel_bwd(torch, scene, *STEP_ROUTES[route])
        one_step()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = time.perf_counter()
            one_step()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - start))
        return sorted(times)[len(times) // 2]

    walls = {route: [] for route in STEP_ROUTES}
    for order in (list(STEP_ROUTES), list(STEP_ROUTES)[::-1]):
        for route in order:
            walls[route].append(timed(route))
    out = {}
    for route, (on, segments) in STEP_ROUTES.items():
        set_kernel_bwd(torch, scene, on, segments)
        reset_launch_counts()
        prof = profile_step(torch, one_step, f"one training step, backward route {route}")
        routes = k1_routes(f"step, backward route {route}")
        out[route] = dict(walls=walls[route], **(prof or {}))
        print(f"step with the backward route {route}: wall {walls[route]} ms/step (in "
              f"turns), device busy {out[route].get('busy_ms', float('nan')):.1f} ms, "
              f"{out[route].get('launches', 0)} launches; routes {routes}")
    set_kernel_bwd(torch, scene, False)
    return out


def train_paths(scene, spec, state, gen, host: tuple, device: dict, **kw):
    """One training setup on both data paths over one shared state ->
    ({"host": steps, "device": steps}, box): ``steps(n)`` runs n steps of
    train, ``box["state"]`` holds the last state.  ``host`` is train's
    (make_camera, exp_imgs, exp_masks, its own keywords), ``device`` the
    device path's keywords (device_data, camera_builder); ``kw`` both's."""
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.training import train
    box = {"state": state}

    def on(args, extra):
        def steps(n):
            box["state"], _ = train(scene, Direct(training=True), spec, box["state"], *args,
                                    gen, iters=n, **extra, **kw)
        return steps

    return {"host": on(host[:3], host[3]), "device": on((None, None, None), device)}, box


def counted_path(torch, label, steps, kernels, n: int = 10) -> dict:
    """Run ``steps(n)`` with the launch counts reset just before and read
    just after: each of ``kernels`` must have launched, every fused net on
    the tile.  -> the counts."""
    from neural_raytracing_tpu_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    steps(n)
    torch.cuda.synchronize()
    counts = launch_counts()
    routes = k1_routes(label)
    for name in kernels:
        check(counts[name] > 0, f"{label}: kernel {name} was not launched on the path")
    print(f"{label}: {n} steps, launches {counts}; K1 routes {routes}")
    return counts


def steps_profile(torch, fn, steps: int):
    """One profile of ``fn``, which runs ``steps`` training steps -> ({busy_ms,
    wall_ms, launches} a step, {kernel name: (device ms a step, launches a
    step)}, as kernel_profile gives them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.") and e.count > 0]
    busy_ms = 1e-3 * sum(e.self_device_time_total for e in events)
    kernels = {e.key: (1e-3 * e.self_device_time_total / e.count * round(e.count / steps),
                       round(e.count / steps)) for e in events}
    return (dict(busy_ms=busy_ms / steps, wall_ms=wall_ms / steps,
                 launches=sum(e.count for e in events) / steps), kernels)


def data_path_turns(torch, label, paths: dict, rays: int, steps: int = 10,
                    rounds: int = 1) -> dict:
    """The host and the on-device data path of one training setup in turns
    (``rounds`` rounds of host, device, device, host; ``steps`` steps of
    train each), ms/step on the host's clock, each round two pairs, one
    with either path first; then for each path one profile of 3 steps
    (device busy ms, idle share, launches and K1-K4's device ms a launch),
    and the calls that wait for the card in 3 steps (sync_sites), which must
    be no more on the device path.  ``paths[name](n)`` runs n steps on that
    path."""
    import numpy as np
    walls = {k: [] for k in paths}
    for k in ("host", "device", "device", "host") * rounds:
        torch.cuda.synchronize()
        start = time.perf_counter()
        paths[k](steps)
        torch.cuda.synchronize()
        walls[k].append(1e3 * (time.perf_counter() - start) / steps)
    out = {}
    for k, fn in paths.items():
        prof, kernels = steps_profile(torch, lambda: fn(3), 3)
        check(prof["busy_ms"] > 0, f"{label}, {k} path: the profiler saw no device time")
        syncs = sync_sites(torch, lambda: fn(3))
        ms = float(np.median(walls[k]))
        out[k] = dict(ms=ms, busy_ms=prof["busy_ms"], launches=prof["launches"],
                      idle=1 - prof["busy_ms"] / prof["wall_ms"], syncs=syncs,
                      path=k_path_ms(kernels))
        print(f"{label}, {k} data path: {[round(x, 1) for x in walls[k]]} ms/step in turns "
              f"({rays / ms * 1e3:,.0f} rays/s); a profile of 3 steps: busy "
              f"{out[k]['busy_ms']:.1f} ms a step, idle share {out[k]['idle']:.3f}, "
              f"{out[k]['launches']:.0f} launches a step; K1-K4 device ms a launch: "
              f"{k_line(out[k]['path'])}; {sum(syncs.values())} waits for the card in 3 "
              f"steps: {syncs}")
    host, dev = out["host"], out["device"]
    n_host, n_dev = sum(host["syncs"].values()), sum(dev["syncs"].values())
    check(n_dev <= n_host, f"{label}: the device data path waits for the card {n_dev} times "
          f"in 3 steps, the host path {n_host}")
    wins = sum(d < h for d, h in zip(walls["device"], walls["host"]))
    q1, q3 = np.percentile(walls["host"], [25, 75])
    print(f"{label} on {card()}: device data path / host path: median ms/step "
          f"{dev['ms']:.1f} / {host['ms']:.1f} ({dev['ms'] / host['ms']:.3f}), the device path "
          f"faster in {wins} of {len(walls['host'])} pairs, the host path's quartile spread "
          f"{q3 - q1:.1f} ms; busy {dev['busy_ms']:.1f} / {host['busy_ms']:.1f} ms a step, idle "
          f"share {dev['idle']:.3f} / {host['idle']:.3f}, waits in 3 steps {n_dev} / {n_host}")
    return out


def phase_train(torch, dev):
    """The flagship training step: step parity kernels vs plain, 20
    iterations of train through the kernels, the on-device data path in
    turns with the host path, the K6/K7 routes, the plain route, a profile,
    evaluate; then the workload's own entry (phase_flagship_twin) and one
    orbit frame of workloads.render --workload nerf."""
    import copy

    import numpy as np
    from neural_raytracing_tpu_torch.cameras import NeRFCamera
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.kernels import (
        launch_counts, reset_launch_counts, set_kernel_mode,
    )
    from neural_raytracing_tpu_torch.training import (
        TrainState, build_step_fn, device_dataset, evaluate, make_optimizer, train,
    )
    from neural_raytracing_tpu_torch.workloads import nerf_synthetic

    c2ws = train_c2ws()
    imgs, masks = sphere_gt(torch, c2ws)
    cover = masks.mean(axis=(1, 2))
    check(((cover > 0.25) & (cover < 0.6)).all(), f"GT coverage {cover} off")
    print(f"GT: {len(c2ws)} views 256x256 of an analytic sphere, coverage "
          f"{[round(float(c), 3) for c in cover]}")
    make_camera = lambda idxs: NeRFCamera(torch.from_numpy(c2ws[np.asarray(idxs)]), FOCAL)
    spec = make_optimizer(LRS)
    scene = nerf_synthetic.build_scene(max_steps=64, march_bound=None)
    scene.init(torch.Generator().manual_seed(0), device=dev)

    # step parity: one step from the same state and batch, no jitter
    idxs = list(range(N_VIEWS))
    u, v = silhouette_crop()
    exp = torch.from_numpy(imgs[idxs, u:u + CROP_SIZE, v:v + CROP_SIZE]).to(dev)
    mask = torch.from_numpy(masks[idxs, u:u + CROP_SIZE, v:v + CROP_SIZE]).to(dev)
    rays = crop_rays(torch, dev, c2ws[idxs], u, v)
    res = {}
    for label, mode in (("kernels", "auto"), ("plain", "off")):
        sc = copy.deepcopy(scene)
        set_kernel_mode(sc, mode)
        step = build_step_fn(sc, Direct(training=True), spec, size=SIZE,
                             crop_size=CROP_SIZE)
        _, aux = step(TrainState(sc, spec.init(sc), 0), make_camera(idxs), (u, v),
                      exp, mask)
        grads = {c: torch.cat([p.grad.reshape(-1) for p in getattr(sc, c).parameters()])
                 for c in ("shape", "bsdf", "lights")}
        with torch.no_grad():
            _, hit = sc.shape.intersect(rays, primary=False)
        res[label] = (aux["loss"].item(), grads, hit)
        del sc
    (lk, gk, hk), (lp, gp, hp) = res["kernels"], res["plain"]
    rel_loss = abs(lk - lp) / abs(lp)
    n_hit_diff = int((hk != hp).sum().item())
    rel_g = {c: ((gk[c] - gp[c]).norm() / gp[c].norm().clamp_min(1e-30)).item() for c in gk}
    print(f"step parity (kernels vs every kernel off, no jitter): loss {lk:.6f} vs "
          f"{lp:.6f} (rel {rel_loss:.3e}), rays whose hit differs {n_hit_diff} of "
          f"{hk.numel()} (hit fraction {hp.float().mean().item():.4f}), gradient rel "
          f"L2 {', '.join(f'{c} {e:.3e}' for c, e in rel_g.items())}")
    check(np.isfinite(lk) and rel_loss <= 1e-4, f"step parity: loss rel {rel_loss:.3e} > 1e-4")
    check(n_hit_diff <= 0.001 * hk.numel(), f"step parity: {n_hit_diff} hit flags differ")
    check(hp.any().item(), "step parity: no ray hit the surface")
    for c, e in rel_g.items():
        check(e <= 1e-2, f"step parity: {c} gradient rel L2 {e:.3e} > 1e-2")
    del res, gk, gp

    kw = dict(size=SIZE, crop_size=CROP_SIZE, n_views=N_VIEWS, mask_weight=15.0,
              with_ssim=True, log_every=0, nan_policy="raise")
    state = TrainState(scene, spec.init(scene), 0)
    gen = torch.Generator(device=dev).manual_seed(1)

    def run(iters, label, seed):
        nonlocal state
        reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, losses = train(scene, Direct(training=True), spec, state, make_camera,
                              imgs, masks, gen, iters=iters, seed=seed, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
        counts = launch_counts()
        routes = k1_routes(label)
        check(len(losses) == iters and np.isfinite(losses).all(), f"{label}: loss {losses}")
        # the optimizer's in-place update invalidates each net's pack: at most
        # one pack a packed net and step
        check(counts["pack_tile_weights"] <= packed_nets(scene) * iters,
              f"{label}: {counts['pack_tile_weights']} packs in {iters} steps")
        print(f"{label}: {iters} steps, {iters / secs:.3f} steps/s, "
              f"{iters * N_RAYS / secs:,.0f} rays/s, {1e3 * secs / iters:.1f} ms/step, "
              f"losses {[round(x, 3) for x in losses]}; launches {counts}; K1 routes "
              f"{routes}")
        return counts, secs / iters

    run(2, "training warm-up", 100)
    before = {k: p.detach().clone() for k, p in scene.named_parameters()}
    counts, step_s = run(20, "training (kernels)", 0)
    print(f"  before K3's redesign: {PREV_STEP_MS['f32']} ms/step; one step's "
          f"device time 221.5 ms, K3 119.9 ms of it")
    changed = sum(not torch.equal(before[k], p) for k, p in scene.named_parameters())
    check(changed > 0, "training: no parameter changed")
    for name in ("fused_mlp_forward", "fused_march", "fused_min_scan", "pack_tile_weights"):
        check(counts[name] > 0, f"training: kernel {name} was not launched on the path")
    launches = dict(counts)

    # the on-device data path beside the host path (uniform crops, as above)
    data = device_dataset(imgs, masks, c2ws, CROP_SIZE, device=dev)
    paths, box = train_paths(scene, spec, state, gen, (make_camera, imgs, masks, {}),
                             dict(device_data=data,
                                  camera_builder=lambda c: NeRFCamera(c, FOCAL)), **kw)
    counted_path(torch, "training, device data path", paths["device"],
                 ("fused_mlp_forward", "fused_march", "fused_min_scan"))
    data_path_turns(torch, "flagship training", paths, N_RAYS)
    state = box["state"]
    routes = {}
    for label, seg, names in (("K6 (kernel_bwd, segments 0)", 0,
                               ["fused_mlp_backward", "pack_tile_transposes"]),
                              ("K7 (kernel_bwd, segments 4)", 4,
                               ["fused_mlp_ckpt_forward", "fused_mlp_segment_backward"])):
        set_kernel_bwd(torch, scene, True, seg)
        c, routes[label] = run(3, f"training, {label}", 1 + seg)
        for name in names:
            check(c[name] > 0, f"{label}: kernel {name} was not launched on the path")
            launches[name] = c[name]
    set_kernel_bwd(torch, scene, False)
    set_kernel_mode(scene, "off")
    _, routes["plain"] = run(3, "training, every kernel off", 7)
    set_kernel_mode(scene, "auto")

    step = build_step_fn(scene, Direct(training=True), spec, size=SIZE, crop_size=CROP_SIZE)
    one_step = lambda: step(state, make_camera(idxs), (u, v), exp, mask, gen)
    profile_step(torch, one_step, "one training step (kernels)")
    step_routes(torch, scene, one_step)

    start = time.perf_counter()
    out = evaluate(scene, lambda i: make_camera([i]), imgs[:2], Direct(training=False),
                   size=SIZE, chunk_size=CHUNK, log_fn=lambda s: None)
    check(all(np.isfinite(v) for v in out.values()), f"evaluate: {out}")
    print(f"evaluate on 2 GT views (trained {state.step} steps): PSNR {out['psnr']:.3f}, "
          f"SSIM {out['ssim']:.4f}, L1 {out['l1']:.5f}, "
          f"{1e3 * (time.perf_counter() - start) / 2:.1f} ms/view")
    twin_scene = phase_flagship_twin(torch, dev, c2ws, imgs, masks)
    orbit_frame(torch, dev, "nerf", twin_scene)
    return launches, step_s, routes


def phase_flagship_twin(torch, dev, c2ws, imgs, masks):
    """The flagship workload's own entry (workloads.nerf_synthetic.run) at
    full width on phase 7's GT, with the options its schedule can take: the
    half-res min-scan for 3 steps and then full resolution, the on-device
    data path, the weight_reg and sat_guard terms, a validation render every
    3 steps, then one test view (256 steps, bounded 1.2).  -> the trained
    scene."""
    import numpy as np
    from neural_raytracing_tpu_torch.kernels import launch_counts, reset_launch_counts
    from neural_raytracing_tpu_torch.training import NeRFDataset
    from neural_raytracing_tpu_torch.workloads import nerf_synthetic

    data = NeRFDataset(c2ws, FOCAL, imgs, masks)
    test = NeRFDataset(c2ws[:1], FOCAL, imgs[:1], masks[:1])
    args = twin_args(nerf_synthetic, size=SIZE, crop_size=CROP_SIZE, n_views=N_VIEWS, iters=6,
                     half_res_warmup=3, device_data=True, weight_reg=0.01, sat_guard=0.01,
                     valid_freq=3, log_every=0, device=str(dev))
    check(nerf_synthetic.phases(args) == [("half_res", 3), ("full", 3)],
          f"flagship twin: phases {nerf_synthetic.phases(args)}")
    reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    state, res = nerf_synthetic.run(args, data, test, save=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    counts = launch_counts()
    routes = k1_routes("flagship twin")
    for name in ("fused_mlp_forward", "fused_march", "fused_min_scan"):
        check(counts[name] > 0, f"flagship twin: kernel {name} was not launched on the path")
    check(len(res["losses"]) == 6 and np.isfinite(res["losses"]).all(),
          f"flagship twin: losses {res['losses']}")
    check(all(np.isfinite(v) for v in res["test"].values()), f"flagship twin: {res['test']}")
    check(res["test_images"].shape == (1, SIZE, SIZE, 3), "flagship twin: test render shape")
    print(f"flagship twin (workloads.nerf_synthetic.run, {N_VIEWS} x {CROP_SIZE}^2, half-res "
          f"warm-up 3 steps then 3 full, device data path, weight_reg and sat_guard 0.01, "
          f"validation every 3 steps, one test view): {secs:.2f} s, losses "
          f"{[round(x, 3) for x in res['losses']]}; test PSNR {res['test']['psnr']:.3f} dB "
          f"(black {black_psnr(test.images):.3f}); launches {counts}; K1 routes {routes}")
    return state.scene


def orbit_frame(torch, dev, workload, scene):
    """workloads.render.main --workload ``workload``: one 128^2 frame over
    ``scene``'s weights, after a warm-up frame, its launches counted; K1 and
    K2 must have run.  -> (the frame, the launch counts)."""
    import tempfile

    import numpy as np
    from neural_raytracing_tpu_torch.kernels import launch_counts, reset_launch_counts
    from neural_raytracing_tpu_torch.training import save_scene
    from neural_raytracing_tpu_torch.workloads import render
    label = f"{workload} orbit"
    with tempfile.TemporaryDirectory() as tmp:
        save_scene(tmp, scene)
        args = ["--workload", workload, "--models", tmp, "--size", str(ORBIT_SIZE),
                "--frames", "1", "--device", str(dev), "--outputs", tmp]
        render.main(args)                                              # warm-up
        reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        frame = render.main(args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
        counts = launch_counts()
    k1_routes(label)
    check(counts["fused_march"] > 0 and counts["fused_mlp_forward"] > 0,
          f"{label}: launches {counts}")
    check(frame.shape == (1, ORBIT_SIZE, ORBIT_SIZE, 3) and np.isfinite(frame).all(),
          f"{label}: frame {frame.shape}, finite {np.isfinite(frame).all()}")
    print(f"{label} (workloads.render.main --workload {workload}, one {ORBIT_SIZE}^2 frame): "
          f"{1e3 * secs:.1f} ms (scene build and load included), lit fraction "
          f"{(frame.sum(-1) > 0).mean():.4f}; launches {counts}")
    return frame, counts


# ---- slice 3: the NeRV workload ---------------------------------------------------

NERV_SIZE = 200
NERV_CHUNK = 100                                   # scripts/_common.py chunk_for(200)
NERV_FOCAL = 0.5 * NERV_SIZE / math.tan(0.5 * 0.6911)
NERV_CROP = 64
NERV_VIEWS = 3
NERV_RAYS = NERV_VIEWS * NERV_CROP * NERV_CROP     # 12,288 rays a step
NERV_LRS = {"shape": 4e-5, "bsdf": 4e-5, "lights": 4e-5, "occ": 4e-5}
NERV_EVAL_VIEWS = [(30.0, 45.0), (30.0, 165.0), (30.0, 285.0)]


def nerv_scene(torch, dev, max_steps, march_bound, occlusion, fused_sdf=False):
    """workloads.nerv.build_scene with the trained checkpoint loaded."""
    from neural_raytracing_tpu_torch.training import load_scene
    from neural_raytracing_tpu_torch.workloads.nerv import build_scene
    scene = build_scene(max_steps=max_steps, march_bound=march_bound,
                        occlusion=occlusion, fused_sdf=fused_sdf)
    load_scene(str(ARTIFACTS), scene)
    return scene.to(dev)


def nerv_camera(torch, views, dist=2.0):
    import numpy as np
    from neural_raytracing_tpu_torch.cameras import NeRFCamera, nerf_c2w
    c2w = np.stack([nerf_c2w(e, a, dist)[:3] for e, a in views]).astype(np.float32)
    return NeRFCamera(torch.from_numpy(c2w), NERV_FOCAL)


def shadow_rays(torch, scene, camera, positions, locs, with_hit=False):
    """Shadow rays from the march end points of ``camera``'s rays at
    ``positions`` (the hit points where they hit) towards each view's light
    -> (r_o, r_d, distance to the light), flat; with ``with_hit`` also
    whether the camera ray hit."""
    rays = camera.sample_positions(positions, size=NERV_SIZE)
    with torch.no_grad():
        it, hit = scene.shape.intersect(rays, primary=False)
        loc = locs.reshape(-1, 1, 1, 1, 3)
        d = loc - it.p
        dist = d.norm(dim=-1)
        d = d / dist[..., None]
    out = (it.p.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous(),
           dist.reshape(-1).contiguous())
    return out + (hit.reshape(-1),) if with_hit else out


def shadow_shapes(torch, dev):
    """The shapes K4 is launched at on the NeRV paths, built on the trained
    checkpoint from the march end points of the camera rays towards the
    light (eps 1e-3) -> (the SphereSDF, [(label, launches [(r_o, r_d,
    max_t, the camera ray hit)], steps, past_light_exit)]):
    (a) an eval chunk: the four 100^2 chunks of one 200^2 view, one launch
    each (10,000 rays, 128 steps); (b) a training call: 3 views x 64^2
    crops (12,288 rays, 64 steps); (c) the whole 200^2 view in one launch
    (40,000 rays, 128 steps, the table's shape); (d) (c) without the
    past-light exit."""
    from neural_raytracing_tpu_torch.kernels import set_kernel_mode
    from neural_raytracing_tpu_torch.render import _tile_positions
    scene = nerv_scene(torch, dev, 128, 1.2, "hard")
    locs = scene.lights.location.detach()
    cam = nerv_camera(torch, NERV_EVAL_VIEWS[:1]).to(dev)
    tiles = range(NERV_SIZE // NERV_CHUNK)
    chunks = [shadow_rays(torch, scene, cam, _tile_positions(
        float(i * NERV_CHUNK), float(j * NERV_CHUNK), NERV_CHUNK, dev), locs[:1], True)
        for i in tiles for j in tiles]
    view = shadow_rays(torch, scene, cam, _tile_positions(0.0, 0.0, NERV_SIZE, dev),
                       locs[:1], True)
    c0 = float((NERV_SIZE - NERV_CROP) // 2)
    crops = shadow_rays(torch, scene, nerv_camera(torch, NERV_EVAL_VIEWS).to(dev),
                        _tile_positions(c0, c0, NERV_CROP, dev), locs, True)
    module = scene.shape.module
    set_kernel_mode(scene, "off")      # the plain march evaluates the plain shift
    return module, [("(a) eval chunk", chunks, 128, True),
                    ("(b) training call", [crops], 64, True),
                    ("(c) eval view", [view], 128, True),
                    ("(d) eval view, no exit", [view], 128, False)]


def slot_model(evals, blocks: int, slots: int, step_ms: dict, min_rows: int = 32) -> dict:
    """A plain model of a persistent slot kernel's time from the SDF
    evaluations each ray needs (``evals``, in queue order) and one step's ms
    by the rows it evaluates (``step_ms`` {rows: ms}): ``blocks`` blocks of
    ``slots`` slots, the first fill even (block b takes rays b * per ..., per =
    min(ceil(n / blocks), slots)), then a free slot takes the next ray of the
    queue, the block whose clock is least asking first; a step evaluates
    ``slots`` rows, or once the live slots fit, half of them down to
    ``min_rows``.  -> {"ms": the slowest block's clock, "steps", "rows",
    "live" (summed over blocks), "block_most" (the most evaluations a ray of
    one block's first fill needs, over the blocks)}."""
    import heapq

    import numpy as np
    e = np.asarray(evals, dtype=np.int64).reshape(-1)
    n = e.shape[0]
    per = min(-(-n // max(blocks, 1)), slots)
    left = [np.zeros(0, np.int64) for _ in range(blocks)]
    heap = [(0.0, b, True) for b in range(blocks)]
    queue, ms, steps, rows_sum, live_sum, most = 0, 0.0, 0, 0, 0, 0
    while heap:
        clock, b, first = heapq.heappop(heap)
        cur = left[b]
        free = (per if first else slots) - cur.shape[0]
        if free > 0 and queue < n:
            take = e[queue:queue + free]
            queue += take.shape[0]
            if first and take.shape[0]:
                most = max(most, int(take.max()))
            cur = np.concatenate([cur, take[take > 0]])
        live = cur.shape[0]
        if live == 0:
            if queue >= n:
                ms = max(ms, clock)
                continue
            heapq.heappush(heap, (clock, b, False))
            continue
        rows = slots
        while rows // 2 >= min_rows and live <= rows // 2:
            rows //= 2
        steps, rows_sum, live_sum = steps + 1, rows_sum + rows, live_sum + live
        cur = cur - 1
        left[b] = cur[cur > 0]
        heapq.heappush(heap, (clock + step_ms[rows], b, False))
    return dict(ms=ms, steps=steps, rows=rows_sum, live=live_sum, block_most=most)


def shadow_check(torch, label, kernel, sdf, launch, kw):
    """K4 (K4-bf16: ``kernel(r_o, r_d, max_t, **kw)``) on one launch against
    shadow_march_plain over ``sdf``: not-blocked agreement >= 0.999; the
    same flags bit for bit in a second launch and under a random
    permutation of the rays; then with the directions of the rays whose
    camera ray missed (the render's masked light samples) and of every 97th
    ray that hit set to zero, the plain flags exactly on those rays.  ->
    (plain flags, evaluations per ray, launch statistics [steps, rows, live],
    agreement, zero-direction rays, of which blocked)."""
    from neural_raytracing_tpu_torch.kernels import shadow_march_plain
    r_o, r_d, mt, hit = launch
    n = r_o.shape[0]
    stats = torch.zeros(3, dtype=torch.int64, device=r_o.device)
    nb = kernel(r_o, r_d, mt, stats=stats, **kw)
    pnb, evals = shadow_march_plain(sdf, r_o, r_d, mt, **kw)
    nb2 = kernel(r_o, r_d, mt, **kw)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(9)).to(r_o.device)
    nb3 = kernel(r_o[perm].contiguous(), r_d[perm].contiguous(), mt[perm].contiguous(), **kw)
    agree = (nb == pnb).float().mean().item()
    check(agree >= 0.999, f"{label}: not-blocked agreement {agree:.6f} < 0.999")
    check(torch.equal(nb, nb2) and torch.equal(nb[perm], nb3),
          f"{label}: flags differ between launches or under a permutation of the rays")
    zero = ~hit | (torch.arange(n, device=hit.device) % 97 == 0)
    zd = torch.where(zero[:, None], 0.0, r_d).contiguous()
    znb = kernel(r_o, zd, mt, **kw)
    zp, _ = shadow_march_plain(sdf, r_o, zd, mt, **kw)
    check(torch.equal(znb[zero], zp[zero]),
          f"{label}: {int((znb != zp)[zero].sum())} zero-direction rays differ from the plain loop")
    check((znb == zp).float().mean().item() >= 0.999,
          f"{label}: not-blocked agreement with zero-direction rays < 0.999")
    return pnb, evals, [int(x) for x in stats.tolist()], agree, int(zero.sum()), \
        int((~zp[zero]).sum())


def shadow_shape_report(torch, name, module, shapes, kernel, compute_dtype, sdf, bound_fn,
                        step_ms):
    """K4 or K4-bf16 (``kernel(r_o, r_d, max_t, **kw)``, called ``name``, with
    ``compute_dtype`` operands) at
    each of ``shapes`` (shadow_shapes): shadow_check on every launch, some
    rays blocked and some not over each shape's launches (else the
    comparisons hold trivially; one 100^2 chunk of (a) has no blocked ray),
    the SDF evaluations per ray, ms a launch, plain ms, bound (``bound_fn(n,
    evaluations) -> (ms, by)``), evaluations/ms, the live share of the rows
    the steps evaluated, and slot_model's ms from this kernel's ``step_ms``
    by rows.  -> {label: {...}}."""
    import numpy as np
    from neural_raytracing_tpu_torch.kernels import shadow_march_plain
    fm = sys.modules["neural_raytracing_tpu_torch.kernels.fused_march"]
    out = {}
    for label, launches, steps, ple in shapes:
        kw = dict(max_steps=steps, epsilon=1e-3, past_light_exit=ple)
        res = dict(ms=[], plain_ms=[], bound_ms=[], model_ms=[], evals=[], steps=0,
                   rows=0, live=0, agree=1.0, zero=0, zero_blocked=0, blocked=0, n=0)
        for r_o, r_d, mt, hit in launches:
            pnb, evals, st, agree, n_zero, z_blocked = shadow_check(
                torch, f"{name} {label}", kernel, sdf, (r_o, r_d, mt, hit), kw)
            n = r_o.shape[0]
            res["ms"].append(cuda_ms(lambda: kernel(r_o, r_d, mt, **kw), 5))
            res["plain_ms"].append(cuda_ms(lambda: shadow_march_plain(sdf, r_o, r_d, mt, **kw), 3))
            b_ms, res["bound_by"] = bound_fn(n, float(evals.sum().item()))
            res["bound_ms"].append(b_ms)
            e = evals.cpu().numpy()
            blocks, slots = fm.shadow_plan(
                n, r_o.device, fm.shadow_info(module, compute_dtype)["slots"])
            res["model_ms"].append(slot_model(
                e, blocks, slots, {r: v for r, v in step_ms.items() if r <= slots},
                min(step_ms))["ms"])
            res["evals"].append(e)
            res["steps"] += st[0]
            res["rows"] += st[1]
            res["live"] += st[2]
            res["agree"] = min(res["agree"], agree)
            res["zero"] += n_zero
            res["zero_blocked"] += z_blocked
            res["blocked"] += int((~pnb).sum().item())
            res["n"] += n
        blocked = res["blocked"] / res["n"]
        check(0.0 < blocked < 1.0,
              f"{name} {label}: blocked fraction {blocked:.4f} not in (0, 1)")
        e = np.concatenate(res.pop("evals"))
        dist = eval_distribution(torch.from_numpy(e))
        res["dist"] = dist
        res["live_row_share"] = res["live"] / max(res["rows"], 1)
        res["evals_per_ms"] = dist["total"] / sum(res["ms"])
        fmt = lambda xs: ", ".join(f"{x:.3f}" for x in xs)
        print(f"{name} at {label}: {len(launches)} launch(es) of {launches[0][0].shape[0]} rays, "
              f"{steps} steps, past-light exit {ple}; SDF evaluations per ray mean "
              f"{dist['mean']:.2f}, median {dist['p50']:.0f}, 99th percentile "
              f"{dist['p99']:.0f}, most {dist['max']}; blocked fraction "
              f"{blocked:.4f}, not-blocked agreement (least) "
              f"{res['agree']:.6f}, zero-direction rays {res['zero']} ({res['zero_blocked']} "
              f"blocked) equal to the plain loop's, bit for bit the same across launches and "
              f"permutations; kernel ms a launch {fmt(res['ms'])}, plain {fmt(res['plain_ms'])}, "
              f"bound {fmt(res['bound_ms'])} ({res['bound_by']}), {res['evals_per_ms']:,.0f} "
              f"evaluations/ms, {res['steps']} tile steps, live share of the rows "
              f"{res['live_row_share']:.3f}; slot_model at this kernel's step ms: "
              f"{fmt(res['model_ms'])}")
        out[label] = res
    return out


# the rows a K4 (K4-bf16) step may evaluate
SHADOW_ROWS = {"f32": (128, 64, 32, 16, 8), "bf16": (128, 64, 32)}


def shadow_step_ms(torch, dev):
    """One K4 (K4-bf16) step's ms by the rows its block evaluates
    (one_block_step_ms on march_surface): {"f32" / "bf16": {rows: ms}}."""
    from neural_raytracing_tpu_torch.kernels import fused_shadow_march
    module = march_surface(torch, dev)
    run = lambda m, o, d, dt: fused_shadow_march(m, o, d, 1e30, max_steps=64, epsilon=-1.0,
                                                 compute_dtype=dt)
    out = {tag: {rows: one_block_step_ms(torch, module, run, rows, dt)
                 for rows in SHADOW_ROWS[tag]}
           for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    print("K4 step ms (f32, bf16) by the rows a block evaluates, one block, 64 steps of "
          "unending rays: f32 " + ", ".join(f"{r} rows {v:.4f}" for r, v in out["f32"].items())
          + "; bf16 " + ", ".join(f"{r} rows {v:.4f}" for r, v in out["bf16"].items()))
    return out


def shadow_entry(res) -> dict:
    """The kernels-line numbers of K4 (K4-bf16) from shadow_shape_report: the
    table's shape (c), and the path's shapes (a) per launch and (b)."""
    c, a, b = res["(c) eval view"], res["(a) eval chunk"], res["(b) training call"]
    return dict(ms=c["ms"][0], plain_ms=c["plain_ms"][0], bound_ms=c["bound_ms"][0],
                bound_by=c["bound_by"], err=float(c["agree"] < 1.0),
                eval_chunk_ms=sum(a["ms"]) / len(a["ms"]),
                eval_chunk_bound_ms=sum(a["bound_ms"]) / len(a["bound_ms"]),
                training_call_ms=b["ms"][0], training_call_bound_ms=b["bound_ms"][0],
                live_row_share=c["live_row_share"], evals_per_ms=c["evals_per_ms"])


def phase_shadow(torch, dev):
    """K4 against shadow_march_plain at the shapes the NeRV paths launch it
    at (shadow_shapes), on the trained checkpoint."""
    from neural_raytracing_tpu_torch.kernels import fused_shadow_march, shadow_info
    module, shapes = shadow_shapes(torch, dev)
    per_eval_flops = 2.0 * mlp_macs(module.shift) + 31.0 * module.n

    def bound(n, n_evals):
        return bound_ms(4 * n * 7 + n + weight_bytes(module.shift) + 4 * 13 * module.n,
                        per_eval_flops * n_evals)

    steps = shadow_step_ms(torch, dev)
    info = shadow_info(module)
    print(f"K4: {info['blocks_per_sm']} blocks per SM of {info['slots']} slots, "
          f"{info['registers']} registers, {info['local_bytes']} bytes of local memory a "
          f"thread, {info['smem_bytes']} bytes of shared memory a block")
    kernel = lambda r_o, r_d, mt, **kw: fused_shadow_march(module, r_o, r_d, mt, **kw)
    res = shadow_shape_report(torch, "K4 fused_shadow_march", module, shapes, kernel,
                              torch.float32, module, bound, steps["f32"])
    return dict(shadow_entry(res), registers=info["registers"],
                local_bytes=info["local_bytes"], shapes=res, step_ms=steps)


# the points K5 is timed at: a NeRV eval chunk (the path's) and N_POINTS
K5_SHAPES = {"NeRV eval chunk": NERV_CHUNK * NERV_CHUNK, "65,536 points": N_POINTS}
K5_PARENT = "general (the parent's kernel)"
K5_ROUTES = {"tile": dict(route="tile"), K5_PARENT: dict(route="general")}


def batch_ms(fn, calls: int = 20):
    """-> a function whose run is ``calls`` back-to-back calls of ``fn``
    (the card stays busy while the host launches the next), for in_turns;
    divide its ms by ``calls``."""
    return lambda: [fn() for _ in range(calls)]


def k5_bound(module, n: int):
    per_point = 2.0 * mlp_macs(module.shift) + 31.0 * module.n
    fixed_bytes = weight_bytes(module.shift) + 4 * 13 * module.n
    return bound_ms(4 * n * 4 + fixed_bytes, n * per_point)


def phase_fused_sdf(torch, dev):
    """K5 against SphereSDF.forward with the trained shape weights, and its
    first and second derivatives against the plain version; on phase 3's
    non-zero surface, the tile's outputs against the general route's
    (digests), and both routes timed in turns at K5_SHAPES."""
    from neural_raytracing_tpu_torch.kernels import (
        FusedSphereSDF, fused_sphere_sdf, k5_route, k5_tile_info, launch_counts,
        reset_launch_counts, route_counts, set_kernel_mode,
    )
    from neural_raytracing_tpu_torch.shapes import SphereSDF
    from neural_raytracing_tpu_torch.training.checkpoint import load_pytree, load_tree_into
    tree = load_pytree(str(ARTIFACTS / "shape.msgpack"))
    fused = load_tree_into(FusedSphereSDF(n=128), tree).to(dev)
    plain = load_tree_into(SphereSDF(n=128), tree).to(dev)
    set_kernel_mode(plain, "off")
    check(k5_route(fused) == "tile", "K5: the NeRV shift net is off the tile")
    gen = torch.Generator().manual_seed(11)
    x = (2.4 * torch.rand(N_POINTS, 3, generator=gen) - 1.2).to(dev)
    reset_launch_counts()
    with torch.no_grad():
        got = fused_sphere_sdf(fused, x)
        want = plain(x)
        torch.cuda.synchronize()
    check(route_counts()["fused_sphere_sdf"] == {"tile": 1, "general": 0},
          f"K5: not one launch on the tile: {route_counts()['fused_sphere_sdf']}")
    err = (got - want).abs()
    tol = 1e-4 * want.abs() + 1e-5 + 4e-7 * (x @ fused.shift.B).abs().max()
    check(bool(torch.isfinite(got).all()), "K5: non-finite output")
    check(bool((err <= tol).all()), f"K5: max |err| {err.max().item():.3e} over tolerance")

    def derivatives(module, pts):
        xx = pts.clone().requires_grad_()
        (gx,) = torch.autograd.grad(module(xx).sum(), xx, create_graph=True)
        params = [module.centers, module.shift.layers[3].w]
        return [gx, *torch.autograd.grad(gx.square().sum(), params)]

    pts = x[:4096]
    worst = 0.0
    for a, b in zip(derivatives(fused, pts), derivatives(plain, pts)):
        e = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        worst = max(worst, e)
    check(worst <= 1e-4, f"K5 derivatives: max |err| / max |plain| {worst:.3e} > 1e-4")
    print(f"K5 fused_sphere_sdf on the trained NeRV surface: {N_POINTS} points on the "
          f"tile, max |err| {err.max().item():.3e}, first and second derivatives max rel "
          f"err {worst:.3e}")

    # phase 3's non-zero shift: the routes' bits, and their times in turns
    surface = FusedSphereSDF(n=128, mlp=flagship_nets()["sdf_shift 8x128 F32"])
    surface.load_state_dict(march_surface(torch, "cpu").state_dict())
    surface.to(dev)
    res = {"info": k5_tile_info(surface)}
    for shape, n in K5_SHAPES.items():
        xs = x[:n].contiguous()
        with torch.no_grad():
            outs = {r: fused_sphere_sdf(surface, xs, **kw) for r, kw in K5_ROUTES.items()}
            want = SphereSDF.forward(surface, xs)
            torch.cuda.synchronize()
            tol = 1e-4 * want.abs() + 1e-5 + 4e-7 * (xs @ surface.shift.B).abs().max()
            for r, o in outs.items():
                check(bool((o - want).abs().le(tol).all()),
                      f"K5 {r} at {n} points: max |err| {(o - want).abs().max().item():.3e}")
            digests = {r: digest(o) for r, o in outs.items()}
            calls = 20
            t = in_turns({r: batch_ms(lambda kw=kw: fused_sphere_sdf(surface, xs, **kw), calls)
                          for r, kw in K5_ROUTES.items()})
            t = {r: ms / calls for r, ms in t.items()}
            prof = kernel_profile(torch, lambda: fused_sphere_sdf(surface, xs))
            plain_ms = cuda_ms(lambda: SphereSDF.forward(surface, xs), 5)
        kernel_ms = sum(ms for key, (ms, _) in prof.items() if "nrt_fused_sdf" in key)
        b_ms, b_by = k5_bound(surface, n)
        same = len(set(digests.values())) == 1
        check(same, f"K5 at {n} points: the routes' bits differ: {digests}")
        res[shape] = dict(times=t, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          kernel_ms=kernel_ms, digests=digests, same_bits=same,
                          err=max((o - want).abs().max().item() for o in outs.values()))
        print(f"K5 at the {shape} ({n} points, phase 3's surface), in turns: " + ", ".join(
            f"{r} {ms:.4f} ms" for r, ms in t.items())
            + f"; the tile kernel's device time {kernel_ms:.4f} ms; plain {plain_ms:.4f} ms; "
            f"bound {b_ms:.4f} ms ({b_by}), share {b_ms / t['tile']:.3f} (the parent's "
            f"kernel {b_ms / t[K5_PARENT]:.3f}); "
            f"{n * (2.0 * mlp_macs(surface.shift) + 31.0 * surface.n) / t['tile'] / 1e9:.1f} "
            f"TFLOP/s; digests {digests} (same bits {same}); max |err| {res[shape]['err']:.3e}")
    print(f"K5 tile kernel: {res['info']}")
    big, path = res["65,536 points"], res["NeRV eval chunk"]
    parent = K5_PARENT
    return dict(ms=big["times"]["tile"], plain_ms=big["plain_ms"], bound_ms=big["bound_ms"],
                bound_by=big["bound_by"], err=max(err.max().item(), big["err"], path["err"]),
                parent_ms=big["times"][parent], path_ms=path["times"]["tile"],
                path_parent_ms=path["times"][parent], path_bound_ms=path["bound_ms"],
                path_kernel_ms=path["kernel_ms"], kernel_ms=big["kernel_ms"],
                same_bits=big["same_bits"] and path["same_bits"],
                blocks_per_sm=res["info"]["blocks_per_sm"], registers=res["info"]["registers"])


def nerv_evaluate(torch, scene, camera_fn, n_views, locs, exp=None):
    """evaluate over ``n_views`` with light_update from ``locs``; -> (metrics,
    images [V, 200, 200, 3] clipped as evaluate saves them, seconds per view)."""
    import numpy as np
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.training import evaluate
    images = []
    if exp is None:
        exp = np.zeros((n_views, NERV_SIZE, NERV_SIZE, 3), np.float32)
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = evaluate(scene, camera_fn, exp[:n_views], Direct(training=False),
                   size=NERV_SIZE, chunk_size=NERV_CHUNK, tone_map=True,
                   with_ms_ssim=NERV_SIZE > 160, log_fn=lambda s: None,
                   light_update=lambda sc, cam, i: sc.lights.set_location(locs[i:i + 1]),
                   save_fn=lambda i, im: images.append(np.asarray(im)))
    torch.cuda.synchronize()
    return out, np.stack(images), (time.perf_counter() - start) / n_views


def compare_images(label, got, want):
    import numpy as np
    mask, pmask = np.abs(got).sum(-1) > 0, np.abs(want).sum(-1) > 0
    agree = (mask == pmask).mean()
    diff = np.abs(got - want)
    check(np.isfinite(got).all() and np.isfinite(want).all(), f"{label}: non-finite image")
    check(pmask.mean() > 0, f"{label}: no pixel lit")
    check(agree >= 0.99, f"{label}: mask agreement {agree:.4f} < 0.99")
    check(diff.mean() <= 1e-3, f"{label}: mean |diff| {diff.mean():.3e} > 1e-3")
    return pmask.mean(), agree, diff.mean(), diff.max()


def phase_nerv_eval(torch, dev):
    """The NeRV test renders, soft and hard shadows, kernels against plain."""
    from neural_raytracing_tpu_torch.kernels import (
        launch_counts, reset_launch_counts, set_kernel_mode,
    )
    camera_fn = lambda i: nerv_camera(torch, NERV_EVAL_VIEWS[i:i + 1])
    counts = {}
    kernel_images = {}
    for occlusion in ("learned", "hard"):
        scene = nerv_scene(torch, dev, 128, 1.2, occlusion)
        locs = scene.lights.location.detach().clone()
        nerv_evaluate(torch, scene, camera_fn, 1, locs)          # warm-up
        reset_launch_counts()
        _, got, s_view = nerv_evaluate(torch, scene, camera_fn, NERV_VIEWS, locs)
        counts[occlusion] = launch_counts()
        k1_routes(f"NeRV eval ({occlusion})")
        check(scene.lights.location.shape == (3, 3), "evaluate changed the light location")
        for name in ("fused_mlp_forward", "fused_march", "fused_shadow_march"):
            check(counts[occlusion][name] > 0,
                  f"NeRV eval ({occlusion}): kernel {name} was not launched on the path")
        if occlusion == "learned":
            from neural_raytracing_tpu_torch.render import pathtrace
            from neural_raytracing_tpu_torch.integrators import Direct

            def one_view():
                scene.lights.set_location(locs[:1])
                pathtrace(scene, camera_fn(0), Direct(training=False), size=NERV_SIZE,
                          chunk_size=NERV_CHUNK, bundle_size=1, background=0.0, key=0,
                          device=dev)
                scene.lights.set_location(locs)
            profile_step(torch, one_view, "one NeRV eval view (learned shadows)")
        set_kernel_mode(scene, "off")
        _, want, p_view = nerv_evaluate(torch, scene, camera_fn, NERV_VIEWS, locs)
        frac, agree, mean_d, max_d = compare_images(f"NeRV eval ({occlusion})", got, want)
        kernel_images[occlusion] = got
        print(f"NeRV eval, {occlusion} shadows: {NERV_VIEWS} views {NERV_SIZE}x{NERV_SIZE}, "
              f"kernels {1e3 * s_view:.1f} ms/view "
              f"({NERV_SIZE ** 2 / s_view:,.0f} rays/s), every kernel off "
              f"{1e3 * p_view:.1f} ms/view; lit fraction {frac:.4f}, mask agreement "
              f"{agree:.6f}, mean |diff| {mean_d:.3e}, max |diff| {max_d:.3e}; "
              f"launches {counts[occlusion]}")
        del scene
    soft, hard = kernel_images["learned"], kernel_images["hard"]
    print(f"NeRV eval: learned against hard shadows, mean |diff| "
          f"{float(abs(soft - hard).mean()):.3e}")
    # the same scene with the surface as FusedSphereSDF: K5 at the normals
    scene = nerv_scene(torch, dev, 128, 1.2, "learned", fused_sdf=True)
    locs = scene.lights.location.detach().clone()
    nerv_evaluate(torch, scene, camera_fn, 1, locs)              # warm-up
    reset_launch_counts()
    _, got, s_view = nerv_evaluate(torch, scene, camera_fn, 1, locs)
    counts["fused_sdf"] = launch_counts()
    k1_routes("NeRV eval (fused_sdf)")
    for name in ("fused_sphere_sdf", "fused_march", "fused_shadow_march"):
        check(counts["fused_sdf"][name] > 0,
              f"NeRV eval (fused_sdf): kernel {name} was not launched on the path")
    frac, agree, mean_d, max_d = compare_images("NeRV eval (fused_sdf)", got, soft[:1])
    print(f"NeRV eval, learned shadows, fused_sdf=True: {1e3 * s_view:.1f} ms/view; "
          f"against the SphereSDF render: mask agreement {agree:.6f}, mean |diff| "
          f"{mean_d:.3e}, max |diff| {max_d:.3e}; launches {counts['fused_sdf']}")
    profile_step(torch, lambda: nerv_evaluate(torch, scene, camera_fn, 1, locs),
                 "one NeRV eval view, learned shadows, fused_sdf=True (K5)")
    return counts


def nerv_gt(torch):
    """Ground truth made here with numpy: 8 views 200x200 at distance 2.2 of
    an analytic diffuse sphere of radius 0.6, each lit by its own point
    light (inverse-square falloff).  -> (c2ws, images, masks, light_locs)."""
    import numpy as np
    from neural_raytracing_tpu_torch.render import _tile_positions
    views = [(e, a) for e in (15.0, 40.0) for a in (0.0, 90.0, 180.0, 270.0)]
    camera = nerv_camera(torch, views, dist=2.2)
    rays = camera.sample_positions(_tile_positions(0.0, 0.0, NERV_SIZE, "cpu"),
                                   size=NERV_SIZE)[..., 0, :].numpy().astype(np.float64)
    r_o, r_d = rays[..., :3], rays[..., 3:]
    rng = np.random.default_rng(8)
    locs = rng.normal(size=(len(views), 3))
    locs = 1.6 * locs / np.linalg.norm(locs, axis=-1, keepdims=True)
    locs = locs + 0.6 * camera.cam_to_world[:, :3, 3].numpy() / 2.2
    b = np.sum(r_o * r_d, -1)
    disc = b * b - (np.sum(r_o * r_o, -1) - 0.6 ** 2)
    mask = disc > 0
    p = r_o + (-b - np.sqrt(np.maximum(disc, 0.0)))[..., None] * r_d
    to_l = locs[:, None, None, :] - p
    d2 = np.sum(to_l * to_l, -1)
    cos = np.clip(np.sum((p / 0.6) * to_l, -1) / np.sqrt(d2), 0.0, 1.0)
    img = mask[..., None] * np.asarray([0.7, 0.5, 0.35]) * (1.5 * cos / d2)[..., None]
    return (camera.cam_to_world.numpy(), img.astype(np.float32),
            mask.astype(np.float32), locs.astype(np.float32))


def phase_nerv_train(torch, dev):
    """NeRV training from the checkpoint: calibration, step parity, 20 steps
    of train with light_update, evaluate in both shadow modes."""
    import copy

    import numpy as np
    from neural_raytracing_tpu_torch.cameras import NeRFCamera
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.kernels import (
        launch_counts, reset_launch_counts, set_kernel_mode,
    )
    from neural_raytracing_tpu_torch.render import _tile_positions
    from neural_raytracing_tpu_torch.training import (
        TrainState, build_step_fn, calibrate_exposure, make_optimizer, rand_uv_mask,
        train,
    )
    from neural_raytracing_tpu_torch.workloads.nerv import eval_scene

    c2ws, imgs, masks, locs = nerv_gt(torch)
    cover = masks.mean(axis=(1, 2))
    print(f"NeRV GT: {len(c2ws)} views {NERV_SIZE}x{NERV_SIZE} of an analytic sphere, one "
          f"point light each, coverage {[round(float(c), 3) for c in cover]}")
    make_camera = lambda idxs: NeRFCamera(torch.from_numpy(c2ws[np.asarray(idxs)]), NERV_FOCAL)
    light_update = lambda sc, cam, idxs: sc.lights.set_location(locs[np.asarray(idxs)])
    spec = make_optimizer(NERV_LRS)
    scene = nerv_scene(torch, dev, 64, None, "learned")   # build_scene(max_steps=64)
    state = TrainState(scene, spec.init(scene), 0)
    state, ratio = calibrate_exposure(scene, state, make_camera, imgs, masks,
                                      size=NERV_SIZE, chunk_size=NERV_CHUNK,
                                      light_update=light_update, log_fn=print)
    print(f"calibrate_exposure: ratio {ratio:.4f}, light scale "
          f"{scene.lights.scale.item():.4f}")

    # step parity: one step from the same state and batch, no jitter
    idxs = [0, 1, 2]
    u = v = (NERV_SIZE - NERV_CROP) // 2
    exp = torch.from_numpy(imgs[idxs, u:u + NERV_CROP, v:v + NERV_CROP]).to(dev)
    mask = torch.from_numpy(masks[idxs, u:u + NERV_CROP, v:v + NERV_CROP]).to(dev)
    rays = make_camera(idxs).to(dev).sample_positions(
        _tile_positions(float(u), float(v), NERV_CROP, dev), size=NERV_SIZE)
    res = {}
    for label, mode in (("kernels", "auto"), ("plain", "off")):
        sc = copy.deepcopy(scene)
        set_kernel_mode(sc, mode)
        light_update(sc, None, idxs)
        step = build_step_fn(sc, Direct(training=True), spec, size=NERV_SIZE,
                             crop_size=NERV_CROP, tone_mapping=True)
        _, aux = step(TrainState(sc, spec.init(sc), 0), make_camera(idxs), (u, v), exp, mask)
        grads = {c: torch.cat([p.grad.reshape(-1) for p in getattr(sc, c).parameters()])
                 for c in ("shape", "bsdf", "lights", "occ")}
        with torch.no_grad():
            _, hit = sc.shape.intersect(rays, primary=False)
        res[label] = (aux["loss"].item(), grads, hit)
        del sc
    (lk, gk, hk), (lp, gp, hp) = res["kernels"], res["plain"]
    rel_loss = abs(lk - lp) / abs(lp)
    n_hit_diff = int((hk != hp).sum().item())
    rel_g = {c: ((gk[c] - gp[c]).norm() / gp[c].norm().clamp_min(1e-30)).item() for c in gk}
    print(f"NeRV step parity (kernels vs every kernel off, no jitter): loss {lk:.6f} vs "
          f"{lp:.6f} (rel {rel_loss:.3e}), rays whose hit differs {n_hit_diff} of "
          f"{hk.numel()} (hit fraction {hp.float().mean().item():.4f}), gradient rel "
          f"L2 {', '.join(f'{c} {e:.3e}' for c, e in rel_g.items())}")
    check(np.isfinite(lk) and rel_loss <= 1e-4, f"NeRV step parity: loss rel {rel_loss:.3e}")
    check(n_hit_diff <= 0.001 * hk.numel(), f"NeRV step parity: {n_hit_diff} hit flags differ")
    check(hp.any().item(), "NeRV step parity: no ray hit the surface")
    for c, e in rel_g.items():
        check(gp[c].norm().item() > 0, f"NeRV step parity: no {c} gradient")
        check(e <= 1e-2, f"NeRV step parity: {c} gradient rel L2 {e:.3e} > 1e-2")
    del res, gk, gp

    kw = dict(size=NERV_SIZE, crop_size=NERV_CROP, n_views=NERV_VIEWS, tone_mapping=True,
              uv_select=rand_uv_mask, light_update=light_update, log_every=0,
              nan_policy="raise")
    gen = torch.Generator(device=dev).manual_seed(1)
    state, _ = train(scene, Direct(training=True), spec, state, make_camera, imgs, masks,
                     gen, iters=2, seed=100, **kw)                   # warm-up
    occ0 = {k: p.detach().clone() for k, p in scene.occ.named_parameters()}
    reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    iters = 20
    state, losses = train(scene, Direct(training=True), spec, state, make_camera, imgs,
                          masks, gen, iters=iters, seed=0, **kw)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - start) / iters
    counts = launch_counts()
    k1_routes("NeRV training")
    check(len(losses) == iters and np.isfinite(losses).all(), f"NeRV training: loss {losses}")
    for name in ("fused_mlp_forward", "fused_march", "fused_min_scan", "fused_shadow_march"):
        check(counts[name] > 0, f"NeRV training: kernel {name} was not launched on the path")
    changed = sum(not torch.equal(occ0[k], p) for k, p in scene.occ.named_parameters())
    check(changed > 0, "NeRV training: no occlusion parameter changed")
    check(scene.lights.location.shape == (NERV_VIEWS, 3), "NeRV training: light location shape")
    print(f"NeRV training (kernels): {iters} steps, {1e3 * secs:.1f} ms/step, "
          f"{NERV_RAYS / secs:,.0f} rays/s, losses {[round(x, 3) for x in losses]}; "
          f"occ parameters changed {changed}; launches {counts}")
    step = build_step_fn(scene, Direct(training=True), spec, size=NERV_SIZE,
                         crop_size=NERV_CROP, tone_mapping=True)
    light_update(scene, None, idxs)
    profile_step(torch, lambda: step(state, make_camera(idxs), (u, v), exp, mask, gen),
                 "one NeRV training step (kernels)")
    camera_fn = lambda i: make_camera([i])
    for occlusion in ("learned", "hard"):
        test = eval_scene(scene, occlusion, 1.2)
        out, _, s_view = nerv_evaluate(torch, test, camera_fn, 2, locs, exp=imgs)
        check(all(np.isfinite(x) for x in out.values()), f"NeRV evaluate: {out}")
        print(f"NeRV evaluate, {occlusion} shadows, 2 GT views (trained {state.step} steps): "
              f"PSNR {out['psnr']:.3f}, SSIM {out['ssim']:.4f}, MS-SSIM "
              f"{out.get('ms_ssim', float('nan')):.4f}, "
              f"{1e3 * s_view:.1f} ms/view")
    return counts, secs


# ---- slice 4: the NeRF-family volume path and the relaxed march --------------------

LE_SIZE = 200
LE_CROP = 16
LE_VIEWS = 4
LE_RAYS = LE_VIEWS * LE_CROP * LE_CROP             # 1,024 rays a step
LE_LR = 5e-4
COMPOSITE_SHAPES = ((64, 10_000), (64, 1_024))     # (samples, rays): eval tile, step
ORBIT_SIZE = 128
ORBIT_FRAMES = 4
OMEGA = 1.4


# ragged K8 shapes (samples, rays): T not a multiple of the segments, T = 1,
# R not a multiple of 32, one ray
COMPOSITE_RAGGED = ((65, 1_000), (1, 33), (7, 1), (100, 31), (17, 64), (64, 10_001))


def composite_inputs(torch, dev, n_t, n_r):
    gen = torch.Generator().manual_seed(12)
    sigma = torch.relu(torch.randn(n_t, n_r, generator=gen)).to(dev)
    rgb = torch.sigmoid(torch.randn(n_t, n_r, 3, generator=gen)).to(dev)
    ts = torch.linspace(0.0, 2.0, n_t).to(dev)
    return sigma, rgb, ts, torch.randn(n_r, 3, generator=gen).to(dev)


def composite_bytes(n_t, n_r) -> int:
    """Each input read once (sigma, rgb, ts), the output written once."""
    return 4 * (n_t * n_r * 4 + n_t + 3 * n_r)


def composite_cold(torch, sigma, rgb, ts, fns: dict, turns: bool = True) -> dict:
    """{name: (device ms a call of fns[name](sigma, rgb, ts), what timed
    it)}: in a render K8 reads what the colour net just wrote, mostly out of
    the 50 MB L2, so each call takes the next of enough input copies (64 MB)
    that it finds its own evicted; a call lasts microseconds, so the device
    time is the profiler's (device_ms); with ``turns`` the functions run
    in turns (a, b, b, a), the median kept."""
    n_bytes = composite_bytes(*sigma.shape)
    copies = [(sigma.clone(), rgb.clone(), ts.clone())
              for _ in range(math.ceil(64 * 2 ** 20 / n_bytes))]
    turn = [0]

    def cold(fn):
        turn[0] = (turn[0] + 1) % len(copies)
        return fn(*copies[turn[0]])

    names = list(fns)
    times = {k: [] for k in names}
    for order in ((names, names[::-1]) if turns else (names,)):
        for k in order:
            times[k].append(device_ms(torch, lambda: cold(fns[k]), 20))
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def phase_composite(torch, dev):
    """K8 against composite_plain at the eval-tile and training shapes and
    the ragged ones (the same bits twice), its autograd.Function's backward
    against autograd through the plain version, and the kernel and the plain
    version timed in turns."""
    from neural_raytracing_tpu_torch.kernels import (
        composite_apply, composite_plain, fused_composite, launch_counts,
        reset_launch_counts,
    )
    for n_t, n_r in COMPOSITE_RAGGED:
        sigma, rgb, ts, _ = composite_inputs(torch, dev, n_t, n_r)
        got, again = fused_composite(sigma, rgb, ts), fused_composite(sigma, rgb, ts)
        want = composite_plain(sigma, rgb, ts)
        err = (got - want).abs()
        check(bool((err <= 2e-5 + 2e-5 * want.abs()).all()),
              f"K8 [{n_t}, {n_r}]: max |err| {err.max().item():.3e} over tolerance")
        check(torch.equal(got, again), f"K8 [{n_t}, {n_r}]: two launches differ")
    reset_launch_counts()
    empty = fused_composite(torch.empty(64, 0, device=dev), torch.empty(64, 0, 3, device=dev),
                            torch.linspace(0.0, 2.0, 64, device=dev))
    check(empty.shape == (0, 3) and launch_counts()["fused_composite"] == 0,
          "K8 with no rays: a launch or a result")
    print(f"K8 at the ragged shapes {COMPOSITE_RAGGED} and no rays: within tolerance, two "
          f"launches the same bits")
    results = {}
    for n_t, n_r in COMPOSITE_SHAPES:
        sigma, rgb, ts, w = composite_inputs(torch, dev, n_t, n_r)
        got = fused_composite(sigma, rgb, ts)
        want = composite_plain(sigma, rgb, ts)
        torch.cuda.synchronize()
        err = (got - want).abs()
        label = f"K8 [{n_t}, {n_r}]"
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
        check(bool((err <= 2e-5 + 2e-5 * want.abs()).all()),
              f"{label}: max |err| {err.max().item():.3e} over tolerance")

        def grads(fn):
            s, c = sigma.clone().requires_grad_(), rgb.clone().requires_grad_()
            (fn(s, c, ts) * w).sum().backward()
            return s.grad, c.grad

        gerr = 0.0
        for a, b in zip(grads(composite_apply), grads(composite_plain)):
            check(bool(((a - b).abs() <= 1e-4 + 1e-3 * b.abs()).all()),
                  f"{label}: gradient off by {(a - b).abs().max().item():.3e}")
            gerr = max(gerr, (a - b).abs().max().item())
        n_bytes = composite_bytes(n_t, n_r)
        t = composite_cold(torch, sigma, rgb, ts, {"kernel": fused_composite,
                                                   "plain": composite_plain})
        ms, ms_by = t["kernel"]
        ev_ms = cuda_ms(batch_ms(lambda: fused_composite(sigma, rgb, ts)), 5) / 20
        # ~14 operations a sample (exp counted as one)
        b_ms, b_by = bound_ms(n_bytes, 14.0 * n_t * n_r)
        print(f"{label}: max |err| {err.max().item():.3e}, gradients max |err| {gerr:.3e}, "
              f"in turns: kernel {ms:.4f} ms, plain {t['plain'][0]:.4f} ms (device time, "
              f"cold inputs, by the {ms_by}); "
              f"warm and back to back by events {ev_ms:.4f} ms a call; bound {b_ms:.4f} ms "
              f"({b_by}), share {b_ms / ms:.3f}, {n_bytes / ms / 1e6:.1f} GB/s")
        results[(n_t, n_r)] = dict(ms=ms, plain_ms=t["plain"][0],
                                   bound_ms=b_ms, bound_by=b_by, err=err.max().item(),
                                   timed_by={"ms": ms_by, "plain_ms": t["plain"][1]})
    tile, step = (results[shape] for shape in COMPOSITE_SHAPES)
    return dict(tile, training_call_ms=step["ms"], training_call_bound_ms=step["bound_ms"])


def colocate_gt(torch):
    """Ground truth made here with numpy: the 8x8 colocated grid (elevation
    0-45, azimuth -135-135, distance 1) at 200x200 of an analytic diffuse
    sphere of radius 0.35, lit by a point light at 1.05 x the camera centre
    (inverse-square falloff).  -> a ColocateDataset."""
    import numpy as np
    from neural_raytracing_tpu_torch.render import _tile_positions
    from neural_raytracing_tpu_torch.training import ColocateDataset
    from neural_raytracing_tpu_torch.workloads.nerfle import colocate_cameras
    elevs = np.repeat(np.linspace(0.0, 45.0, 8), 8).astype(np.float32)
    azims = np.tile(np.linspace(-135.0, 135.0, 8), 8).astype(np.float32)
    cams = colocate_cameras(ColocateDataset(None, None, elevs, azims, 1.0))
    rays = cams.sample_positions(_tile_positions(0.0, 0.0, LE_SIZE, "cpu"),
                                 size=LE_SIZE)[..., 0, :].numpy().astype(np.float64)
    r_o, r_d = rays[..., :3], rays[..., 3:]
    b = np.sum(r_o * r_d, -1)
    disc = b * b - (np.sum(r_o * r_o, -1) - 0.35 ** 2)
    mask = disc > 0
    p = r_o + (-b - np.sqrt(np.maximum(disc, 0.0)))[..., None] * r_d
    light = 1.05 * cams.camera_center().numpy().astype(np.float64)[:, None, None, :]
    to_l = light - p
    d2 = np.sum(to_l * to_l, -1)
    cos = np.clip(np.sum((p / 0.35) * to_l, -1) / np.sqrt(d2), 0.0, 1.0)
    img = mask[..., None] * np.asarray([0.75, 0.55, 0.4]) * (0.45 * cos / d2)[..., None]
    return ColocateDataset(img.astype(np.float32), mask.astype(np.float32), elevs,
                           azims, 1.0)


def nerfle_scene(torch, dev, envmap=False):
    from neural_raytracing_tpu_torch.workloads.nerfle import build_scene
    return build_scene(envmap=envmap).init(torch.Generator().manual_seed(0), device=dev)


def nerfle_eval(torch, scene, cams, images):
    """-> (images [V, 200, 200, 3] as the twin's evaluate saves them, metrics,
    seconds per view)."""
    import numpy as np
    from neural_raytracing_tpu_torch.workloads.nerfle import evaluate
    out = []
    torch.cuda.synchronize()
    start = time.perf_counter()
    metrics = evaluate(scene, cams, images, size=LE_SIZE, log_fn=lambda s: None,
                       save_fn=lambda i, im: out.append(np.asarray(im)))
    torch.cuda.synchronize()
    return np.stack(out), metrics, (time.perf_counter() - start) / len(images)


def phase_nerfle_eval(torch, dev, data):
    """The NeRFLE eval at full width: K8 against fused="off", envmap, profile."""
    import numpy as np
    from neural_raytracing_tpu_torch.kernels import (
        launch_counts, reset_launch_counts, set_kernel_mode,
    )
    from neural_raytracing_tpu_torch.workloads.nerfle import colocate_cameras
    cams = colocate_cameras(data)
    scene = nerfle_scene(torch, dev)
    nerfle_eval(torch, scene, cams, data.images[:1])              # warm-up
    reset_launch_counts()
    got, metrics, s_view = nerfle_eval(torch, scene, cams, data.images[:2])
    counts = launch_counts()
    check(counts["fused_composite"] > 0, "NeRFLE eval: K8 was not launched on the path")
    profile_step(torch, lambda: nerfle_eval(torch, scene, cams, data.images[:1]),
                 "one NeRFLE eval view (K8)")
    set_kernel_mode(scene, "off")
    reset_launch_counts()
    want, _, p_view = nerfle_eval(torch, scene, cams, data.images[:2])
    check(launch_counts()["fused_composite"] == 0, "NeRFLE eval: K8 launched with fused='off'")
    diff = np.abs(got - want)
    check(np.isfinite(got).all() and np.isfinite(want).all(), "NeRFLE eval: non-finite image")
    check(want.max() > 0.0, "NeRFLE eval: black image")
    check(diff.mean() <= 1e-5 and diff.max() <= 1e-4,
          f"NeRFLE eval: K8 against off mean |diff| {diff.mean():.3e}, max {diff.max():.3e}")
    print(f"NeRFLE eval: 2 views {LE_SIZE}x{LE_SIZE}, 64 samples a ray, K8 {1e3 * s_view:.1f} "
          f"ms/view ({LE_SIZE ** 2 / s_view:,.0f} rays/s), fused='off' {1e3 * p_view:.1f} "
          f"ms/view; mean |diff| {diff.mean():.3e}, max |diff| {diff.max():.3e}; PSNR "
          f"against the sphere GT {metrics['psnr']:.3f} (random weights); launches {counts}")
    del scene
    env = nerfle_scene(torch, dev, envmap=True)
    nerfle_eval(torch, env, cams, data.images[:1])                # warm-up
    reset_launch_counts()
    img, _, e_view = nerfle_eval(torch, env, cams, data.images[:1])
    check(launch_counts()["fused_composite"] > 0, "NeRFLE envmap: K8 was not launched")
    check(np.isfinite(img).all() and img.max() > 0.0, "NeRFLE envmap: bad image")
    print(f"NeRFLE eval, envmap=True: 1 view, {1e3 * e_view:.1f} ms/view, mean pixel "
          f"{img.mean():.4f}")
    return counts


def phase_nerfle_train(torch, dev, data):
    """The NeRFLE MSE step: K8 against off from the same state, 20 steps of
    the twin's loop, a profile of one step."""
    import copy

    import numpy as np
    from neural_raytracing_tpu_torch.cameras import FoVPerspectiveCamera
    from neural_raytracing_tpu_torch.kernels import (
        launch_counts, reset_launch_counts, set_kernel_mode,
    )
    from neural_raytracing_tpu_torch.training import make_optimizer
    from neural_raytracing_tpu_torch.workloads.nerfle import (
        build_step, colocate_cameras, train,
    )
    cams = colocate_cameras(data)
    cover = data.masks.mean(axis=(1, 2))
    print(f"NeRFLE GT: {len(cover)} views {LE_SIZE}x{LE_SIZE} of an analytic sphere under "
          f"the colocated light, coverage {cover.min():.3f}-{cover.max():.3f}")
    spec = make_optimizer({"shape": LE_LR, "lights": LE_LR})
    scene = nerfle_scene(torch, dev)
    idxs = torch.tensor([0, 19, 38, 57])
    u = v = (LE_SIZE - LE_CROP) // 2
    exp = torch.from_numpy(data.images[idxs.numpy(), u:u + LE_CROP, v:v + LE_CROP]).to(dev)
    camera = FoVPerspectiveCamera(R=cams.R[idxs], T=cams.T[idxs])
    res = {}
    for label, mode in (("kernels", "auto"), ("plain", "off")):
        sc = copy.deepcopy(scene)
        set_kernel_mode(sc, mode)
        sc.lights.set_location(cams.camera_center()[idxs] * 1.05)
        loss = build_step(sc, spec.init(sc), size=LE_SIZE, crop_size=LE_CROP)(
            camera, (u, v), exp)
        grads = {c: torch.cat([p.grad.reshape(-1) for p in getattr(sc, c).parameters()
                               if p.grad is not None]) for c in ("shape", "lights")}
        res[label] = (loss.item(), grads)
        del sc
    (lk, gk), (lp, gp) = res["kernels"], res["plain"]
    rel_loss = abs(lk - lp) / abs(lp)
    rel_g = {c: ((gk[c] - gp[c]).norm() / gp[c].norm().clamp_min(1e-30)).item() for c in gk}
    print(f"NeRFLE step parity (K8 vs off): loss {lk:.7f} vs {lp:.7f} (rel {rel_loss:.3e}), "
          f"gradient rel L2 {', '.join(f'{c} {e:.3e}' for c, e in rel_g.items())}")
    check(np.isfinite(lk) and rel_loss <= 1e-5, f"NeRFLE step: loss rel {rel_loss:.3e}")
    for c, e in rel_g.items():
        check(gp[c].norm().item() > 0, f"NeRFLE step: no {c} gradient")
        check(e <= 1e-4, f"NeRFLE step: {c} gradient rel L2 {e:.3e} > 1e-4")

    optimizer = spec.init(scene)
    gen = torch.Generator(device=dev).manual_seed(1)
    kw = dict(size=LE_SIZE, crop_size=LE_CROP, n_views=LE_VIEWS, generator=gen,
              log_every=0)
    train(scene, optimizer, cams, data.images, iters=2, seed=100, **kw)   # warm-up
    before = {k: p.detach().clone() for k, p in scene.named_parameters()}
    reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    iters = 20
    losses = train(scene, optimizer, cams, data.images, iters=iters, seed=0, **kw)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - start) / iters
    counts = launch_counts()
    check(len(losses) == iters and np.isfinite(losses).all(), f"NeRFLE training: {losses}")
    check(counts["fused_composite"] > 0, "NeRFLE training: K8 was not launched on the path")
    changed = sum(not torch.equal(before[k], p) for k, p in scene.named_parameters())
    check(changed > 0, "NeRFLE training: no parameter changed")
    print(f"NeRFLE training (K8): {iters} steps, {1e3 * secs:.1f} ms/step, "
          f"{LE_RAYS / secs:,.0f} rays/s, losses {[round(x, 5) for x in losses]}; "
          f"parameters changed {changed}; launches {counts}")
    step = build_step(scene, optimizer, size=LE_SIZE, crop_size=LE_CROP)
    profile_step(torch, lambda: step(camera, (u, v), exp, gen), "one NeRFLE training step (K8)")
    return counts, secs


def phase_relaxed_march(torch, dev):
    """K2 relaxed against the relaxed march_plain on the NeRV checkpoint's
    orbit rays, then the orbit renderer at omega 1.4 and 1.0."""
    import tempfile

    import numpy as np
    from neural_raytracing_tpu_torch.kernels import (
        fused_march, launch_counts, march_plain, reset_launch_counts, set_kernel_mode,
    )
    from neural_raytracing_tpu_torch.render import _tile_positions
    from neural_raytracing_tpu_torch.shapes import march_interval
    from neural_raytracing_tpu_torch.workloads import render

    scene = nerv_scene(torch, dev, 128, None, "learned")
    module = scene.shape.module
    set_kernel_mode(scene, "off")      # the plain march evaluates the plain shift
    rays = torch.cat([render.frame_camera(f, ORBIT_FRAMES, 1.0, 20.0).to(dev).sample_positions(
        _tile_positions(0.0, 0.0, ORBIT_SIZE, dev), size=ORBIT_SIZE).reshape(-1, 6)
        for f in range(ORBIT_FRAMES)])
    r_o, r_d = rays[:, :3].contiguous(), rays[:, 3:].contiguous()
    n = r_o.shape[0]
    per_eval_flops = 2.0 * mlp_macs(module.shift) + 31.0 * module.n
    results = {}
    for label, bound in (("unbounded", None), ("bounded", 1.2)):
        t0, t1 = (None, 10.0) if bound is None else march_interval(r_o, r_d, bound, 10.0)

        def kernel(omega=OMEGA):
            return fused_march(module, r_o, r_d, t1, max_steps=128, epsilon=1e-3,
                               t_start=t0, omega=omega)

        def plain(omega=OMEGA):
            return march_plain(module, r_o, r_d, t1, t0, max_steps=128, epsilon=1e-3,
                               omega=omega)

        depth, hit = kernel()
        pdepth, phit, evals = plain()
        evals1 = plain(1.0)[2]
        torch.cuda.synchronize()
        agree = (hit == phit).float().mean().item()
        both = hit & phit
        derr = (depth - pdepth)[both].abs().max().item() if both.any() else 0.0
        frac = phit.float().mean().item()
        check(0.0 < frac < 1.0, f"K2 relaxed {label}: hit fraction {frac:.4f}")
        check(agree >= 0.99, f"K2 relaxed {label}: hit agreement {agree:.4f} < 0.99")
        check(derr <= 1e-3, f"K2 relaxed {label}: max |depth err| {derr:.3e} > 1e-3")
        ms = cuda_ms(kernel, 5)
        ms1 = cuda_ms(lambda: kernel(1.0), 5)
        plain_ms = cuda_ms(plain, 3)
        n_evals, n_evals1 = evals.sum().item(), evals1.sum().item()
        n_bytes = 4 * n * (6 + (2 if bound else 0)) + 5 * n \
            + weight_bytes(module.shift) + 4 * 13 * module.n
        b_ms, b_by = bound_ms(n_bytes, per_eval_flops * n_evals)
        print(f"K2 relaxed (omega {OMEGA}), {label}, {n} orbit rays, 128 steps: hit fraction "
              f"{frac:.4f}, agreement {agree:.6f}, max |depth err| {derr:.3e}; SDF "
              f"evaluations per ray {n_evals / n:.2f} (omega 1.0: {n_evals1 / n:.2f}); kernel "
              f"{ms:.3f} ms (omega 1.0: {ms1:.3f} ms), plain {plain_ms:.3f} ms, bound "
              f"{b_ms:.3f} ms ({b_by})")
        results[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                              err=derr)
    del scene
    with tempfile.TemporaryDirectory() as out:
        args = ["--workload", "nerv", "--models", str(ARTIFACTS), "--size", str(ORBIT_SIZE),
                "--dist", "1.0", "--elev", "20", "--device", str(dev), "--outputs", out]
        render.main(args + ["--frames", "1", "--omega", str(OMEGA)])       # warm-up
        frames, secs = {}, {}
        for omega in (OMEGA, 1.0):
            reset_launch_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            frames[omega] = render.main(args + ["--frames", str(ORBIT_FRAMES),
                                                "--omega", str(omega)])
            torch.cuda.synchronize()
            secs[omega] = (time.perf_counter() - start) / ORBIT_FRAMES
            if omega == OMEGA:
                counts = launch_counts()
                k1_routes("orbit render")
    check(counts["fused_march"] > 0, "orbit render: K2 was not launched on the path")
    check(all(np.isfinite(f).all() for f in frames.values()), "orbit render: non-finite")
    diff = np.abs(frames[OMEGA] - frames[1.0])
    print(f"orbit render (workloads.render.main, {ORBIT_FRAMES} frames {ORBIT_SIZE}x{ORBIT_SIZE}, "
          f"bundle 4): omega {OMEGA} {1e3 * secs[OMEGA]:.1f} ms/frame, omega 1.0 "
          f"{1e3 * secs[1.0]:.1f} ms/frame (scene build and load included); mean |diff| "
          f"{diff.mean():.3e}, max |diff| {diff.max():.3e}; lit fraction "
          f"{(frames[1.0].sum(-1) > 0).mean():.4f}; launches {counts}")
    return results["unbounded"], counts

# ---- slice 5: the bf16-operand variants of K1-K4 and the mixed-precision paths ------

BF16_NETS = ("weight_net 16x256 F128", "lobe 6x96 F64", "light_field 10x256 F16")


def bf16_bounds(n_bytes, macs, sphere_flops=0.0):
    """-> (the tensor-core bound ms, "bytes"/"operations", the f32-FMA bound
    ms) of work with ``macs`` bf16 multiply-adds on the tensor cores and
    ``sphere_flops`` float32 operations beside them."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = max(2.0 * macs / PEAK_BF16, sphere_flops / PEAK_F32)
    f32_ms, _ = bound_ms(n_bytes, 2.0 * macs + sphere_flops)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations"), f32_ms


# the H100 SXM's special-function units: 16 operations per clock per SM, 132
# SMs at the 1.98 GHz boost clock of the f32 peak above; the other f32
# operations issue at half the f32 flop rate (an FMA counts two flops)
PEAK_SFU = 132 * 16 * 1.98e9
PEAK_F32_OPS = PEAK_F32 / 2


def scan_elementwise_ms(module) -> float:
    """Milliseconds per sample of K3-bf16's work beside the tensor cores, counted
    from the code: each softplus ((L + 1) x hidden outputs and act(enc)) an
    exp and a log1p on the SFU plus 4 other f32 operations (|x|, negate,
    max, add), a sin and a cos per frequency, a sqrt and an exp per sphere
    beside its 31 f32 operations; the larger of the SFU's and the f32
    pipe's time (the floor, whatever the products cost)."""
    mlp = module.shift
    n_act = (mlp.num_layers + 1) * mlp.hidden_size + mlp.enc_size
    sfu = 2 * n_act + 2 * mlp.freqs + 2 * module.n
    f32 = 4 * n_act + 31 * module.n + 6 * mlp.freqs
    return 1e3 * max(sfu / PEAK_SFU, f32 / PEAK_F32_OPS)


def check_k1_bf16(label, got, want, got_f32, want_f32):
    """K1-bf16 against its plain version.  A float32 difference (x.B by fmaf
    against a matmul, sums in another order) can tip a bf16 rounding, which
    moves that operand by one bf16 step and its row from there on: half of
    the rows within K1's tolerance, the mean error below a quarter of the
    mean |bf16 - f32| of the plain versions, and the kernel at least half of
    that away from the f32 kernel (not silently f32)."""
    import torch
    err = (got - want).abs()
    rows_ok = (err <= 1e-4 * want.abs() + 1e-5).all(dim=-1).float().mean().item()
    gap = (want - want_f32).abs().mean().item()
    moved = (got - got_f32).abs().mean().item()
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    check(rows_ok >= 0.5, f"{label}: {rows_ok:.4f} of the rows within K1's tolerance < 0.5")
    check(err.mean().item() <= 0.25 * gap,
          f"{label}: mean |err| {err.mean().item():.3e} > 0.25 x bf16-f32 gap {gap:.3e}")
    check(moved >= 0.5 * gap, f"{label}: bf16 kernel within {moved:.3e} of the f32 kernel "
          f"(bf16-f32 gap {gap:.3e}): it ran in f32")
    return dict(rows_ok=rows_ok, max_err=err.max().item(), mean_err=err.mean().item(),
                gap=gap, moved=moved)


def bf16_k1(torch, dev) -> dict:
    """Phase 16's K1-bf16: k1_net_report on BF16_NETS, beside the f32 tile on
    the same points, and its totals."""
    from neural_raytracing_tpu_torch.kernels import fused_mlp_forward
    gen = torch.Generator().manual_seed(1)
    nets = flagship_nets()
    reports = {}
    for name in BF16_NETS:
        mlp = nets[name]
        mlp.reset_parameters(gen)
        mlp.to(dev)
        x = (torch.rand(N_POINTS, 3, generator=gen) - 0.5).to(dev)
        reports[name] = k1_net_report(torch, name, mlp, torch.bfloat16, x)
        ws = [w.detach() for w in mlp.flat_weights()]
        with torch.no_grad():
            reports[name]["f32_ms"] = cuda_ms(lambda: fused_mlp_forward(mlp, x, mlp.B, ws), 5)
        mlp.cpu()
    tot = k1_totals(reports, list(BF16_NETS))
    tot["f32_ms"] = sum(r["f32_ms"] for r in reports.values())
    print(f"K1-bf16, 3 nets: tile {tot['ms']:.3f} ms (f32 tile {tot['f32_ms']:.3f} ms), "
          f"parent's kernel {tot['parent_ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, bound "
          f"{tot['bound_ms']:.4f} ms (tensor cores {tot['tensor_core_bound_ms']:.4f}, "
          f"elementwise floor {tot['elementwise_floor_ms']:.4f}), f32-FMA bound "
          f"{tot['f32_bound_ms']:.3f} ms; one eval tile's 10 launches {tot['eval_tile_ms']:.3f} "
          f"ms, parent's kernel {tot['eval_tile_parent_ms']:.3f} ms")
    return tot


def phase_bf16_kernels(torch, dev, k4_steps):
    """K1-bf16 on three flagship nets, K2-bf16 (bounded, unbounded, omega 1.4)
    and K3-bf16 on phase 3's non-zero surface, K4-bf16 at phase 8's shapes
    on the trained NeRV checkpoint (``k4_steps``: phase 8's step ms by rows,
    for its schedule model): each against its plain version, beside its f32
    kernel on the same inputs."""
    from neural_raytracing_tpu_torch.kernels import (
        fused_march, fused_march_bf16, fused_mlp_forward, fused_shadow_march,
        fused_shadow_march_bf16, march_plain, set_kernel_mode, sphere_sdf_eval_plain,
    )
    from neural_raytracing_tpu_torch.shapes import march_interval

    bf16 = torch.bfloat16
    out = {}
    out["k1"] = bf16_k1(torch, dev)

    # K2-bf16 on phase 3's rays and its non-zero surface
    module = march_surface(torch, dev)
    set_kernel_mode(module, "off")
    sdf16 = lambda p: sphere_sdf_eval_plain(module, p, bf16)
    rays = view_rays(torch, dev)
    r_o, r_d = rays[:, :3].contiguous(), rays[:, 3:].contiguous()
    macs_eval, sph_eval = float(mlp_macs(module.shift)), 31.0 * module.n
    for label, steps, bound, omega in (("bounded", 256, 1.2, 1.0),
                                       ("unbounded", 64, None, 1.0),
                                       ("relaxed", 256, 1.2, 1.4)):
        t0, t1 = (None, 10.0) if bound is None else march_interval(r_o, r_d, bound, 10.0)
        kw = dict(max_steps=steps, epsilon=1e-3, t_start=t0, omega=omega)
        kernel = lambda: fused_march_bf16(module, r_o, r_d, t1, **kw)
        kernel32 = lambda: fused_march(module, r_o, r_d, t1, **kw)
        plain = lambda: march_plain(sdf16, r_o, r_d, t1, t0, max_steps=steps,
                                    epsilon=1e-3, omega=omega)
        depth, hit = kernel()
        depth32, hit32 = kernel32()
        pdepth, phit, evals = plain()
        evals32 = march_plain(module, r_o, r_d, t1, t0, max_steps=steps, epsilon=1e-3,
                              omega=omega)[2]
        torch.cuda.synchronize()
        agree = (hit == phit).float().mean().item()
        both = hit & phit
        check(bool(both.any()), f"K2-bf16 {label}: no ray hit")
        errs = (depth - pdepth)[both].abs()
        derr, close = errs.max().item(), (errs <= 1e-3).float().mean().item()
        near = (errs <= 1e-2).float().mean().item()
        moved = (depth - depth32).abs().max().item()
        check(agree >= 0.99, f"K2-bf16 {label}: hit agreement {agree:.4f} < 0.99")
        check(close >= 0.99 and near >= 0.999, f"K2-bf16 {label}: |depth err| <= 1e-3 on "
              f"{close:.4f} and <= 1e-2 on {near:.5f} of the common hits")
        check(moved > 1e-5 or bool((hit != hit32).any()),
              f"K2-bf16 {label}: depths within {moved:.3e} of the f32 kernel: it ran in f32")

        def run(stats, perm, t0=t0, t1=t1, kw=kw):
            p = slice(None) if perm is None else perm
            return fused_march_bf16(module, r_o[p].contiguous(), r_d[p].contiguous(),
                                    t1 if t0 is None else t1[p].contiguous(),
                                    **dict(kw, t_start=None if t0 is None else t0[p].contiguous()),
                                    stats=stats)

        rep = march_kernel_report(torch, module, bf16, run, N_POINTS)
        check(rep["bitwise_same"], f"K2-bf16 {label}: depths differ between launches or "
              "under a permutation of the rays")
        ms = cuda_ms(kernel, 5)
        ms32 = cuda_ms(kernel32, 5)
        plain_ms = cuda_ms(plain, 2)
        n_evals = evals.sum().item()
        n_bytes = 4 * N_POINTS * (6 + (2 if bound else 0)) + 5 * N_POINTS \
            + weight_bytes(module.shift) + 4 * 13 * module.n
        tc_ms, b_by, f32_b = bf16_bounds(n_bytes, macs_eval * n_evals, sph_eval * n_evals)
        floor_ms = n_evals * scan_elementwise_ms(module)
        b_ms = max(tc_ms, floor_ms)
        print(f"K2-bf16 {label} ({steps} steps, omega {omega}): hit agreement {agree:.6f}, "
              f"|depth err| <= 1e-3 on {close:.6f} of the common hits, max {derr:.3e}; against the f32 kernel: max |depth diff| "
              f"{moved:.3e}, hit flags differ {int((hit != hit32).sum().item())}; "
              f"evaluations per ray {n_evals / N_POINTS:.2f} (f32 "
              f"{evals32.sum().item() / N_POINTS:.2f}); kernel {ms:.3f} ms (f32 kernel "
              f"{ms32:.3f} ms), {n_evals / ms:,.0f} evaluations/ms, plain {plain_ms:.3f} ms, "
              f"bound {b_ms:.3f} ms: the larger of the bf16 tensor-core bound {tc_ms:.3f} ms "
              f"and the elementwise floor {floor_ms:.3f} ms (f32-FMA bound {f32_b:.3f} ms); "
              f"{march_kernel_line(rep)}")
        out[f"k2 {label}"] = dict(ms=ms, f32_ms=ms32, plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by, f32_bound_ms=f32_b, err=derr,
                                  tensor_core_bound_ms=tc_ms, elementwise_floor_ms=floor_ms,
                                  evals_per_ms=n_evals / ms,
                                  **{k: rep[k] for k in ("blocks_per_sm", "registers",
                                                         "local_bytes", "live_row_share")})

    out["k3"] = bf16_minscan(torch, dev, module)
    del module

    # K4-bf16 at phase 8's shapes on the trained checkpoint, beside K4
    module, shapes = shadow_shapes(torch, dev)
    sdf16 = lambda p: sphere_sdf_eval_plain(module, p, bf16)
    n_bytes = lambda n: 4 * n * 7 + n + weight_bytes(module.shift) + 4 * 13 * module.n

    def bound16(n, n_evals):
        tc_ms, b_by, _ = bf16_bounds(n_bytes(n), macs_eval * n_evals, sph_eval * n_evals)
        return max(tc_ms, n_evals * scan_elementwise_ms(module)), b_by

    kernel = lambda r_o, r_d, mt, **kw: fused_shadow_march_bf16(module, r_o, r_d, mt, **kw)
    res = shadow_shape_report(torch, "K4-bf16 fused_shadow_march_bf16", module, shapes, kernel,
                              bf16, sdf16, bound16, k4_steps["bf16"])
    _, launches, steps, ple = shapes[2]                       # (c), the table's shape
    r_o, r_d, dist, _ = launches[0]
    kw = dict(max_steps=steps, epsilon=1e-3, past_light_exit=ple)
    nb, nb32 = kernel(r_o, r_d, dist, **kw), fused_shadow_march(module, r_o, r_d, dist, **kw)
    ms32 = cuda_ms(lambda: fused_shadow_march(module, r_o, r_d, dist, **kw), 5)
    n_evals = float(res["(c) eval view"]["dist"]["total"])
    tc_ms, _, f32_b = bf16_bounds(n_bytes(r_o.shape[0]), macs_eval * n_evals,
                                  sph_eval * n_evals)
    with torch.no_grad():
        spread = module.shift(r_o).std().item()
    print(f"K4-bf16 at (c): flags that differ from the f32 kernel's "
          f"{int((nb != nb32).sum().item())} (the checkpoint's shift output spreads by "
          f"{spread:.2e} over the rays' origins); f32 kernel {ms32:.3f} ms; bound: the larger "
          f"of the bf16 tensor-core bound {tc_ms:.3f} ms and the elementwise floor "
          f"{n_evals * scan_elementwise_ms(module):.3f} ms (f32-FMA bound {f32_b:.3f} ms)")
    out["k4"] = dict(shadow_entry(res), f32_ms=ms32, f32_bound_ms=f32_b,
                     tensor_core_bound_ms=tc_ms,
                     elementwise_floor_ms=n_evals * scan_elementwise_ms(module), shapes=res)
    del module, shapes
    n_moved, n_probe = k4_bf16_probe(torch, march_surface(torch, dev))
    check(n_moved > 0, f"K4-bf16: on all {n_probe} probe rays the flags equal the f32 "
          "kernel's: it ran in f32")
    print(f"K4-bf16 probe on phase 3's non-zero surface: {n_moved} of {n_probe} flags differ "
          f"from the f32 kernel's")
    return out


def bf16_minscan(torch, dev, module):
    """K3-bf16 at phase 5's shapes on ``module`` (phase 3's non-zero
    surface), against min_scan_plain over the bf16 SDF and beside K3."""
    from neural_raytracing_tpu_torch.kernels import (
        fused_min_scan, fused_min_scan_bf16, min_scan_blocks_per_sm, min_scan_plain,
        sphere_sdf_eval_plain,
    )
    bf16 = torch.bfloat16
    sdf16 = lambda p: sphere_sdf_eval_plain(module, p, bf16)
    macs_eval, sph_eval = float(mlp_macs(module.shift)), 31.0 * module.n
    r_o, r_d = scan_rays(torch, dev)
    steps, step = 128, 2.2 / 128
    kernel = lambda: fused_min_scan_bf16(module, r_o, r_d, step, steps=steps)
    kernel32 = lambda: fused_min_scan(module, r_o, r_d, step, steps=steps)
    plain = lambda: min_scan_plain(sdf16, r_o, r_d, step, steps=steps)
    idx, idx32, pidx = kernel(), kernel32(), plain()
    torch.cuda.synchronize()
    agree, err, n_differ = check_scan(torch, "K3-bf16", module, sdf16, r_o, r_d, step,
                                      steps, idx, pidx, 0.99, 1e-3)
    n_moved = int((idx != idx32).sum().item())
    check(n_moved > 0, "K3-bf16: every index equals the f32 kernel's: it ran in f32")
    ms, ms32, plain_ms = cuda_ms(kernel, 5), cuda_ms(kernel32, 5), cuda_ms(plain, 2)
    n_evals = float(N_RAYS) * (steps + 1)
    tc_ms, b_by, f32_b = bf16_bounds(4 * N_RAYS * 7 + weight_bytes(module.shift)
                                     + 4 * 13 * module.n, macs_eval * n_evals,
                                     sph_eval * n_evals)
    floor_ms = n_evals * scan_elementwise_ms(module)
    b_ms = max(tc_ms, floor_ms)
    cheap = cheap_activation_twin(module)
    cheap_ms = cuda_ms(lambda: fused_min_scan_bf16(cheap, r_o, r_d, step, steps=steps), 5)
    h_o, h_d = scan_rays(torch, dev, half_res=True)
    half_ms = cuda_ms(lambda: fused_min_scan_bf16(module, h_o, h_d, step, steps=steps), 5)
    segs, one = segment_split(torch, module, fused_min_scan_bf16,
                              [(r_o, r_d), (h_o, h_d)], bf16)
    half_b = b_ms * h_o.shape[0] / N_RAYS
    blocks = min_scan_blocks_per_sm(module, bf16)
    flops = 2.0 * macs_eval * n_evals
    print(f"K3-bf16 fused_min_scan_bf16: {N_RAYS} rays x {steps + 1} samples, index "
          f"agreement {agree:.6f} ({n_differ} indices differ from min_scan_plain), max |sd "
          f"difference| {err:.3e}; indices that differ from the f32 kernel's {n_moved}; "
          f"kernel {ms:.3f} ms (f32 kernel {ms32:.3f} ms; before the redesign: "
          f"{K3_PREV_MS['bf16']} ms), plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms: the "
          f"larger of the bf16 tensor-core bound {tc_ms:.3f} ms and the elementwise floor "
          f"{floor_ms:.3f} ms (f32-FMA bound {f32_b:.3f} ms); {flops / ms / 1e9:.1f} "
          f"TFLOP/s of products, {b_ms / ms:.3f} of the bound; {blocks} blocks per SM; "
          f"half-res {h_o.shape[0]} rays {half_ms:.3f} ms, bound {half_b:.3f} ms, "
          f"{half_b / half_ms:.3f} of the bound; the same widths with a leaky_relu shift "
          f"{cheap_ms:.3f} ms (the softplus epilogue's cost: {ms - cheap_ms:.3f} ms); "
          f"sample segments {segs[0]} and {segs[1]}, with one segment a ray instead "
          f"{one[0]:.3f} and {one[1]:.3f} ms")
    return dict(ms=ms, f32_ms=ms32, plain_ms=plain_ms, bound_ms=b_ms,
                segments=segs[0], one_segment_ms=one[0], half_res_one_segment_ms=one[1],
                bound_by="operations", f32_bound_ms=f32_b, tensor_core_bound_ms=tc_ms,
                elementwise_floor_ms=floor_ms, err=err,
                half_res_ms=half_ms, half_res_bound_ms=half_b, blocks_per_sm=blocks,
                indices_differ=n_differ)


def k4_bf16_probe(torch, module):
    """K4's flag reads one SDF value at float32 resolution: a ray that starts
    inside the surface (sd < eps at its first point p) hits on its one step
    and advances to 1e2 eps + sd(p), so with max_t = 1e2 eps + sd32(p) - 1e-5
    the f32 kernel says not-blocked on every such ray, and a kernel whose SDF
    moved by more than 1e-5 (bf16 operands) says blocked on some.  The same
    points with a zero direction are blocked in both kernels.
    -> (rays where K4-bf16's flag differs from K4's, probe rays)."""
    from neural_raytracing_tpu_torch.kernels import (
        fused_shadow_march, fused_shadow_march_bf16, shadow_march_plain,
        sphere_sdf_eval_plain,
    )
    dev = module.centers.device
    gen = torch.Generator().manual_seed(17)
    p = (0.6 * torch.rand(40_000, 3, generator=gen) - 0.3).to(dev)
    d = torch.nn.functional.normalize(torch.randn(40_000, 3, generator=gen), dim=-1).to(dev)
    sd = sphere_sdf_eval_plain(module, p)
    inside = sd < 1e-3 - 1e-4
    p, d, sd = p[inside], d[inside], sd[inside]
    depth0 = 1e2 * 1e-3
    r_o = (p - d * depth0).contiguous()
    max_t = depth0 + sd - 1e-5
    kw = dict(max_steps=1, epsilon=1e-3, past_light_exit=False)
    nb32 = fused_shadow_march(module, r_o, d, max_t, **kw)
    nb = fused_shadow_march_bf16(module, r_o, d, max_t, **kw)
    check(bool(nb32.all()), "K4 probe: the f32 kernel's depths are not the plain version's")
    # zero-direction rays at the same points (sd < eps there): blocked after
    # their one evaluation, as the plain loop says, whatever max_steps
    # (K4-bf16 as its plain loop over the bf16 SDF, which may tip near eps)
    zero, kw = torch.zeros_like(r_o), dict(max_steps=64, epsilon=1e-3)
    check(not bool(fused_shadow_march(module, p.contiguous(), zero, 10.0, **kw).any()),
          "K4 probe: a zero-direction ray inside the surface was let through")
    nb0 = fused_shadow_march_bf16(module, p.contiguous(), zero, 10.0, **kw)
    pnb0, _ = shadow_march_plain(lambda x: sphere_sdf_eval_plain(module, x, torch.bfloat16),
                                 p, zero, 10.0, **kw)
    check((nb0 == pnb0).float().mean().item() >= 0.999,
          "K4-bf16 probe: zero-direction rays inside the surface differ from the plain loop")
    return int((nb != nb32).sum().item()), int(p.shape[0])


def bf16_flagship_scene(max_steps, march_bound):
    """The flagship scene (nerf_synthetic.build_scene) in the mixed-precision
    configuration: the three kinds of shading net with bf16 operands, the
    march with bf16 operands, the shift net in float32."""
    import neural_raytracing_tpu_torch as T
    from neural_raytracing_tpu_torch.bsdf import ComposeSpatialVarying, NeuralBSDF
    from neural_raytracing_tpu_torch.kernels import FusedSkipConnMLP
    from neural_raytracing_tpu_torch.lights import LightField
    from neural_raytracing_tpu_torch.shapes import SDF, SphereSDF
    import torch
    bf16 = torch.bfloat16
    lobe = lambda: FusedSkipConnMLP(in_size=3, out=3, num_layers=6, hidden_size=96,
                                    freqs=64, compute_dtype=bf16)
    return T.Scene(
        shape=SDF(SphereSDF(n=128), max_steps=max_steps, throughput_steps=128, dist=2.2,
                  march_bound=march_bound, march_dtype=bf16),
        bsdf=ComposeSpatialVarying(
            [NeuralBSDF(activation="softplus", mlp=lobe()) for _ in range(8)],
            sp_var_fn=FusedSkipConnMLP(in_size=3, out=8, num_layers=16, hidden_size=256,
                                       freqs=128, sigma=128.0, init="xavier",
                                       compute_dtype=bf16)),
        lights=LightField(mlp=FusedSkipConnMLP(in_size=3, out=3, num_layers=10,
                                               hidden_size=256, compute_dtype=bf16)))


class plain_kernels:
    """Within this context every kernel that the flagship paths launch is
    replaced by its plain version in the kernel's precision (K1 and K1-bf16,
    K2-K4 and their bf16 variants): "everything plain in the same precision"
    on the card.  Nothing is counted."""

    def __enter__(self):
        import neural_raytracing_tpu_torch.kernels.fused_mlp as fm
        import neural_raytracing_tpu_torch.shapes.sdf as sdf_mod
        from neural_raytracing_tpu_torch.kernels import (
            march_plain, min_scan_plain, mlp_forward_bf16_operands, shadow_march_plain,
            sphere_sdf_eval_plain,
        )
        from neural_raytracing_tpu_torch.nn import mlp_forward

        def sdf(module, dtype):
            return lambda p: sphere_sdf_eval_plain(module, p, dtype)

        def march(module, r_o, r_d, max_t, *, max_steps, epsilon, omega, t_start,
                  compute_dtype):
            return march_plain(sdf(module, compute_dtype), r_o, r_d, max_t, t_start,
                               max_steps=max_steps, epsilon=epsilon, omega=omega)[:2]

        def scan(module, r_o, r_d, step, *, steps, compute_dtype):
            return min_scan_plain(sdf(module, compute_dtype), r_o.detach(), r_d.detach(),
                                  step, steps=steps)

        def shadow(module, r_o, r_d, max_t, *, max_steps, epsilon, past_light_exit,
                   compute_dtype):
            return shadow_march_plain(sdf(module, compute_dtype), r_o, r_d, max_t,
                                      max_steps=max_steps, epsilon=epsilon,
                                      past_light_exit=past_light_exit)[0]

        self.saved = [(fm, "fused_mlp_forward", mlp_forward),
                      (fm, "fused_mlp_forward_bf16", mlp_forward_bf16_operands),
                      (sdf_mod, "fused_march", march), (sdf_mod, "fused_min_scan", scan),
                      (sdf_mod, "fused_shadow_march", shadow)]
        self.saved = [(mod, name, getattr(mod, name), new) for mod, name, new in self.saved]
        for mod, name, _, new in self.saved:
            setattr(mod, name, new)
        return self

    def __exit__(self, *exc):
        for mod, name, old, _ in self.saved:
            setattr(mod, name, old)


def phase_bf16_flagship(torch, dev):
    """The mixed-precision flagship: the eval render (3 views) and a training
    step against everything plain in the same precision, 12 steps of train;
    beside them the f32 configuration's images and loss, and its ms/view and
    ms/step timed in turns with the bf16 ones (bf16, f32, f32, bf16)."""
    import copy

    import numpy as np
    from neural_raytracing_tpu_torch.cameras import NeRFCamera
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.kernels import launch_counts, reset_launch_counts
    from neural_raytracing_tpu_torch.training import (
        TrainState, build_step_fn, make_optimizer, train,
    )
    from neural_raytracing_tpu_torch.workloads import nerf_synthetic

    f32_kernels = ("fused_march", "fused_min_scan", "fused_shadow_march")
    views = [(30.0, 45.0), (30.0, 165.0), (30.0, 285.0)]
    scene = bf16_flagship_scene(256, 1.2)
    scene.init(torch.Generator().manual_seed(0), device=dev)
    f32_scene = nerf_synthetic.build_scene(max_steps=256, march_bound=1.2)
    f32_scene.init(torch.Generator().manual_seed(0), device=dev)
    for sc in (scene, f32_scene):
        render_views(torch, sc, views[:1], dev)     # warm-up, not counted
    reset_launch_counts()
    got, secs = render_views(torch, scene, views, dev)
    counts = launch_counts()
    k1_routes("bf16 eval")
    check(counts["pack_tile_weights"] == 0, "bf16 eval: the views packed weights again")
    f32_img, f32_secs = render_views(torch, f32_scene, views, dev)
    f32_secs += render_views(torch, f32_scene, views, dev)[1]
    secs += render_views(torch, scene, views, dev)[1]
    del f32_scene
    for name in ("fused_mlp_forward_bf16", "fused_march_bf16"):
        check(counts[name] > 0, f"bf16 eval render: {name} was not launched on the path")
    for name in f32_kernels:
        check(counts[name] == 0, f"bf16 eval render: the f32 kernel {name} was launched")
    profile_step(torch, lambda: render_views(torch, scene, views[:1], dev), "one bf16 view")
    with plain_kernels():
        want, plain_secs = render_views(torch, scene, views, dev)
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all()),
          "bf16 eval render: non-finite image")
    mask, pmask = got.abs().sum(-1) > 0, want.abs().sum(-1) > 0
    agree = (mask == pmask).float().mean().item()
    diff = (got - want).abs()
    check(pmask.float().mean().item() > 0, "bf16 eval render: no pixel hit the surface")
    check(agree >= 0.99, f"bf16 eval render: mask agreement {agree:.4f} < 0.99")
    check(diff.mean().item() <= 1e-3, f"bf16 eval render: mean |diff| {diff.mean().item():.3e}")
    ms_view = 1e3 * sum(secs) / len(secs)
    print(f"bf16 eval render (bounded, 256 steps): 3 views 256x256, kernels {ms_view:.1f} "
          f"ms/view (f32 configuration {1e3 * sum(f32_secs) / len(f32_secs):.1f} ms/view, "
          f"in turns: bf16 {[round(1e3 * x, 1) for x in secs[:3]]}, f32 "
          f"{[round(1e3 * x, 1) for x in f32_secs]}, bf16 "
          f"{[round(1e3 * x, 1) for x in secs[3:]]}), plain in bf16 "
          f"{1e3 * sum(plain_secs) / 3:.1f} ms/view; mask agreement {agree:.6f}, mean |diff| "
          f"{diff.mean().item():.3e}, max |diff| {diff.max().item():.3e}; against the f32 "
          f"configuration's images mean |diff| {(got - f32_img).abs().mean().item():.3e}, "
          f"max {(got - f32_img).abs().max().item():.3e}; launches {counts}")
    eval_counts = counts
    del scene, got, want, f32_img

    # the training step, as phase 7
    c2ws = train_c2ws()
    imgs, masks = sphere_gt(torch, c2ws)
    make_camera = lambda idxs: NeRFCamera(torch.from_numpy(c2ws[np.asarray(idxs)]), FOCAL)
    spec = make_optimizer(LRS)
    scene = bf16_flagship_scene(64, None)
    scene.init(torch.Generator().manual_seed(0), device=dev)
    idxs = list(range(N_VIEWS))
    u, v = silhouette_crop()
    exp = torch.from_numpy(imgs[idxs, u:u + CROP_SIZE, v:v + CROP_SIZE]).to(dev)
    mask = torch.from_numpy(masks[idxs, u:u + CROP_SIZE, v:v + CROP_SIZE]).to(dev)
    rays = crop_rays(torch, dev, c2ws[idxs], u, v)
    res = {}
    for label in ("kernels", "plain", "f32"):
        sc = copy.deepcopy(scene)
        if label == "f32":
            for m in sc.modules():
                if getattr(m, "compute_dtype", None) == torch.bfloat16:
                    m.compute_dtype = torch.float32
            sc.shape.march_dtype = torch.float32
        step = build_step_fn(sc, Direct(training=True), spec, size=SIZE, crop_size=CROP_SIZE)
        if label == "plain":
            with plain_kernels():
                _, aux = step(TrainState(sc, spec.init(sc), 0), make_camera(idxs), (u, v),
                              exp, mask)
        else:
            _, aux = step(TrainState(sc, spec.init(sc), 0), make_camera(idxs), (u, v),
                          exp, mask)
        grads = {c: torch.cat([p.grad.reshape(-1) for p in getattr(sc, c).parameters()])
                 for c in ("shape", "bsdf", "lights")}
        with torch.no_grad():
            _, hit = sc.shape.intersect(rays, primary=False)
        res[label] = (aux["loss"].item(), grads, hit)
        del sc
    (lk, gk, hk), (lp, gp, hp), (l32, _, _) = res["kernels"], res["plain"], res["f32"]
    rel_loss = abs(lk - lp) / abs(lp)
    n_hit_diff = int((hk != hp).sum().item())
    rel_g = {c: ((gk[c] - gp[c]).norm() / gp[c].norm().clamp_min(1e-30)).item() for c in gk}
    print(f"bf16 step parity (kernels vs plain in bf16, no jitter): loss {lk:.6f} vs {lp:.6f} "
          f"(rel {rel_loss:.3e}; f32 configuration {l32:.6f}), rays whose hit differs "
          f"{n_hit_diff} of {hk.numel()}, gradient rel L2 "
          f"{', '.join(f'{c} {e:.3e}' for c, e in rel_g.items())}")
    check(np.isfinite(lk) and rel_loss <= 1e-4, f"bf16 step parity: loss rel {rel_loss:.3e}")
    check(n_hit_diff <= 0.001 * hk.numel(), f"bf16 step parity: {n_hit_diff} hit flags differ")
    for c, e in rel_g.items():
        check(e <= 1e-2, f"bf16 step parity: {c} gradient rel L2 {e:.3e} > 1e-2")
    del res, gk, gp

    kw = dict(size=SIZE, crop_size=CROP_SIZE, n_views=N_VIEWS, mask_weight=15.0,
              with_ssim=True, log_every=0, nan_policy="raise")
    f32_scene = nerf_synthetic.build_scene(max_steps=64, march_bound=None)
    f32_scene.init(torch.Generator().manual_seed(0), device=dev)
    runs = {}
    for sc in (scene, f32_scene):
        runs[id(sc)] = [TrainState(sc, spec.init(sc), 0),
                        torch.Generator(device=dev).manual_seed(1)]

    def run(sc, iters, seed):
        state, gen = runs[id(sc)]
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, losses = train(sc, Direct(training=True), spec, state, make_camera, imgs,
                              masks, gen, iters=iters, seed=seed, **kw)
        torch.cuda.synchronize()
        runs[id(sc)][0] = state
        return losses, (time.perf_counter() - start) / iters

    for sc in (scene, f32_scene):
        run(sc, 2, 100)                                                 # warm-up
    iters = 12
    reset_launch_counts()
    losses, step_s = run(scene, iters, 0)
    counts = launch_counts()
    k1_routes("bf16 training")
    check(0 < counts["pack_tile_weights"] <= packed_nets(scene) * iters,
          f"bf16 training: {counts['pack_tile_weights']} packs in {iters} steps")
    f32_times = [run(f32_scene, iters, 0)[1], run(f32_scene, iters, 1)[1]]
    step_times = [step_s, run(scene, iters, 1)[1]]
    del f32_scene
    check(len(losses) == iters and np.isfinite(losses).all(), f"bf16 training: {losses}")
    for name in ("fused_mlp_forward_bf16", "fused_march_bf16", "fused_min_scan_bf16"):
        check(counts[name] > 0, f"bf16 training: {name} was not launched on the path")
    for name in f32_kernels:
        check(counts[name] == 0, f"bf16 training: the f32 kernel {name} was launched")
    step_s = sum(step_times) / 2
    print(f"bf16 training (kernels): {iters} steps, {1e3 * step_s:.1f} ms/step "
          f"({N_RAYS / step_s:,.0f} rays/s; f32 configuration "
          f"{1e3 * sum(f32_times) / 2:.1f} ms/step; in turns of {iters} steps: bf16 "
          f"{1e3 * step_times[0]:.1f}, f32 {1e3 * f32_times[0]:.1f}, f32 "
          f"{1e3 * f32_times[1]:.1f}, bf16 {1e3 * step_times[1]:.1f}), losses "
          f"{[round(x, 3) for x in losses]}; launches {counts} (K1 f32: the shift net, "
          f"which stays f32); before K3's redesign: bf16 "
          f"{PREV_STEP_MS['bf16']}, f32 {PREV_STEP_MS['bf16 call f32']} ms/step")
    profile_step(torch, lambda: run(scene, 1, 2), "one bf16 training step (kernels)")
    return eval_counts, counts


def phase_bf16_nerv(torch, dev):
    """NeRV eval on the checkpoint with march_dtype=bf16, learned and hard
    shadows, against the f32 march: ms/view, hit and not-blocked agreement,
    PSNR of the bf16 render against the f32 one."""
    import numpy as np
    from neural_raytracing_tpu_torch.kernels import launch_counts, reset_launch_counts
    from neural_raytracing_tpu_torch.render import _tile_positions
    camera_fn = lambda i: nerv_camera(torch, NERV_EVAL_VIEWS[i:i + 1])
    counts = {}
    for occlusion in ("learned", "hard"):
        scene32 = nerv_scene(torch, dev, 128, 1.2, occlusion)
        scene = scene32.replace(shape=scene32.shape.replace(march_dtype=torch.bfloat16))
        locs = scene.lights.location.detach().clone()
        nerv_evaluate(torch, scene, camera_fn, 1, locs)               # warm-up
        reset_launch_counts()
        _, got, s_view = nerv_evaluate(torch, scene, camera_fn, NERV_VIEWS, locs)
        counts[occlusion] = launch_counts()
        k1_routes(f"bf16 NeRV eval ({occlusion})")
        for name in ("fused_march_bf16", "fused_shadow_march_bf16"):
            check(counts[occlusion][name] > 0, f"bf16 NeRV eval: {name} was not launched")
        for name in ("fused_march", "fused_shadow_march"):
            check(counts[occlusion][name] == 0, f"bf16 NeRV eval: f32 {name} was launched")
        _, want, s32 = nerv_evaluate(torch, scene32, camera_fn, NERV_VIEWS, locs)
        check(np.isfinite(got).all(), "bf16 NeRV eval: non-finite image")
        mse = float(np.mean((got - want) ** 2))
        psnr = float("inf") if mse == 0.0 else -10.0 * math.log10(mse)
        # the primary hits and the shadow flags of one view, bf16 against f32
        cam = camera_fn(0).to(dev)
        pos = _tile_positions(0.0, 0.0, NERV_SIZE, dev)
        rays = cam.sample_positions(pos, size=NERV_SIZE)
        with torch.no_grad():
            _, hit = scene.shape.intersect(rays, primary=False)
            _, hit32 = scene32.shape.intersect(rays, primary=False)
        r_o, r_d, dist = shadow_rays(torch, scene32, cam, pos, locs[:1])
        shadow = torch.cat([r_o, r_d], dim=-1)
        nb = scene.shape.intersect_test(shadow, max_t=dist)
        nb32 = scene32.shape.intersect_test(shadow, max_t=dist)
        hit_agree = (hit == hit32).float().mean().item()
        nb_agree = (nb == nb32).float().mean().item()
        check(hit_agree >= 0.99, f"bf16 NeRV eval ({occlusion}): hit agreement {hit_agree:.4f}")
        check(nb_agree >= 0.99, f"bf16 NeRV eval ({occlusion}): not-blocked agreement "
              f"{nb_agree:.4f}")
        print(f"bf16 NeRV eval, {occlusion} shadows: {NERV_VIEWS} views {NERV_SIZE}x{NERV_SIZE}, "
              f"march_dtype bf16 {1e3 * s_view:.1f} ms/view, f32 {1e3 * s32:.1f} ms/view; "
              f"against the f32 render: PSNR {psnr:.2f} dB, mean |diff| "
              f"{np.abs(got - want).mean():.3e}, hit agreement {hit_agree:.6f}, not-blocked "
              f"agreement {nb_agree:.6f} (one view); launches {counts[occlusion]}")
        del scene, scene32
    return counts



# ---- slice 12: the colocate workload and its dataset generator ----------------------

CO_SIZE = 200                                      # scripts/colocate.py's default
CO_CHUNK = 100                                     # chunk_for(200)
CO_CROP = 64
CO_VIEWS = 4
CO_RAYS = CO_VIEWS * CO_CROP * CO_CROP             # 16,384 rays a step
CO_LRS = {"shape": 8e-5, "bsdf": 8e-5, "lights": 8e-5, "occ": 8e-5}
CO_KIND = "bunny"
# the generator renders a 200^2 view in one tile (its loops are plain and
# host-bound: one tile a view launches a quarter of chunk_for(200)'s); the
# tile size changes only the camera jitter's draws
CO_GEN_CHUNK = 200
CO_RELIGHT_ROWS = (0,)                             # one camera row: 4 x 9 views
CO_RELIGHT_EVAL = 4                                # relight views rendered in (e)
CO_RELIGHT_CMP = 2                                 # of them, held against plain in (e)
# K1-K4's kernels by the names the profiler gives them (K3 with its merge)
K_NAMES = {"K1": ("nrt_mlp_tile_f32_kernel",), "K2": ("nrt_fused_march_f32_kernel",),
           "K3": ("nrt_fused_minscan_f32_kernel", "nrt_minscan_merge_kernel"),
           "K4": ("nrt_fused_shadow_f32_kernel",)}
# every kernel the generator must not launch: K1-K5, their bf16 variants, the packs
GEN_FREE = ("fused_mlp_forward", "fused_march", "fused_min_scan", "fused_shadow_march",
            "fused_sphere_sdf", "fused_mlp_forward_bf16", "fused_march_bf16",
            "fused_min_scan_bf16", "fused_shadow_march_bf16", "pack_tile_weights")


def black_psnr(images) -> float:
    """The mean PSNR of an all-black render against each of ``images``."""
    import numpy as np
    return float(np.mean([-10.0 * math.log10(max(float(np.mean(np.asarray(im)[..., :3] ** 2)),
                                                   1e-10)) for im in images]))


def pixel_probe(images, masks=None) -> str:
    """Coverage, the median of the lit pixels and the share of clipped ones."""
    import numpy as np
    rgb = np.asarray(images)[..., :3]
    lit = rgb.max(-1) > 1e-3 if masks is None else np.asarray(masks) > 0
    vals = rgb[lit]
    median = float(np.median(vals)) if vals.size else 0.0
    return (f"coverage {lit.mean():.4f}, median lit pixel {median:.4f}, "
            f"clipped {float((rgb >= 1.0).mean()):.5f}")


def colocate_dataset(torch, dev, size, n_elev, n_azim, cam_rows, chunk=None, light_scale=1.5):
    """The generator twin on the card: the colocated grid and ``cam_rows`` of
    the relight grid, in memory.  -> (ColocateDataset, relight {(i, j, k, l):
    8-bit image / 255}, seconds, the launch counts)."""
    import numpy as np
    from neural_raytracing_tpu_torch.kernels import launch_counts, reset_launch_counts
    from neural_raytracing_tpu_torch.workloads import make_dataset as md
    scene = md.build_scene(CO_KIND, light_scale).init(
        torch.Generator().manual_seed(md.SEED), device=dev)
    reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    grid = md.render_grid(scene, size=size, n_elev=n_elev, n_azim=n_azim, chunk_size=chunk,
                          device=dev, log_fn=lambda s: None)
    relight = md.render_relight_grid(scene, size=size, cam_rows=cam_rows, chunk_size=chunk,
                                     device=dev, log_fn=lambda s: None)
    secs = time.perf_counter() - start
    counts = launch_counts()
    relight = {k: md.quantise(v).astype(np.float32) / 255.0 for k, v in relight.items()}
    return md.as_dataset(grid, n_elev, n_azim), relight, secs, counts


def twin_args(twin, **kw):
    """A workload twin's arguments (its parser's defaults, then ``kw``) for
    its ``run`` on data in memory."""
    args = twin.parser().parse_args(["--data", "(in memory)"])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def k_path_ms(prof: dict) -> dict:
    """{K: (ms a launch, launches)} of K1-K4 in a kernel_profile."""
    out = {}
    for k, names in K_NAMES.items():
        hits = [(ms, n) for key, (ms, n) in prof.items() if any(s in key for s in names)]
        n = sum(n for _, n in hits)
        out[k] = (sum(ms for ms, _ in hits) / max(n, 1), n)
    return out


def k_line(path: dict) -> str:
    return ", ".join(f"{k} {ms:.4f} ms x{n}" for k, (ms, n) in path.items())


def sync_sites(torch, fn) -> dict:
    """{file:line: count} of the calls in ``fn`` that make the host wait for
    the card (``torch.cuda.set_sync_debug_mode``'s warnings), each at its
    innermost frame in the port's package; a wait in the backward pass shows
    where it was started."""
    import traceback
    import warnings
    sites = {}

    def show(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "neural_raytracing_tpu_torch" in Path(f.filename).parts]
        at = frames[-1] if frames else None
        key = (f"{Path(at.filename).relative_to(ROOT)}:{at.lineno}" if at
               else f"{Path(filename).name}:{lineno}")
        sites[key] = sites.get(key, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return dict(sorted(sites.items(), key=lambda kv: -kv[1]))


def blocked_shadow_rays(torch, scene, rays):
    """-> (the camera rays that hit ``scene``'s shape and whose shadow ray to
    its light is blocked, the hit mask), through ``scene``'s own marches:
    the kernels, or the plain loops where its kernel mode is off."""
    with torch.no_grad():
        it, hit = scene.shape.intersect(rays, primary=False)
        ds, _ = scene.lights.sample_direction(it)
        nb = scene.shape.intersect_test(torch.cat([it.p, ds.d], dim=-1), max_t=ds.dist)
    return (~nb & hit).sum().item(), hit


def phase_colocate(torch, dev):
    """The colocate workload on data the generator twin makes on the card:
    (a) the dataset, (b) one step against plain, (c) 20 steps of train, (d)
    the hard-shadow test against plain, (e) a few relight-grid views."""
    import copy

    import numpy as np
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.kernels import (
        launch_counts, reset_launch_counts, set_kernel_mode,
    )
    from neural_raytracing_tpu_torch.render import _tile_positions
    from neural_raytracing_tpu_torch.training import (
        TrainState, build_step_fn, evaluate, make_optimizer, rand_uv_mask, train,
    )
    from neural_raytracing_tpu_torch.training.eval import restored_parameters
    from neural_raytracing_tpu_torch.workloads import colocate
    from neural_raytracing_tpu_torch.workloads import make_dataset as md
    from neural_raytracing_tpu_torch.workloads.nerfle import colocate_cameras

    # (a) the dataset, generated here: no kernel of K1-K5 on its path
    data, relight, gen_s, counts = colocate_dataset(torch, dev, CO_SIZE, 8, 8,
                                                    CO_RELIGHT_ROWS, CO_GEN_CHUNK)
    launched = {k: counts[k] for k in GEN_FREE if counts[k]}
    check(not launched, f"colocate generator: launched {launched}")
    cover = float(data.masks.mean())
    lit = data.images[data.masks > 0]
    median = float(np.median(lit)) if lit.size else 0.0
    check(0.05 < cover < 0.95, f"colocate generator: mask coverage {cover:.4f}")
    check(median > 0.02, f"colocate generator: the data is black (median lit {median:.4f})")
    test_black = black_psnr(data.images[:8])
    relight_black = black_psnr(relight.values())
    print(f"colocate generator ({CO_KIND}): the 8x8 grid and {len(CO_RELIGHT_ROWS)} camera "
          f"row(s) of the relight grid ({len(relight)} views) at {CO_SIZE}x{CO_SIZE}, tiles "
          f"of {CO_GEN_CHUNK} (chunk_for gives {CO_CHUNK}), {gen_s:.1f} s "
          f"({1e3 * gen_s / (64 + len(relight)):.1f} ms/view); no K1-K5 launch; grid: "
          f"{pixel_probe(data.images, data.masks)}; relight: "
          f"{pixel_probe(list(relight.values()))}; black-render PSNR: test views "
          f"{test_black:.3f} dB, relight views {relight_black:.3f} dB")

    cams = colocate_cameras(data)
    centers = cams.camera_center().numpy()
    light_update = colocate.make_light_update(centers)

    def make_camera(idxs):
        from neural_raytracing_tpu_torch.cameras import FoVPerspectiveCamera
        idxs = torch.as_tensor(np.asarray(idxs))
        return FoVPerspectiveCamera(R=cams.R[idxs], T=cams.T[idxs])

    spec = make_optimizer(CO_LRS)
    scene = colocate.build_scene().init(torch.Generator().manual_seed(0), device=dev)

    # (b) one step at full width against every kernel off, from the same state
    idxs = [9, 20, 42, 55]
    u = v = (CO_SIZE - CO_CROP) // 2
    exp = torch.from_numpy(data.images[idxs, u:u + CO_CROP, v:v + CO_CROP]).to(dev)
    mask = torch.from_numpy(data.masks[idxs, u:u + CO_CROP, v:v + CO_CROP]).to(dev)
    rays = make_camera(idxs).to(dev).sample_positions(
        _tile_positions(float(u), float(v), CO_CROP, dev), size=CO_SIZE)
    res = {}
    for label, mode in (("kernels", "auto"), ("plain", "off")):
        sc = copy.deepcopy(scene)
        set_kernel_mode(sc, mode)
        light_update(sc, None, idxs)
        step = build_step_fn(sc, Direct(training=True), spec, size=CO_SIZE, crop_size=CO_CROP,
                             extra_loss=colocate.extra_loss)
        _, aux = step(TrainState(sc, spec.init(sc), 0), make_camera(idxs), (u, v), exp, mask)
        grads = {c: torch.cat([p.grad.reshape(-1) for p in getattr(sc, c).parameters()])
                 for c in ("shape", "bsdf", "lights", "occ")}
        for i, name in ((2, "Diffuse"), (3, "Conductor")):
            grads[name] = torch.cat([p.grad.reshape(-1)
                                     for p in sc.bsdf.bsdfs[i].parameters()])
        blocked, hit = blocked_shadow_rays(torch, sc, rays)
        res[label] = (aux["loss"].item(), grads, hit, blocked)
        del sc
    (lk, gk, hk, bk), (lp, gp, hp, bp) = res["kernels"], res["plain"]
    rel_loss = abs(lk - lp) / abs(lp)
    n_hit_diff = int((hk != hp).sum().item())
    rel_g = {c: ((gk[c] - gp[c]).norm() / gp[c].norm().clamp_min(1e-30)).item() for c in gk}
    print(f"colocate step parity (kernels vs every kernel off, {CO_VIEWS} x {CO_CROP}^2, "
          f"seed 0, no jitter): loss {lk:.6f} vs {lp:.6f} (rel {rel_loss:.3e}), rays whose "
          f"hit differs {n_hit_diff} of {hk.numel()} (hit fraction "
          f"{hp.float().mean().item():.4f}), blocked shadow rays {bk} / {bp}, gradient "
          f"rel L2 {', '.join(f'{c} {e:.3e}' for c, e in rel_g.items())}")
    check(np.isfinite(lk) and rel_loss <= 1e-4, f"colocate step parity: loss rel {rel_loss:.3e}")
    check(n_hit_diff <= 0.001 * hk.numel(), f"colocate step parity: {n_hit_diff} hit flags differ")
    check(hp.any().item(), "colocate step parity: no ray hit the surface")
    for c, e in rel_g.items():
        if c == "occ" and bp == 0:
            # no shadow ray blocked: the occlusion net takes no gradient
            check(gk[c].norm().item() == 0.0, "colocate step parity: occ gradient "
                  "without a blocked shadow ray")
            continue
        check(gp[c].norm().item() > 0, f"colocate step parity: no {c} gradient")
        check(e <= 1e-2, f"colocate step parity: {c} gradient rel L2 {e:.3e} > 1e-2")
    del res, gk, gp

    # (c) 20 steps of train through the kernels, counts reset just before
    kw = dict(size=CO_SIZE, crop_size=CO_CROP, n_views=CO_VIEWS, uv_select=rand_uv_mask,
              light_update=light_update, extra_loss=colocate.extra_loss, log_every=0,
              nan_policy="raise")
    state = TrainState(scene, spec.init(scene), 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    state, _ = train(scene, Direct(training=True), spec, state, make_camera, data.images,
                     data.masks, gen, iters=2, seed=100, **kw)                  # warm-up
    occ0 = {k: p.detach().clone() for k, p in scene.occ.named_parameters()}
    reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    iters = 20
    state, losses = train(scene, Direct(training=True), spec, state, make_camera, data.images,
                          data.masks, gen, iters=iters, seed=0, **kw)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - start) / iters
    counts = launch_counts()
    routes = k1_routes("colocate training")
    check(len(losses) == iters and np.isfinite(losses).all(), f"colocate training: {losses}")
    for name in ("fused_mlp_forward", "fused_march", "fused_min_scan", "fused_shadow_march"):
        check(counts[name] > 0, f"colocate training: kernel {name} was not launched on the path")
    check(counts["pack_tile_weights"] <= packed_nets(scene) * iters,
          f"colocate training: {counts['pack_tile_weights']} packs")
    check(scene.lights.location.shape == (CO_VIEWS, 3), "colocate training: light location")
    changed = sum(not torch.equal(occ0[k], p) for k, p in scene.occ.named_parameters())
    print(f"colocate training (kernels): {iters} steps, {1e3 * secs:.1f} ms/step, "
          f"{CO_RAYS / secs:,.0f} rays/s, losses {[round(x, 3) for x in losses]}; occ "
          f"parameters changed {changed}; launches {counts}; K1 routes {routes}")
    step = build_step_fn(scene, Direct(training=True), spec, size=CO_SIZE,
                         crop_size=CO_CROP, extra_loss=colocate.extra_loss)
    light_update(scene, None, idxs)
    one_step = lambda: step(state, make_camera(idxs), (u, v), exp, mask, gen)
    prof = profile_step(torch, one_step, "one colocate training step (kernels)")
    check(prof is not None, "colocate training: the profiler saw no device time")
    path = k_path_ms(kernel_profile(torch, one_step, reps=2))
    print(f"colocate training step, K1-K4 device ms a launch at its shapes: {k_line(path)}")
    syncs = sync_sites(torch, one_step)
    print(f"colocate training step: {sum(syncs.values())} calls that wait for the card, by "
          f"the innermost line of the port: {syncs}")

    # (d) the hard-shadow test: 2 views through evaluate, kernels against plain
    test = colocate.eval_scene(scene)

    def test_views(n):
        images = []
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = evaluate(test, lambda i: make_camera([i]), data.images[:n], Direct(training=False),
                       size=CO_SIZE, chunk_size=CO_CHUNK, log_fn=lambda s: None,
                       light_update=lambda sc, cam, i: light_update(sc, cam, [i]),
                       save_fn=lambda i, im: images.append(np.asarray(im)))
        torch.cuda.synchronize()
        return out, np.stack(images), (time.perf_counter() - start) / n

    test_views(1)                                                             # warm-up
    reset_launch_counts()
    out, got, s_view = test_views(2)
    test_counts = launch_counts()
    k1_routes("colocate test")
    for name in ("fused_mlp_forward", "fused_march", "fused_shadow_march"):
        check(test_counts[name] > 0, f"colocate test: kernel {name} was not launched")
    check(scene.lights.location.shape == (CO_VIEWS, 3), "evaluate changed the light location")

    def one_view():
        with torch.no_grad():
            from neural_raytracing_tpu_torch.render import pathtrace
            light_update(test, None, [0])
            pathtrace(test, make_camera([0]), Direct(training=False), size=CO_SIZE,
                      chunk_size=CO_CHUNK, bundle_size=1, background=0.0, key=0, device=dev)
    loc = scene.lights.location.detach().clone()
    vprof = profile_step(torch, one_view, "one colocate test view (hard shadows)")
    check(vprof is not None, "colocate test: the profiler saw no device time")
    vpath = k_path_ms(kernel_profile(torch, one_view, reps=1))
    scene.lights.set_location(loc)
    set_kernel_mode(test, "off")             # test.shape is not one of scene's modules
    _, want, p_view = test_views(2)
    set_kernel_mode(test, "auto")
    frac, agree, mean_d, max_d = compare_images("colocate test", got, want)
    print(f"colocate test, hard shadows: 2 views {CO_SIZE}x{CO_SIZE} (trained "
          f"{state.step} steps), kernels {1e3 * s_view:.1f} ms/view "
          f"({CO_SIZE ** 2 / s_view:,.0f} rays/s), every kernel off {1e3 * p_view:.1f} "
          f"ms/view; lit fraction {frac:.4f}, mask agreement {agree:.6f}, mean |diff| "
          f"{mean_d:.3e}, max |diff| {max_d:.3e}; PSNR {out['psnr']:.3f} dB (black "
          f"{black_psnr(data.images[:2]):.3f}); K1-K4 device ms a launch in a view: "
          f"{k_line(vpath)}; launches {test_counts}")

    # (e) a few views of the relight grid, their PSNR beside the black render's:
    # the brightest views of the row (most of the grid's lights leave the
    # side the camera sees dark, and a near-black view scores any dark render
    # high)
    views = dict(sorted(relight.items(), key=lambda kv: -float(np.mean(kv[1][..., :3])))
                 [:CO_RELIGHT_EVAL])
    got_r, want_r = {}, {}
    torch.cuda.synchronize()
    start = time.perf_counter()
    psnrs = colocate.relight_psnrs(test, views, size=CO_SIZE, device=dev,
                                   save_fn=got_r.__setitem__)
    r_view = (time.perf_counter() - start) / len(views)
    check(np.isfinite(psnrs).all(), f"colocate relight: PSNR {psnrs}")
    check(scene.lights.location.shape == (CO_VIEWS, 3), "relight changed the light location")
    # no relight light is colocated with its camera, so these views have real
    # shadows: the first CO_RELIGHT_CMP, kernels against every kernel off, and
    # the first one's blocked shadow rays on both sides
    cmp_keys = sorted(views)[:CO_RELIGHT_CMP]
    i, j, k, l = cmp_keys[0]
    rays = md.camera_at(1.0, md.CAM_ELEVS[i], md.CAM_AZIMS[j]).to(dev).sample_positions(
        _tile_positions(0.0, 0.0, CO_SIZE, dev), size=CO_SIZE)
    blocked = {}
    with restored_parameters(scene.lights):
        test.lights.set_location(md.relight_light(k, l))
        blocked["kernels"], _ = blocked_shadow_rays(torch, test, rays)
        set_kernel_mode(test, "off")
        blocked["plain"], _ = blocked_shadow_rays(torch, test, rays)
    colocate.relight_psnrs(test, {key: views[key] for key in cmp_keys}, size=CO_SIZE,
                           device=dev, save_fn=want_r.__setitem__)
    set_kernel_mode(test, "auto")
    check(blocked["plain"] > 0, f"colocate relight: no shadow ray blocked in view {cmp_keys[0]}")
    r_frac, r_agree, r_mean, r_max = compare_images(
        "colocate relight", np.stack([got_r[key] for key in cmp_keys]),
        np.stack([want_r[key] for key in cmp_keys]))
    print(f"colocate relight, kernels against every kernel off on {cmp_keys}: blocked "
          f"shadow rays in {cmp_keys[0]} {blocked['kernels']} / {blocked['plain']}, lit "
          f"fraction {r_frac:.4f}, mask agreement {r_agree:.6f}, mean |diff| {r_mean:.3e}, "
          f"max |diff| {r_max:.3e}")
    print(f"colocate relight grid (its {len(views)} brightest views {sorted(views)} after "
          f"{state.step} steps, a pipeline check): PSNR {[round(p, 3) for p in psnrs]}, mean "
          f"{np.mean(psnrs):.3f} dB, black {black_psnr(views.values()):.3f} dB; "
          f"{1e3 * r_view:.1f} ms/view")
    print(f"colocate on {card()}: training {1e3 * secs:.1f} ms/step (one step busy "
          f"{prof['busy_ms']:.1f} ms, idle share {1 - prof['busy_ms'] / prof['wall_ms']:.3f}), "
          f"hard-shadow test {1e3 * s_view:.1f} ms/view (one view busy "
          f"{vprof['busy_ms']:.1f} ms, idle share {1 - vprof['busy_ms'] / vprof['wall_ms']:.3f})")
    return dict(step_ms=1e3 * secs, ms_view=1e3 * s_view, step_prof=prof, view_prof=vprof,
                counts=counts, test_counts=test_counts, path=path)


# ---- slice 13: the DTU workload, the NeRV generator and the on-device data path -------

DTU_SIZE = 200                                     # scripts/dtu.py's default
DTU_CHUNK = 100                                    # chunk_for(200)
DTU_CROP = 96
DTU_VIEWS = 3
DTU_RAYS = DTU_VIEWS * DTU_CROP * DTU_CROP         # 27,648 rays a step
DTU_SCAN = 16                                      # views the generator makes
DTU_LRS = {"shape": 8e-5, "bsdf": 8e-5, "lights": 8e-5}
DTU_PARITY_CROP = 48                               # the reduced step against plain
NV_SIZE = 64                                       # scripts/make_nerv_dataset.py's default


def dtu_scan(torch, dev, size, views):
    """The DTU generator twin on the card -> (the ``DTUDataset`` through the
    projection decomposition, its intrinsics' source size matched (the
    generator's pixels; ``load_dtu``'s default 1600 x 1200 is the real
    scans'), seconds, the launch counts)."""
    from neural_raytracing_tpu_torch.kernels import launch_counts, reset_launch_counts
    from neural_raytracing_tpu_torch.training import dtu_dataset
    from neural_raytracing_tpu_torch.workloads import make_dtu_dataset as md
    scene = md.build_scene().init(torch.Generator().manual_seed(md.SEED), device=dev)
    reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    images, masks, cams = md.render_scan(scene, views, size, device=dev, log_fn=lambda s: None)
    secs = time.perf_counter() - start
    counts = launch_counts()
    imgs, msks = md.as_arrays(images, masks)
    return dtu_dataset(cams, imgs, msks, size, src_size=(size, size)), secs, counts


def nerv_generated(torch, dev, size, train_views=12, test_views=4):
    """The NeRV generator twin on the card -> (train ``NeRVDataset``, test
    ``NeRVDataset``, seconds, the launch counts)."""
    from neural_raytracing_tpu_torch.kernels import launch_counts, reset_launch_counts
    from neural_raytracing_tpu_torch.workloads import make_nerv_dataset as mn
    scene = mn.build_scene().init(torch.Generator().manual_seed(mn.SEED), device=dev)
    reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = mn.render_dataset(scene, size=size, train_views=train_views, test_views=test_views,
                            device=dev, log_fn=lambda s: None)
    secs = time.perf_counter() - start
    counts = launch_counts()
    return (mn.as_dataset(*out["train"], size), mn.as_dataset(*out["test"], size), secs,
            counts)


def lit_psnr(got, gt) -> tuple:
    """-> (PSNR of ``got``, PSNR of a black render) over the pixels where the
    ground truth ``gt`` exceeds 0.01 in some channel: on dark ground truth
    the whole-image PSNR is mostly the black background's."""
    import numpy as np
    gt = np.asarray(gt)[..., :3]
    lit = gt.max(-1) > 0.01
    if not lit.any():
        return float("nan"), float("nan")
    mse = float(np.mean((np.asarray(got)[..., :3][lit] - gt[lit]) ** 2))
    black = float(np.mean(gt[lit] ** 2))
    return -10.0 * math.log10(max(mse, 1e-10)), -10.0 * math.log10(max(black, 1e-10))


def generator_report(label, counts, images, masks, secs) -> str:
    """Check that a generator launched none of K1-K5 and made data that is
    not empty or black; -> its line."""
    import numpy as np
    launched = {k: counts[k] for k in GEN_FREE if counts[k]}
    check(not launched, f"{label}: launched {launched}")
    cover = float(np.mean(masks))
    check(0.05 < cover < 0.95, f"{label}: mask coverage {cover:.4f}")
    check(float(np.max(images)) > 0.05, f"{label}: the data is black")
    return (f"{label}: {len(images)} views {images.shape[1]}x{images.shape[2]} in "
            f"{secs:.2f} s ({secs / len(images):.3f} s a view); no K1-K5 launch; "
            f"{pixel_probe(images, masks)}; black-render PSNR {black_psnr(images):.3f} dB")


def phase_dtu(torch, dev, rounds: int = 1):
    """The DTU workload (workloads.dtu) on data the generator twin makes on
    the card: (a) the scan, (b) one reduced step against plain_kernels(),
    (c) the host and device data paths in turns, (d) a masked test view
    against plain, (e) workloads.render.main --workload dtu."""
    import copy

    import numpy as np
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.kernels import (
        launch_counts, reset_launch_counts, set_kernel_mode,
    )
    from neural_raytracing_tpu_torch.training import (
        TrainState, device_dataset, evaluate, make_device_data_step, make_optimizer,
        rand_uv_mask,
    )
    from neural_raytracing_tpu_torch.workloads import dtu

    # (a) the scan, generated here, through the projection decomposition
    data, gen_s, counts = dtu_scan(torch, dev, DTU_SIZE, DTU_SCAN)
    print(generator_report("DTU generator (bunny, scripts/make_dtu_dataset.py's scene)",
                           counts, data.images, data.masks, gen_s))
    train_idx, test_idx = dtu.split(len(data.images), 10)
    make_camera = dtu.camera_maker(data)
    builder = dtu.packed_camera_builder(data.src_size)
    ddata = device_dataset(data.images[train_idx], data.masks[train_idx],
                           dtu.packed_cameras(data, train_idx), DTU_CROP, device=dev)
    spec = make_optimizer(DTU_LRS)
    scene = dtu.build_scene().init(torch.Generator().manual_seed(0), device=dev)

    # (b) one reduced step (3 views x 48^2 at the centre, where the seed-0
    # surface is, mask weight 10) on the device data path, its draws pinned,
    # against the same step with every kernel replaced by its plain version
    views = [1, 5, 9]
    u = w = (DTU_SIZE - DTU_PARITY_CROP) // 2
    pinned = lambda d, g: (torch.tensor(views, device=dev), torch.tensor(u, device=dev),
                           torch.tensor(w, device=dev))
    pdata = device_dataset(data.images[train_idx], data.masks[train_idx],
                           dtu.packed_cameras(data, train_idx), DTU_PARITY_CROP, device=dev)
    res = {}
    for label in ("kernels", "plain"):
        sc = copy.deepcopy(scene)
        dstep = make_device_data_step(sc, Direct(training=True), spec, builder,
                                      n_views=DTU_VIEWS, size=DTU_SIZE,
                                      crop_size=DTU_PARITY_CROP, mask_weight=10.0, draw=pinned)
        if label == "plain":
            with plain_kernels():
                _, aux = dstep(TrainState(sc, spec.init(sc), 0), pdata, None)
        else:
            _, aux = dstep(TrainState(sc, spec.init(sc), 0), pdata, None)
        grads = {c: torch.cat([p.grad.reshape(-1) for p in getattr(sc, c).parameters()])
                 for c in ("shape", "bsdf", "lights")}
        res[label] = (aux["loss"].item(), grads, aux["got"][..., 3] > 0.5)
        del sc
    (lk, gk, ak), (lp, gp, ap) = res["kernels"], res["plain"]
    rel_loss = abs(lk - lp) / abs(lp)
    n_diff = int((ak != ap).sum().item())
    rel_g = {c: ((gk[c] - gp[c]).norm() / gp[c].norm().clamp_min(1e-30)).item() for c in gk}
    print(f"DTU step parity (device data path, draws pinned: views {views}, corner ({u}, {w}), "
          f"{DTU_VIEWS} x {DTU_PARITY_CROP}^2, mask weight 10; kernels vs plain_kernels()): "
          f"loss {lk:.7f} vs {lp:.7f} (rel {rel_loss:.3e}, same bits {lk == lp}), silhouette "
          f"flags that differ {n_diff} of {ak.numel()} (covered {ap.float().mean().item():.4f}), "
          f"gradient rel L2 {', '.join(f'{c} {e:.3e}' for c, e in rel_g.items())}")
    check(np.isfinite(lk) and rel_loss <= 1e-5, f"DTU step parity: loss rel {rel_loss:.3e}")
    check(n_diff <= 0.001 * ak.numel(), f"DTU step parity: {n_diff} silhouette flags differ")
    check(ap.any().item(), "DTU step parity: the crop misses the surface")
    for c, e in rel_g.items():
        check(gp[c].norm().item() > 0, f"DTU step parity: no {c} gradient")
        check(e <= 1e-2, f"DTU step parity: {c} gradient rel L2 {e:.3e} > 1e-2")
    del res, gk, gp

    # (c) training at full width (3 x 96^2, mask-centred crops), the host and
    # the device data path in turns
    kw = dict(size=DTU_SIZE, crop_size=DTU_CROP, n_views=DTU_VIEWS, mask_weight=10.0,
              uv_select=rand_uv_mask, log_every=0, nan_policy="raise")
    paths, box = train_paths(
        scene, spec, TrainState(scene, spec.init(scene), 0),
        torch.Generator(device=dev).manual_seed(1),
        (lambda idxs: make_camera(train_idx[np.asarray(idxs)]), data.images[train_idx],
         data.masks[train_idx], {}), dict(device_data=ddata, camera_builder=builder), **kw)
    paths["host"](2)                                                   # warm-up
    paths["device"](2)
    kernels = ("fused_mlp_forward", "fused_march", "fused_min_scan")
    counts = counted_path(torch, "DTU training, device data path", paths["device"], kernels)
    counted_path(torch, "DTU training, host data path", paths["host"], kernels)
    turns = data_path_turns(torch, f"DTU training ({DTU_VIEWS} x {DTU_CROP}^2)", paths,
                            DTU_RAYS, rounds=rounds)
    state = box["state"]

    # (d) a masked test view at 200^2, 128 steps bounded by 1.2, against plain
    test = dtu.eval_scene(scene, 1.2)

    def test_view():
        images = []
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = evaluate(test, lambda i: make_camera([test_idx[i]]), data.images[test_idx[:1]],
                       Direct(training=False), size=DTU_SIZE, chunk_size=DTU_CHUNK,
                       masks=data.masks[test_idx[:1]], log_fn=lambda s: None,
                       save_fn=lambda i, im: images.append(np.asarray(im)))
        torch.cuda.synchronize()
        return out, np.stack(images), time.perf_counter() - start

    test_view()                                                        # warm-up
    reset_launch_counts()
    out, got, s_view = test_view()
    test_counts = launch_counts()
    k1_routes("DTU test")
    for name in ("fused_mlp_forward", "fused_march"):
        check(test_counts[name] > 0, f"DTU test: kernel {name} was not launched")
    set_kernel_mode(test, "off")
    _, want, p_view = test_view()
    set_kernel_mode(test, "auto")
    frac, agree, mean_d, max_d = compare_images("DTU test", got, want)
    gt = data.images[test_idx[:1]] * data.masks[test_idx[:1], ..., None]
    print(f"DTU test view {test_idx[0]} (masked, {DTU_SIZE}^2, 128 steps, bounded 1.2, trained "
          f"{state.step} steps): kernels {1e3 * s_view:.1f} ms, every kernel off "
          f"{1e3 * p_view:.1f} ms; lit fraction {frac:.4f}, mask agreement {agree:.6f}, mean "
          f"|diff| {mean_d:.3e}, max |diff| {max_d:.3e}; PSNR {out['psnr']:.3f} dB (black "
          f"{black_psnr(gt):.3f}); launches {test_counts}")

    # (e) the orbit renderer over the trained scene
    orbit_frame(torch, dev, "dtu", scene)
    return dict(counts=counts, turns=turns, test_counts=test_counts)


def phase_nerv_generated(torch, dev, rounds: int = 1):
    """The NeRV generator twin on the card, then the NeRV twin's run on its
    data: 10 steps on the host data path, 10 on the device path (then one
    test view), and the two paths in turns."""
    import numpy as np
    from neural_raytracing_tpu_torch.cameras import NeRFCamera
    from neural_raytracing_tpu_torch.kernels import launch_counts, reset_launch_counts
    from neural_raytracing_tpu_torch.training import (
        NeRVDataset, device_dataset, make_optimizer, rand_uv_mask,
    )
    from neural_raytracing_tpu_torch.workloads import nerv

    data, test, gen_s, counts = nerv_generated(torch, dev, NV_SIZE)
    print(generator_report("NeRV generator (armadillo, scripts/make_nerv_dataset.py's scene)",
                           counts, np.concatenate([data.images, test.images]),
                           np.concatenate([data.masks, test.masks]), gen_s))
    one_test = NeRVDataset(test.cam_to_worlds[:1], test.focal, test.images[:1], test.masks[:1],
                           test.light_locs[:1], None)
    kernels = ("fused_mlp_forward", "fused_march", "fused_min_scan", "fused_shadow_march")
    runs = {}
    for path in ("host", "device"):
        args = twin_args(nerv, size=NV_SIZE, crop_size=NV_SIZE, iters=10, log_every=0,
                         device=str(dev), device_data=path == "device")
        reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, res = nerv.run(args, data, one_test if path == "device" else None, save=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
        c = launch_counts()
        k1_routes(f"NeRV twin, {path} data path")
        for name in kernels:
            check(c[name] > 0, f"NeRV twin, {path} path: kernel {name} was not launched")
        check(np.isfinite(res["losses"]).all(), f"NeRV twin, {path} path: {res['losses']}")
        runs[path] = (state, res, c)
        print(f"NeRV twin run ({path} data path, {NV_SIZE}^2, 3 x {NV_SIZE}^2 crops, 10 steps"
              f"{', then one test view in both shadow modes' if path == 'device' else ''}): "
              f"{secs:.2f} s, losses {[round(x, 4) for x in res['losses']]}; K4 launches "
              f"{c['fused_shadow_march']}; launches {c}")
    state, res, _ = runs["device"]
    for tag in ("soft", "hard"):
        check(all(np.isfinite(v) for v in res[tag].values()), f"NeRV twin test: {res[tag]}")
    print(f"NeRV twin test view (after 10 steps): soft PSNR {res['soft']['psnr']:.3f}, hard "
          f"{res['hard']['psnr']:.3f} dB (black {black_psnr(np.clip(one_test.images, 0, 1)):.3f})")

    scene, spec = state.scene, make_optimizer(NERV_LRS)       # the twin's learning rates
    kw = dict(size=NV_SIZE, crop_size=NV_SIZE, n_views=3, tone_mapping=True,
              uv_select=rand_uv_mask, log_every=0, nan_policy="raise")
    ddata = device_dataset(data.images, data.masks, data.cam_to_worlds, NV_SIZE,
                           light_locs=data.light_locs, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    make_camera = lambda idxs: NeRFCamera(torch.from_numpy(data.cam_to_worlds[np.asarray(idxs)]),
                                          data.focal)
    light_update = lambda sc, cam, idxs: sc.lights.set_location(data.light_locs[np.asarray(idxs)])

    paths, _ = train_paths(scene, spec, state, gen,
                           (make_camera, data.images, data.masks,
                            dict(light_update=light_update)),
                           dict(device_data=ddata,
                                camera_builder=lambda c: NeRFCamera(c, data.focal)), **kw)
    turns = data_path_turns(torch, f"NeRV training on generated data (3 x {NV_SIZE}^2)",
                            paths, 3 * NV_SIZE * NV_SIZE, rounds=rounds)
    return dict(counts=runs["device"][2], turns=turns)


def converge_nerv_main(torch, dev, iters: int):
    """The NeRV quality drive on the card: the generator twin (the armadillo,
    12 train and 4 test views at 64^2), then the NeRV twin on the device data
    path for ``iters`` steps (3 x 64^2, no SSIM: the ground truth is dark),
    its test in both shadow modes: PSNRs beside the black render's, pixel
    probes, and the wall time."""
    import numpy as np
    from neural_raytracing_tpu_torch.workloads import nerv
    data, test, gen_s, _ = nerv_generated(torch, dev, NV_SIZE)
    print(f"converge-nerv: generator {gen_s:.1f} s; train {pixel_probe(data.images, data.masks)}; "
          f"test {pixel_probe(test.images, test.masks)}", flush=True)
    args = twin_args(nerv, size=NV_SIZE, crop_size=NV_SIZE, iters=iters, log_every=500,
                     device=str(dev), device_data=True, no_ssim=True)
    torch.cuda.synchronize()
    start = time.perf_counter()
    state, res = nerv.run(args, data, test, save=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    gt = np.clip(test.images, 0.0, 1.0)
    print(f"converge-nerv: {state.step} steps + the test in {wall:.1f} s; final losses "
          f"{[round(x, 4) for x in res['losses'][-5:]]}")
    for tag in ("soft", "hard"):
        got = res[tag + "_images"]
        lit, lit_black = lit_psnr(got, gt)
        print(f"converge-nerv: test ({len(gt)} views, {tag} shadows): PSNR "
              f"{res[tag]['psnr']:.3f} dB, SSIM {res[tag]['ssim']:.4f}, black render "
              f"{black_psnr(gt):.3f} dB; on the pixels the GT lights (> 0.01): PSNR "
              f"{lit:.3f} dB, black {lit_black:.3f} dB; renders {pixel_probe(got)}, GT "
              f"{pixel_probe(gt, test.masks)}")


def converge_dtu_main(torch, dev, iters: int):
    """The DTU quality drive on the card: the generator twin (16 views at
    64^2, source size matched), then workloads.dtu on the device data path
    for ``iters`` steps (3 x 32^2 mask-centred crops, mask weight 10), its
    masked test on views 0 and 10: PSNR beside the black render's, pixel
    probes, and the wall time."""
    import numpy as np
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.training import evaluate
    from neural_raytracing_tpu_torch.workloads import dtu
    data, gen_s, _ = dtu_scan(torch, dev, 64, DTU_SCAN)
    print(f"converge-dtu: generator {gen_s:.1f} s; {pixel_probe(data.images, data.masks)}",
          flush=True)
    args = twin_args(dtu, size=64, crop_size=32, iters=iters, log_every=500,
                     device_data=True, device=str(dev))
    torch.cuda.synchronize()
    start = time.perf_counter()
    state, res = dtu.run(args, data, save=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    train_idx, test_idx = dtu.split(len(data.images), args.test_every)
    gt = data.images[test_idx] * data.masks[test_idx][..., None]
    lit, lit_black = lit_psnr(res["test_images"], gt)
    print(f"converge-dtu: {state.step} steps + the test in {wall:.1f} s; final losses "
          f"{[round(x, 4) for x in res['losses'][-5:]]}")
    print(f"converge-dtu: masked test (views {test_idx.tolist()}): PSNR "
          f"{res['test']['psnr']:.3f} dB, SSIM {res['test']['ssim']:.4f}, black render "
          f"{black_psnr(gt):.3f} dB; on the pixels the GT lights (> 0.01): PSNR {lit:.3f} dB, "
          f"black {lit_black:.3f} dB; renders "
          f"{pixel_probe(res['test_images'], data.masks[test_idx])}, GT "
          f"{pixel_probe(gt, data.masks[test_idx])}")
    # the held-out views of this scan are dark: the trained scene on its four
    # brightest training views too (held in, so a fit, not a generalisation)
    bright = train_idx[np.argsort([-float(np.mean(data.images[i])) for i in train_idx])[:4]]
    images = []
    out = evaluate(dtu.eval_scene(state.scene, args.eval_march_bound),
                   lambda i: dtu.camera_maker(data)([bright[i]]), data.images[bright],
                   Direct(training=False), size=args.size, chunk_size=args.size,
                   masks=data.masks[bright], log_fn=lambda s: None,
                   save_fn=lambda i, im: images.append(im))
    gt = data.images[bright] * data.masks[bright][..., None]
    lit, lit_black = lit_psnr(np.stack(images), gt)
    print(f"converge-dtu: the 4 brightest training views {bright.tolist()} (masked): PSNR "
          f"{out['psnr']:.3f} dB, black {black_psnr(gt):.3f} dB; on the lit pixels PSNR "
          f"{lit:.3f} dB, black {lit_black:.3f} dB; renders {pixel_probe(np.stack(images))}, "
          f"GT {pixel_probe(gt, data.masks[bright])}")


def converge_main(iters: int):
    """The quality drive of .claude/skills/verify/SKILL.md through the port,
    on the card: the generator twin (bunny, 64^2, a 4 x 4 grid and the whole
    relight grid, light scale 1.5), then the colocate twin (crops of 32, 4
    views, --clip-norm 10 --stable-init --light-scale 1.5) for ``iters``
    steps, its hard-shadow test on the first 8 views and the relight grid:
    PSNRs beside the black render's and pixel probes."""
    import numpy as np
    import torch
    from neural_raytracing_tpu_torch.workloads import colocate
    dev = torch.device("cuda", 0)
    data, relight, gen_s, _ = colocate_dataset(torch, dev, 64, 4, 4, range(4))
    print(f"converge: generator {gen_s:.1f} s, {len(data.images)} views + {len(relight)} "
          f"relight views {data.images.shape[1]}x{data.images.shape[2]}; "
          f"grid {pixel_probe(data.images, data.masks)}; relight "
          f"{pixel_probe(list(relight.values()))}", flush=True)
    args = twin_args(colocate, size=64, crop_size=32, n_views=4, n_elev=4, n_azim=4, iters=iters,
                         clip_norm=10.0, stable_init=True, light_scale=1.5, log_every=500,
                         kind=CO_KIND)
    torch.cuda.synchronize()
    start = time.perf_counter()
    state, res = colocate.run(args, data, relight, save=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    test = res["test"]
    n_test = len(res["test_images"])
    print(f"converge: {state.step} steps + test + relight in {wall:.1f} s; final losses "
          f"{[round(x, 4) for x in res['losses'][-5:]]}")
    print(f"converge: test (hard shadows, first {n_test} views): PSNR {test['psnr']:.3f} dB, "
          f"SSIM {test['ssim']:.4f}, black render {black_psnr(data.images[:n_test]):.3f} dB; "
          f"renders {pixel_probe(res['test_images'])}, GT "
          f"{pixel_probe(data.images[:n_test], data.masks[:n_test])}")
    psnrs = np.asarray(res["relight_psnrs"])
    gts = [gt for _, gt in sorted(relight.items())]
    lit = np.asarray([float(np.mean(gt[..., :3])) > 0.01 for gt in gts])
    print(f"converge: relight grid ({len(psnrs)} views): PSNR {psnrs.mean():.3f} dB, black "
          f"render {black_psnr(gts):.3f} dB; on its {int(lit.sum())} views whose mean GT "
          f"pixel exceeds 0.01: PSNR {psnrs[lit].mean():.3f} dB, black render "
          f"{black_psnr([g for g, keep in zip(gts, lit) if keep]):.3f} dB")


def median_busy(torch, fn, label, reps: int = 3) -> dict:
    """{busy_ms, wall_ms, launches}: the medians of ``reps`` profiles of one
    call of ``fn`` (profile_step), after one warm-up call."""
    fn()
    runs = [profile_step(torch, fn, label) for _ in range(reps)]
    check(all(r is not None for r in runs), f"{label}: the profiler saw no device time")
    return {k: sorted(r[k] for r in runs)[reps // 2] for k in runs[0]}


def colocate_turn(torch, dev):
    """-> (median_busy of one colocate training step at phase 19's shapes,
    the generator twin's ms a 200^2 view over a 2 x 2 grid)."""
    import numpy as np
    from neural_raytracing_tpu_torch.cameras import FoVPerspectiveCamera
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.training import TrainState, build_step_fn, make_optimizer
    from neural_raytracing_tpu_torch.workloads import colocate
    from neural_raytracing_tpu_torch.workloads.nerfle import colocate_cameras
    data, _, gen_s, _ = colocate_dataset(torch, dev, CO_SIZE, 2, 2, (), CO_GEN_CHUNK)
    cams = colocate_cameras(data)
    idxs = [0, 1, 2, 3]
    camera = FoVPerspectiveCamera(R=cams.R[idxs], T=cams.T[idxs])
    spec = make_optimizer(CO_LRS)
    scene = colocate.build_scene().init(torch.Generator().manual_seed(0), device=dev)
    colocate.make_light_update(cams.camera_center().numpy())(scene, None, idxs)
    step = build_step_fn(scene, Direct(training=True), spec, size=CO_SIZE, crop_size=CO_CROP,
                         extra_loss=colocate.extra_loss)
    u = v = (CO_SIZE - CO_CROP) // 2
    exp = torch.from_numpy(data.images[idxs, u:u + CO_CROP, v:v + CO_CROP]).to(dev)
    mask = torch.from_numpy(data.masks[idxs, u:u + CO_CROP, v:v + CO_CROP]).to(dev)
    state = TrainState(scene, spec.init(scene), 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    busy = median_busy(torch, lambda: step(state, camera, (u, v), exp, mask, gen),
                       "one colocate training step")
    return busy, 1e3 * gen_s / len(np.asarray(data.images))


def turn_times_main(root: str):
    """``python3 chip_smoke.py --turn-times [DIR]``: for the package in DIR
    (this checkout's by default), one JSON line: K8's device ms on cold
    inputs at COMPOSITE_SHAPES and K5's ms a call at K5_SHAPES (phase 3's
    surface), each through its default route, with a digest of their
    outputs; and the device busy ms (median of three profiles) of one NeRFLE
    eval view, one flagship training step, one NeRV eval view with
    fused_sdf=True and one colocate training step; and the colocate
    generator's ms a view.  To compare two trees in one call: unpack the
    other with git archive into the ignored scratch_trees/ and run parent,
    change, change, parent."""
    import hashlib

    import numpy as np
    import torch
    sys.path.insert(0, str(Path(root).resolve()))
    import neural_raytracing_tpu_torch
    from neural_raytracing_tpu_torch.cameras import NeRFCamera
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.kernels import (
        FusedSphereSDF, _build, fused_composite, fused_sphere_sdf,
    )
    from neural_raytracing_tpu_torch.training import TrainState, build_step_fn, make_optimizer
    from neural_raytracing_tpu_torch.workloads import nerf_synthetic
    from neural_raytracing_tpu_torch.workloads.nerfle import colocate_cameras
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build()
    out = {"package": neural_raytracing_tpu_torch.__file__, "k8_ms": {}, "k5_ms": {}}
    h = hashlib.sha256()
    for n_t, n_r in COMPOSITE_SHAPES:
        sigma, rgb, ts, _ = composite_inputs(torch, dev, n_t, n_r)
        h.update(fused_composite(sigma, rgb, ts).cpu().numpy().tobytes())
        t = composite_cold(torch, sigma, rgb, ts, {"k8": fused_composite}, turns=False)
        out["k8_ms"][f"{n_t}x{n_r}"] = t["k8"][0]
    out["k8_digest"] = h.hexdigest()[:16]
    h = hashlib.sha256()
    surface = FusedSphereSDF(n=128, mlp=flagship_nets()["sdf_shift 8x128 F32"])
    surface.load_state_dict(march_surface(torch, "cpu").state_dict())
    surface.to(dev)
    x = (2.4 * torch.rand(N_POINTS, 3, generator=torch.Generator().manual_seed(11))
         - 1.2).to(dev)
    with torch.no_grad():
        for shape, n in K5_SHAPES.items():
            xs = x[:n].contiguous()
            h.update(fused_sphere_sdf(surface, xs).cpu().numpy().tobytes())
            out["k5_ms"][shape] = cuda_ms(batch_ms(lambda: fused_sphere_sdf(surface, xs)), 5) / 20
    out["k5_digest"] = h.hexdigest()[:16]

    busy = {}
    data = colocate_gt(torch)
    cams = colocate_cameras(data)
    scene = nerfle_scene(torch, dev)
    busy["NeRFLE eval view"] = median_busy(
        torch, lambda: nerfle_eval(torch, scene, cams, data.images[:1]), "one NeRFLE eval view")
    del scene, data
    c2ws = train_c2ws()
    imgs, masks = sphere_gt(torch, c2ws)
    spec = make_optimizer(LRS)
    scene = nerf_synthetic.build_scene(max_steps=64, march_bound=None)
    scene.init(torch.Generator().manual_seed(0), device=dev)
    state = TrainState(scene, spec.init(scene), 0)
    step = build_step_fn(scene, Direct(training=True), spec, size=SIZE, crop_size=CROP_SIZE)
    idxs = list(range(N_VIEWS))
    u, v = silhouette_crop()
    exp = torch.from_numpy(imgs[idxs, u:u + CROP_SIZE, v:v + CROP_SIZE]).to(dev)
    mask = torch.from_numpy(masks[idxs, u:u + CROP_SIZE, v:v + CROP_SIZE]).to(dev)
    camera = NeRFCamera(torch.from_numpy(c2ws[np.asarray(idxs)]), FOCAL)
    gen = torch.Generator(device=dev).manual_seed(1)
    busy["flagship training step"] = median_busy(
        torch, lambda: step(state, camera, (u, v), exp, mask, gen), "one training step")
    del scene, state, step
    scene = nerv_scene(torch, dev, 128, 1.2, "learned", fused_sdf=True)
    locs = scene.lights.location.detach().clone()
    camera_fn = lambda i: nerv_camera(torch, NERV_EVAL_VIEWS[i:i + 1])
    busy["NeRV eval view, fused_sdf"] = median_busy(
        torch, lambda: nerv_evaluate(torch, scene, camera_fn, 1, locs),
        "one NeRV eval view, fused_sdf=True")
    del scene
    busy["colocate training step"], out["generator_ms_view"] = colocate_turn(torch, dev)
    out["busy"] = busy
    print(json.dumps(out))


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an "
             "NVIDIA GPU")
    if sys.argv[1:2] == ["--march-times"]:
        march_times_main(sys.argv[2] if len(sys.argv) > 2 else str(ROOT))
        return
    if sys.argv[1:2] == ["--turn-times"]:
        turn_times_main(sys.argv[2] if len(sys.argv) > 2 else str(ROOT))
        return
    sys.path.insert(0, str(ROOT))
    import neural_raytracing_tpu_torch
    if not Path(neural_raytracing_tpu_torch.__file__).resolve().is_relative_to(ROOT):
        fail("neural_raytracing_tpu_torch must be the package beside this script")
    from neural_raytracing_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in IEEE f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(card())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    print("kernels: fused_mlp_forward, fused_march, fused_min_scan, "
          "fused_mlp_backward, fused_mlp_ckpt_forward, fused_mlp_segment_backward, "
          "pack_tile_transposes, "
          "fused_shadow_march, fused_sphere_sdf, fused_composite, and the bf16-operand "
          "fused_mlp_forward_bf16, fused_march_bf16, fused_min_scan_bf16, "
          "fused_shadow_march_bf16")
    secs = _build.build()
    print(f"kernel build: {secs:.1f} s")
    for stem in sorted(_build.library_paths()):
        for line in _build.ptxas_report(stem).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {stem}: {line.strip()}")

    if sys.argv[1:2] == ["--bwd"]:
        phase_backward(torch, dev)
        return
    if sys.argv[1:2] == ["--colocate"]:
        phase_colocate(torch, dev)
        return
    if sys.argv[1:2] == ["--converge"]:
        converge_main(int(sys.argv[2]) if len(sys.argv) > 2 else 8000)
        return
    if sys.argv[1:2] == ["--dtu"]:
        phase_dtu(torch, dev)
        return
    if sys.argv[1:2] == ["--data-paths"]:
        rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 5
        phase_dtu(torch, dev, rounds)
        phase_nerv_generated(torch, dev, rounds)
        return
    if sys.argv[1:2] == ["--converge-nerv"]:
        converge_nerv_main(torch, dev, int(sys.argv[2]) if len(sys.argv) > 2 else 4000)
        return
    if sys.argv[1:2] == ["--converge-dtu"]:
        converge_dtu_main(torch, dev, int(sys.argv[2]) if len(sys.argv) > 2 else 4000)
        return
    k1 = phase_mlp(torch, dev)
    if sys.argv[1:2] == ["--k1"]:
        bf16_k1(torch, dev)
        return
    k2 = phase_march(torch, dev)
    k2_shapes = phase_march_shapes(torch, dev)
    eval_views = [(30.0, 45.0), (30.0, 165.0), (30.0, 285.0)]
    counts = phase_slice(torch, dev, "eval render (bounded, 256 steps)", 256, 1.2,
                         eval_views, profile=True)
    phase_slice(torch, dev, "validation render (unbounded, 64 steps)", 64, None,
                [(30.0, 45.0)], profile=True)
    k3 = phase_minscan(torch, dev)
    kb = phase_backward(torch, dev)
    train_counts, step_s, _ = phase_train(torch, dev)
    k4 = phase_shadow(torch, dev)
    k5 = phase_fused_sdf(torch, dev)
    nerv_counts = phase_nerv_eval(torch, dev)
    nerv_train_counts, nerv_step_s = phase_nerv_train(torch, dev)
    k8 = phase_composite(torch, dev)
    le_data = colocate_gt(torch)
    le_counts = phase_nerfle_eval(torch, dev, le_data)
    le_train_counts, le_step_s = phase_nerfle_train(torch, dev, le_data)
    k2r, orbit_counts = phase_relaxed_march(torch, dev)
    kb16 = phase_bf16_kernels(torch, dev, k4["step_ms"])
    bf16_eval_counts, bf16_train_counts = phase_bf16_flagship(torch, dev)
    bf16_nerv_counts = phase_bf16_nerv(torch, dev)
    co = phase_colocate(torch, dev)
    dt = phase_dtu(torch, dev)
    nv = phase_nerv_generated(torch, dev)

    def entry(name, source, replaces, launches, m):
        e = dict(name=name, route="cuda", source=f"neural_raytracing_tpu_torch/csrc/{source}",
                 replaces=f"neural_raytracing_tpu/kernels/{replaces}",
                 launches=launches, max_abs_err=m["err"], ms=m["ms"],
                 plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
                 bound_by=m["bound_by"], library_ms=None)
        # K3 and K3-bf16 (redesigned): the half-res shape, the occupancy, the
        # sample segments, and K3-bf16's two bounds; K8: what timed it
        for key in ("half_res_ms", "half_res_bound_ms", "blocks_per_sm",
                    "indices_differ", "tensor_core_bound_ms", "elementwise_floor_ms",
                    "segments", "one_segment_ms", "half_res_one_segment_ms", "timed_by",
                    "registers", "local_bytes", "live_row_share", "evals_per_ms",
                    "eval_tile_ms", "eval_chunk_ms", "eval_chunk_bound_ms",
                    "training_call_ms", "training_call_bound_ms", "path_ms",
                    "path_bound_ms", "parent_ms", "eval_tile_ms", "eval_tile_parent_ms",
                    "path_parent_ms", "kernel_ms", "path_kernel_ms", "same_bits"):
            if key in m:
                e[key] = m[key]
        return e

    def entry16(*args):
        # bound_ms is the bf16 tensor-core bound; the f32-FMA one beside it
        e = entry(*args)
        e["f32_fma_bound_ms"] = args[-1]["f32_bound_ms"]
        return e

    # K2 and K2-bf16 (redesigned): also their time on one eval tile
    k2["bounded"]["eval_tile_ms"] = k2_shapes["eval tile"]["ms"]
    kb16["k2 bounded"]["eval_tile_ms"] = k2_shapes["eval tile"]["bf16_ms"]
    kernels = [
        entry("fused_mlp_forward", "fused_mlp_tile.cu", "fused_mlp.py:129",
              counts["fused_mlp_forward"], k1),
        entry("pack_tile_weights", "fused_mlp_tile.cu",
              "fused_mlp.py:129 (the weights _pallas_forward hands its kernel, cast at :77-91)",
              train_counts["pack_tile_weights"], k1["pack"]),
        entry("fused_march", "fused_march.cu", "fused_march.py:405",
              counts["fused_march"], k2["bounded"]),
        entry("fused_min_scan", "fused_minscan.cu", "fused_march.py:482",
              train_counts["fused_min_scan"], k3),
        entry("fused_mlp_backward", "fused_mlp_bwd_tile.cu", "fused_mlp.py:268",
              train_counts["fused_mlp_backward"], kb["k6"]),
        entry("pack_tile_transposes", "fused_mlp_bwd_tile.cu",
              "fused_mlp.py:268 (the W^T _build_bwd_kernel takes in its body, :206-222)",
              train_counts["pack_tile_transposes"], kb["pack"]),
        entry("fused_mlp_ckpt_forward", "fused_mlp_bwd_tile.cu", "fused_mlp.py:449",
              train_counts["fused_mlp_ckpt_forward"], kb["k7a"]),
        entry("fused_mlp_segment_backward", "fused_mlp_bwd_tile.cu", "fused_mlp.py:476",
              train_counts["fused_mlp_segment_backward"], kb["k7b"]),
        entry("fused_shadow_march", "fused_shadow.cu", "fused_march.py:445",
              nerv_counts["learned"]["fused_shadow_march"], k4),
        entry("fused_sphere_sdf", "fused_sdf.cu", "fused_sdf.py:133",
              nerv_counts["fused_sdf"]["fused_sphere_sdf"], k5),
        entry("K8_fused_composite", "composite.cu", "composite.py:74",
              le_counts["fused_composite"], k8),
        entry("K2_relaxed_fused_march", "fused_march.cu", "fused_march.py:405",
              orbit_counts["fused_march"], k2r),
        entry16("fused_mlp_forward_bf16", "fused_mlp_tile.cu",
              "fused_mlp.py:129 (bf16 operands: fused_mlp.py:44-91)",
              bf16_eval_counts["fused_mlp_forward_bf16"], kb16["k1"]),
        entry16("fused_march_bf16", "fused_march.cu",
              "fused_march.py:405 (bf16 operands: fused_march.py:65-75,78-130)",
              bf16_eval_counts["fused_march_bf16"], kb16["k2 bounded"]),
        entry16("fused_min_scan_bf16", "fused_minscan.cu",
              "fused_march.py:482 (bf16 operands: fused_march.py:65-75,78-130)",
              bf16_train_counts["fused_min_scan_bf16"], kb16["k3"]),
        entry16("fused_shadow_march_bf16", "fused_shadow.cu",
              "fused_march.py:445 (bf16 operands: fused_march.py:65-75,78-130)",
              bf16_nerv_counts["learned"]["fused_shadow_march_bf16"], kb16["k4"]),
    ]
    print(f"training step (kernels): {1e3 * step_s:.1f} ms/step, "
          f"{N_RAYS / step_s:,.0f} rays/s; NeRV training step {1e3 * nerv_step_s:.1f} "
          f"ms/step, {NERV_RAYS / nerv_step_s:,.0f} rays/s, K4 launches "
          f"{nerv_train_counts['fused_shadow_march']}; NeRFLE training step "
          f"{1e3 * le_step_s:.1f} ms/step, {LE_RAYS / le_step_s:,.0f} rays/s, K8 launches "
          f"{le_train_counts['fused_composite']}; colocate training step "
          f"{co['step_ms']:.1f} ms/step, {CO_RAYS / co['step_ms'] * 1e3:,.0f} rays/s, test "
          f"view {co['ms_view']:.1f} ms/view; DTU training step, host / device data path "
          f"{dt['turns']['host']['ms']:.1f} / {dt['turns']['device']['ms']:.1f} ms/step; NeRV "
          f"on generated data {nv['turns']['host']['ms']:.1f} / "
          f"{nv['turns']['device']['ms']:.1f} ms/step")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
