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
     step (a replay of its CUDA graph); the step with each backward route of
     the shading nets (the autograd recompute, K6, K7; each route its own
     graph) timed in turns, then one profile each (device busy ms,
     launches), every net on the tile route; evaluate on 2 views;
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
     shadow modes; then the two paths in turns on the trained scene;
 22. Monte Carlo transport on the trained NeRV checkpoint (128 steps,
     bounded 1.2, hard shadows, light 0): (a) one 200x200 view (chunk 100,
     bundle 1) through pathtrace with Path(max_depth=2) against the same
     view inside plain_kernels() with the same generator seeds (so the same
     draws), counts reset just before and read just after: K1 on the tile,
     K2 and K4 twice a tile (the primary and the bounce march; the two
     bounces' shadow rays); (b) Path(max_depth=1) against Direct(training=
     False) on that view (a delta light: only the camera jitter draws), and
     Path depth 2's mean at or above Direct's; (c) Direct and Path depth 2
     timed in turns (A, B, B, A), a profile of one Path view (busy ms, idle
     share, launches, K1-K4's ms a launch), then K2 at one tile's primary and
     bounce launch against march_plain (the SDF evaluations per ray, the hit
     flags ray by ray, ms, bound, live share); (f) Direct(emitter_samples=1,
     bsdf_samples=1) with the lights replaced by Constant(5, 0.5) on that
     view against plain_kernels() (K2 once and K4 twice a tile: both arms'
     shadow rays), then K4 against shadow_march_plain (shadow_check) at the
     emitter arm's shadow rays (max_t 10) and the BSDF arm's (max_t the
     ray's distance to the light sphere); (g) one 128x128 frame of
     workloads.render.main --workload nerv with --integrator debug, depth,
     silhouette and path (K2 counted); (e) on the NeRV generator's data
     (phase 21's; made here with --path): one Path(max_depth=2) training
     step of the NeRV twin's scene (seed-0 weights, 3 x 64^2, the device
     data path, the draws pinned) against the same step inside
     plain_kernels(), 10 counted steps of workloads.nerv.run
     --train-integrator path on the device data path (K1-K4), then the Path
     and the Direct step in turns, each profiled (busy ms, launches, K1-K4's
     ms a launch), its waits for the card (sync_sites, the Path step's no
     more than the Direct step's) and its peak memory
     (torch.cuda.max_memory_allocated over one step); (d)
     workloads.path_nerv.run on the scene phase 21 trained (with --path:
     (e)'s) and the 4 test views at 64^2, 4 passes, its PSNR beside
     Direct's and the black render's, a pixel probe (a pipeline check, not
     a quality figure).
 23. scene editing and the test-split entry points: (a)
     workloads.edit_nerf on the flagship scene with phase 3's seeded shift
     (saved with save_scene) and one 256^2 NeRF-layout test view of the NeRV
     generator twin, 256 steps, under each --edit (none, bend, trans, hole,
     scale_z, disp): counted (K1 on the tile; K2 once a tile for none and
     never under an edit; no K3 or K4), against plain_kernels(); bend
     --bend-k 0 (the plain warped loop) against none (K2); none's and
     bend's ms/view in turns and one profile each; (b) workloads.edit_dtu at
     128^2, 128 steps, on a generated scan view, the DTU scene with the same
     shift: bend, disp and --recolor 0, Direct and Debug, counted and against
     plain_kernels(); (c) workloads.eval_nerv on the checkpoint at 200^2,
     hard shadows, two frames of two of its lights with weights (0.7, 0.3):
     counted (K2 and K4 once a tile and light), against plain_kernels(), and
     each frame against the weighted sum of its single-light renders (the
     same keys); (d) shapes.prime on SDF(phase 3's SphereSDF(128)) onto
     sphere_sdf, 200 steps of 4,096 points (the loss falls; the first step's
     loss on the kernel route against plain_kernels()), nn.prime_identity
     on a 10x256 net (the loss falls); (e) RoundBoxSDF, CapsuleSDF and
     ParametricSDFSet, a 128^2 Depth render each on the card against the
     CPU, and NeRFMMCamera's and NeRVCamera's rays on the card against the
     CPU.
 24. the hash-encoded surface and the rest of the NeRF family: (a) the
     flagship of workloads.nerf_synthetic.build_scene(surface="hash")
     (HashSDF() at its defaults: 8 levels of 2^14 x 2, resolutions 16-512,
     bound 2; seed-0 weights) on phase 7's GT: one 256^2 test view (256
     steps, bounded 1.2) and three 6 x 80^2 training steps, each counted
     (K1 for the shading nets; none of K2-K5: the plain loops march the
     hash surface) and against plain_kernels(); workloads.nerf_synthetic.run
     --surface hash for 6 steps (the loss of a fixed batch falls; the
     artifacts reload equal); (b) HashEncoding() on the card against the CPU
     at 65,536 points (forward, the gradients to the tables and the points;
     the tables' gradient twice: the same bits?), its forward and
     backward timed; (c) the hash flagship against the sphere flagship in
     turns (a, b, b, a): a test view and a training step, wall, busy, idle
     share and launches (the view profiled through pathtrace at one tile's
     size), the launches of one plain march step at an eval tile (the
     wrappers' counts, and three profiles' device kernels beside the host's
     launch calls), the peak memory of a step; (d) the NeRV checkpoint at
     200^2 under NeuralApprox (K2 once a tile, no K4) and under Direct with
     a seeded GlobalNeuralBSDF and its BSDF arm under Constant(5, 0.5), hard
     shadows (K2 once, K4 twice a tile), counted and against
     plain_kernels(); TwoStageMLP, AutoDecoder, PartitionedAutoDecoder,
     MipMap, SphericalHarmonics.fit, permute_kensler and OrthogonalSampler
     (dims 0-1) on the card against the CPU; NeuralWarp.prime, 300 steps
     (the loss falls).
 25. triangle meshes, the rasterizers, the native host ops and the mesh
     ground truth: (a) TriangleMesh on the card (the gear with its 0.7 mirror
     plate, 84 faces, one chunk; the knot, 6,400 faces, 25 chunks) on the
     40,000 camera rays of a 200^2 view at distance 2 and shadow rays from
     their hits, intersect and intersect_test against the CPU (every 8th
     ray of the knot) and backend="native", ms a call and launch calls an
     intersect; (b) the knot by a FoVPerspectiveCamera at 256^2, 8 faces a
     pixel, naive and binned (bin 32) equal on the card, and the points,
     spheres and PulsarRenderer with gradients, ms each; (c)
     workloads.make_mesh_dataset.run for the mirror GT of RESULTS.md:209 at
     200^2 (gear, plate 0.7, nerv, camera distance 2, z up, elevation 8-55,
     Path depth 2, auto-exposure), 6 train and 3 test views at 4 passes (of
     the published 100, 16 and 16), no K1-K5 launch, ms a view and a pass,
     launch calls a pass; (d) workloads.path_demo.run on (c)'s test views,
     the PSNR of Direct and Path a view (Path ahead on average); (e)
     workloads.seed_shape.run for the gear and plate, 300 of its 3,000
     iterations at batch 8,192 (K1 counted; the Huber loss falls), the
     scene saved; (f) from the seeded scene one NeRV step with hard
     occlusion on (c)'s data against plain_kernels() (K1-K4 counted), then
     workloads.nerv.run --load with the published flags for 10 steps (K1-K4
     counted) and a test view in both shadow modes beside the black render;
     (g) make_dtu_dataset --mesh knot at 64^2 (6 views, no K1-K5 launch),
     workloads.dtu.run for 10 steps on it (K1-K3 counted) and its masked
     test view;
 26. data parallelism and the last twins: (a) in an NCCL process group of
     one, train(mesh=parallel.make_mesh()) for 3 steps of phase 7's flagship
     step (6 views x 80^2 crops of its GT, seed-0 weights, a seeded
     generator) against train(mesh=None) from the same state, in turns
     after a warm-up step of each (plain, mesh, mesh, plain): the losses' bits,
     every parameter's bits and the K1, K2 and K3 launch counts the same,
     ms a step of each; the step alone, warm, in turns with the plain step
     (CUDA events) and one profile of each; one step under the mesh with
     kernel_bwd (K6 counted); sharded_render_rays on one 128^2 eval tile
     (256 steps, bounded) against Direct.sample, the same bits; (b)
     workloads.fit_sphere.run at 64^2 for 100 iterations (K1,
     K2 and K3 counted; the loss falls) and its evaluate; (c) the
     visualization twins (workloads.visualize, nerv_vis, dtu_vis) on models
     that 2 steps of workloads.nerf_synthetic.run, nerv.run and dtu.run
     saved, on phase 7's GT and data the NeRV and DTU generator twins make
     here (64^2): every image finite, the normal maps, the weight maps and
     the flagship's render non-black on the pixels where the scene's
     surface is hit (K1 and K2 counted); (d) workloads.exp_gan.train_gan
     for 5 steps at 64^2 with 2 views on in-memory real images (K8
     counted); (e) profiling.trace over one data-parallel step: a trace
     file written with the profiling.annotate range in it;
 27. the JAX options the port takes (ComposeSpatialVarying's preprocess,
     Conductor's activation and threshold, train's step_fn,
     look_at_view_transform's eye): (a) a 128^2 eval view of the flagship
     scene (256 steps, bounded 1.2, seed-0 weights) with a non-identity
     affine preprocess before the 16x256 weight net, against
     plain_kernels() (K1 and K2 counted), and the weight net's input
     gradient through the preprocess on 16,384 points against the plain
     version's; (b) the colocate scene with Conductor(activation="softplus",
     threshold=0.9) on one 200^2 test view with hard shadows from a relight
     light (K1, K2 and K4 counted) against plain_kernels(), then the same
     weights and key with Conductor("sigmoid", 0.94) and Conductor(): the
     same bits; (c) 3 flagship training steps (6 x 80^2) through
     train(step_fn=build_step_fn(...)) against train() without it: the
     same losses' and parameters' bits (K1, K2 and K3 counted); (d)
     look_at_view_transform(eye=) on the card at the centres of 1,000
     (dist, elev, azim) against the spherical form.
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
phases 4 and 7; phase 22's Path and BSDF-arm views against
plain_kernels() as phase 4 (mask agreement >= 99%, mean |difference| <=
1e-3: a bounce or shadow ray that flips its hit moves its pixel's whole
term, so no maximum is held), Path depth 1 against Direct within 1e-6 (the
same arithmetic), K2's bounce launch as K2, K4 at Direct's arms as K4, the
Path training step as phase 11 (loss within 1e-4 relative, each component's
gradient within 1e-2 relative L2); phase 23's edited renders against
plain_kernels() as phase 4, bend --bend-k 0 against none likewise (the
plain loop and K2 sum in another order), the multi-light image against the
weighted sum of its single-light renders within 1e-6 (the same kernels and
sums), prime's first loss on the kernel route within 1e-4 relative of
plain, and the new surfaces' depths and the cameras' rays on the card
within 1e-3 and 1e-5 of the CPU's; phase 24's hash view and steps as
phases 4 and 7 (the plain loops are the same code on both sides, only K1
differs), HashEncoding on the card within 1e-5 of the CPU relative to the
largest value (the tables' gradient is a scatter-add: its sums may meet in
another order), its NeRF-family views as
phase 22's, its modules on the card within 1e-4 of the CPU relative to the
largest output (1e-3 for the least-squares fit, another LAPACK routine; 1e-6 for
MipMap's pdf) and the samplers' integers equal; phase 25's TriangleMesh on
the card against the CPU and the native backend hits and shadow flags
agreeing on >= 99.9% of the rays (a ray through a shared edge hits by the
last bit of a product, and each device contracts its products otherwise)
and |t difference| <= 1e-4 where both hit, the binned rasterizer's
fragments equal to the naive one's bit for bit (the same arithmetic a
pixel, stable sorts), the NeRV step on the mesh data as phase 11's;
phase 27's views against plain_kernels() as phase 4's, the weight net's
input gradient within 1e-4 of max|plain| (K5's derivatives' tolerance),
the eye form's R and T within 1e-6 of the spherical form's.

    python3 chip_smoke.py --parallel

runs phases 1 and 26 only (no result line).

    python3 chip_smoke.py --options

runs phases 1 and 27 only (no result line).

    python3 chip_smoke.py --hash

runs phases 1 and 24 only (no result line).

    python3 chip_smoke.py --mesh

runs phases 1 and 25 only (no result line).

    python3 chip_smoke.py --edit

runs phases 1 and 23 only (no result line).

    python3 chip_smoke.py --path

runs phases 1 and 22 only (no result line).

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
    # the host's launch calls, recorded on the CPU side of the same trace: a
    # device kernel the trace lost shows as fewer kernels than these
    host_launches = sum(e.count for e in prof.key_averages()
                        if e.device_type == DeviceType.CPU
                        and e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    device_kernels = sum(e.count for e in kernels if not e.key.startswith(("Memset", "Memcpy")))
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    rest = ranked[14:]
    print(f"  profile of {label}: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall "
          f"under the profiler (idle share {1 - busy_ms / wall_ms:.3f}), "
          f"{sum(e.count for e in kernels)} kernel launches (device kernels {device_kernels}, "
          f"host launch calls {host_launches}); top kernels:")
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
    return dict(busy_ms=busy_ms, wall_ms=wall_ms, launches=sum(e.count for e in kernels),
                device_kernels=device_kernels, host_launches=host_launches)


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


def graphed(torch, one_step):
    """Two calls of ``one_step``, a live training step: where its CUDA graph
    for the scene's routes is not yet captured, the first runs eagerly and
    the second captures it, so the calls after them replay it."""
    for _ in range(2):
        one_step()
    torch.cuda.synchronize()


def step_routes(torch, scene, one_step, reps: int = 3):
    """The flagship step with each of STEP_ROUTES: the wall ms a step (host
    clock, synchronised; the median of ``reps`` steps a turn, the routes in
    turns a, b, c, c, b, a), then one profile each (device busy ms,
    launches); every shading net on the tile route.  A route is part of
    the step's graph key, so each is timed and profiled as its own graph's
    replays."""
    from neural_raytracing_tpu_torch.kernels import reset_launch_counts

    def timed(route):
        set_kernel_bwd(torch, scene, *STEP_ROUTES[route])
        graphed(torch, one_step)
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
        graphed(torch, one_step)
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
    graphed(torch, one_step)
    profile_step(torch, one_step, "one training step (kernels), a replay of its graph")
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
                                                 past_light_exit=True, compute_dtype=dt)
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
    zero, kw = torch.zeros_like(r_o), dict(max_steps=64, epsilon=1e-3, past_light_exit=True)
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
    return dict(counts=runs["device"][2], turns=turns, data=data, test=test, state=state)


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


# ---- slice 14: Monte Carlo transport (Path, Direct's BSDF arm, the debug integrators) ---

PATH_TILES = (NERV_SIZE // NERV_CHUNK) ** 2                # 4 tiles of 10,000 rays a view


def path_view(torch, dev, scene, integrator, key: int = 0):
    """One 200^2 view of NeRV eval view 0 through ``pathtrace`` (chunk 100,
    bundle 1, background 0, the tiles' generators seeded from ``key``)."""
    from neural_raytracing_tpu_torch.render import pathtrace
    img, _ = pathtrace(scene, nerv_camera(torch, NERV_EVAL_VIEWS[:1]), integrator,
                       size=NERV_SIZE, chunk_size=NERV_CHUNK, bundle_size=1, background=0.0,
                       key=key, device=dev)
    return img


def counted_view(torch, label, fn, per_tile: dict):
    """``fn()`` once as a warm-up, then once with the launch counts reset
    just before and read just after: each kernel of ``per_tile`` launched
    that many times a tile, every fused net on the tile.  -> (its image,
    the counts)."""
    from neural_raytracing_tpu_torch.kernels import launch_counts, reset_launch_counts
    fn()
    reset_launch_counts()
    img = fn()
    torch.cuda.synchronize()
    counts = launch_counts()
    k1_routes(label)
    check(counts["fused_mlp_forward"] > 0, f"{label}: K1 was not launched")
    for name, n in per_tile.items():
        check(counts[name] == n * PATH_TILES,
              f"{label}: {name} launched {counts[name]} times, not {n} a tile")
    return img, counts


def bounce_rays(torch, scene, gen):
    """The bounce rays of one 100^2 tile of NeRV eval view 0 (light 0):
    the primary hit, one BSDF sample from ``gen``, and the ray from the
    offset hit point in the sampled direction, as ``Path`` spawns them ->
    (the interaction, the hit mask, r_o, r_d), flat."""
    from neural_raytracing_tpu_torch.render import _tile_positions
    dev = scene.shape.centers.device
    cam = nerv_camera(torch, NERV_EVAL_VIEWS[:1]).to(dev)
    rays = cam.sample_positions(_tile_positions(0.0, 0.0, NERV_CHUNK, dev),
                                size=NERV_SIZE).reshape(-1, 6)
    with torch.no_grad():
        it, hit = scene.shape.intersect(rays, primary=False)
        bs, _ = scene.bsdf.sample(it, gen, hit)
        new = it.spawn_rays(it.from_local(bs.wo))
    return it, hit, new[:, :3].contiguous(), new[:, 3:].contiguous()


def march_bound_fn(module):
    """K2's and K4's bound: the SDF evaluations the rays need x (2 x the
    shift net's multiply-adds + 31 x the spheres), the rays' bytes."""
    per_eval = 2.0 * mlp_macs(module.shift) + 31.0 * module.n
    return lambda n, evals: bound_ms(4 * n * 7 + n + weight_bytes(module.shift)
                                     + 4 * 13 * module.n, per_eval * evals)


def bounce_launch(torch, dev, scene):
    """K2 at the bounce launch of one tile against march_plain (hit flags
    ray by ray, depths where both hit), its SDF evaluations per ray and live
    share beside the primary launch's, ms and bound.  -> {label: {...}}."""
    from neural_raytracing_tpu_torch.kernels import fused_march, march_plain
    from neural_raytracing_tpu_torch.render import _tile_positions
    from neural_raytracing_tpu_torch.shapes import march_interval
    module = scene.shape.module
    bound = march_bound_fn(module)
    _, _, b_o, b_d = bounce_rays(torch, scene, torch.Generator(device=dev).manual_seed(7))
    cam = nerv_camera(torch, NERV_EVAL_VIEWS[:1]).to(dev)
    prim = cam.sample_positions(_tile_positions(0.0, 0.0, NERV_CHUNK, dev),
                                size=NERV_SIZE).reshape(-1, 6)
    out = {}
    for label, r_o, r_d in (("primary", prim[:, :3].contiguous(), prim[:, 3:].contiguous()),
                            ("bounce", b_o, b_d)):
        t0, t1 = march_interval(r_o, r_d, 1.2, 10.0)
        kw = dict(max_steps=128, epsilon=scene.shape.epsilon, t_start=t0)
        stats = torch.zeros(3, dtype=torch.int64, device=dev)
        depth, khit = fused_march(module, r_o, r_d, t1, stats=stats, **kw)
        pdepth, phit, evals = march_plain(module, r_o, r_d, t1, t0, max_steps=128,
                                          epsilon=scene.shape.epsilon)
        agree = (khit == phit).float().mean().item()
        both = khit & phit
        derr = (depth - pdepth)[both].abs().max().item() if both.any() else 0.0
        check(agree >= 0.99, f"K2 {label} launch: hit agreement {agree:.4f} < 0.99")
        check(derr <= 1e-3, f"K2 {label} launch: max |depth err| {derr:.3e} > 1e-3")
        dist = eval_distribution(evals)
        ms = cuda_ms(lambda: fused_march(module, r_o, r_d, t1, **kw), 5)
        b_ms, b_by = bound(r_o.shape[0], dist["total"])
        steps, rows, live = (int(x) for x in stats.tolist())
        out[label] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, dist=dist,
                          live_row_share=live / max(rows, 1), agree=agree,
                          hits=phit.float().mean().item())
        print(f"K2 at the {label} launch of one Path tile ({r_o.shape[0]} rays, 128 steps, "
              f"bounded 1.2; bounce rays from p + 5 eps n of the primary march's end points, "
              f"the missed rays' too): SDF evaluations per ray mean {dist['mean']:.2f}, median "
              f"{dist['p50']:.0f}, 99th percentile {dist['p99']:.0f}, most {dist['max']}; hit "
              f"fraction {out[label]['hits']:.4f}, hit agreement with march_plain "
              f"{agree:.6f} ({int((khit != phit).sum())} rays differ), max |depth err| "
              f"{derr:.3e}; {ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), live share of the rows "
              f"{out[label]['live_row_share']:.3f}, {steps} tile steps")
    return out


def constant_shadow_shapes(torch, dev, scene):
    """K4 against shadow_march_plain (shadow_check) at the shadow launches of
    Direct's two arms under Constant on one tile: the emitter arm's (the
    light's uniform direction, max_t 10) and the BSDF arm's (the sampled
    direction, max_t the ray's distance to the light sphere, up to ~6).
    -> {label: (ms, bound_ms, bound_by)}."""
    from neural_raytracing_tpu_torch.kernels import fused_shadow_march
    module = scene.shape.module
    bound = march_bound_fn(module)
    it, hit, b_o, b_d = bounce_rays(torch, scene, torch.Generator(device=dev).manual_seed(8))
    light_t, _ = scene.lights.intersect(torch.cat([b_o, b_d], -1))
    with torch.no_grad():
        ds, _ = scene.lights.sample_direction(it, torch.Generator(device=dev).manual_seed(9),
                                              hit)
    kw = dict(max_steps=128, epsilon=scene.shape.epsilon, past_light_exit=True)
    kernel = lambda r_o, r_d, mt, **k: fused_shadow_march(module, r_o, r_d, mt, **k)
    out = {}
    for label, r_o, r_d, mt in (
            ("emitter arm (max_t 10)", it.p.contiguous(), ds.d.contiguous(),
             ds.dist.contiguous()),
            ("BSDF arm (max_t Constant.intersect)", b_o, b_d, light_t.contiguous())):
        pnb, evals, st, agree, n_zero, _ = shadow_check(torch, f"K4 {label}", kernel, module,
                                                        (r_o, r_d, mt, hit), kw)
        blocked = (~pnb[hit]).float().mean().item()
        check(0.0 < blocked < 1.0, f"K4 {label}: blocked fraction {blocked:.4f} not in (0, 1)")
        dist = eval_distribution(evals)
        ms = cuda_ms(lambda: kernel(r_o, r_d, mt, **kw), 5)
        b_ms, b_by = bound(r_o.shape[0], dist["total"])
        out[label] = (ms, b_ms, b_by)
        print(f"K4 at Direct's {label} under Constant, one tile ({r_o.shape[0]} rays, 128 "
              f"steps): max_t {mt[hit].min().item():.3f}-{mt[hit].max().item():.3f}; SDF "
              f"evaluations per ray mean {dist['mean']:.2f}, most {dist['max']}; blocked "
              f"fraction of the hits {blocked:.4f}, not-blocked agreement {agree:.6f}, the same "
              f"bits across launches and permutations, {n_zero} zero-direction rays equal to "
              f"the plain loop's; {ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), live share "
              f"{st[2] / max(st[1], 1):.3f}")
    return out


def path_training(torch, dev, data):
    """(e) Path training on generated NeRV data: one step against the same
    step inside plain_kernels() (the views and corner pinned, the same
    generator seed: the same draws); 10 counted steps of workloads.nerv.run
    --train-integrator path on the device data path; the Path and the
    Direct step in turns on the device data path (ms/step, busy, waits,
    peak memory).  -> {"path": {...}, "direct": {...}, "counts": ...}."""
    import copy

    import numpy as np
    from neural_raytracing_tpu_torch.cameras import NeRFCamera
    from neural_raytracing_tpu_torch.integrators import Direct, Path
    from neural_raytracing_tpu_torch.kernels import launch_counts, reset_launch_counts
    from neural_raytracing_tpu_torch.training import (
        TrainState, device_dataset, make_device_data_step, make_optimizer, rand_uv_mask, train,
    )
    from neural_raytracing_tpu_torch.workloads import nerv

    spec = make_optimizer(NERV_LRS)
    builder = lambda c: NeRFCamera(c, data.focal)
    ddata = device_dataset(data.images, data.masks, data.cam_to_worlds, NV_SIZE,
                           light_locs=data.light_locs, device=dev)
    scene = nerv.build_scene().init(torch.Generator().manual_seed(0), device=dev)
    views = [0, 4, 8]
    pinned = lambda d, g: (torch.tensor(views, device=dev), torch.tensor(0, device=dev),
                           torch.tensor(0, device=dev))
    res = {}
    for label in ("kernels", "plain"):
        sc = copy.deepcopy(scene)
        dstep = make_device_data_step(sc, Path(max_depth=2, training=True), spec, builder,
                                      n_views=3, size=NV_SIZE, crop_size=NV_SIZE,
                                      with_light_locs=True, tone_mapping=True, draw=pinned)
        gen = torch.Generator(device=dev).manual_seed(5)
        if label == "plain":
            with plain_kernels():
                _, aux = dstep(TrainState(sc, spec.init(sc), 0), ddata, gen)
        else:
            _, aux = dstep(TrainState(sc, spec.init(sc), 0), ddata, gen)
        grads = {c: torch.cat([p.grad.reshape(-1) for p in getattr(sc, c).parameters()])
                 for c in ("shape", "bsdf", "lights")}
        res[label] = (aux["loss"].item(), grads, aux["got"][..., 3] > 0.5)
        del sc
    (lk, gk, ak), (lp, gp, ap) = res["kernels"], res["plain"]
    rel_loss = abs(lk - lp) / abs(lp)
    n_diff = int((ak != ap).sum().item())
    rel_g = {c: ((gk[c] - gp[c]).norm() / gp[c].norm().clamp_min(1e-30)).item() for c in gk}
    print(f"Path training step parity (NeRV twin's scene, seed-0 weights, generated data, "
          f"device data path, views {views} at 3 x {NV_SIZE}^2, the same generator seed; "
          f"kernels vs plain_kernels()): loss {lk:.7f} vs {lp:.7f} (rel {rel_loss:.3e}), "
          f"silhouette flags that differ {n_diff} of {ak.numel()} (covered "
          f"{ap.float().mean().item():.4f}), gradient rel L2 "
          f"{', '.join(f'{c} {e:.3e}' for c, e in rel_g.items())}")
    check(np.isfinite(lk) and rel_loss <= 1e-4, f"Path step parity: loss rel {rel_loss:.3e}")
    check(n_diff <= 0.001 * ak.numel(), f"Path step parity: {n_diff} silhouette flags differ")
    for c, e in rel_g.items():
        check(gp[c].norm().item() > 0, f"Path step parity: no {c} gradient")
        check(e <= 1e-2, f"Path step parity: {c} gradient rel L2 {e:.3e} > 1e-2")
    del res, gk, gp

    # 10 counted steps of the workload's own entry on the device data path
    args = twin_args(nerv, size=NV_SIZE, crop_size=NV_SIZE, iters=10, log_every=0,
                     device=str(dev), device_data=True, train_integrator="path")
    reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    state, run = nerv.run(args, data, None, save=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    counts = launch_counts()
    k1_routes("NeRV twin, --train-integrator path")
    for name in ("fused_mlp_forward", "fused_march", "fused_min_scan", "fused_shadow_march"):
        check(counts[name] > 0, f"NeRV twin, --train-integrator path: {name} was not launched")
    check(np.isfinite(run["losses"]).all(), f"Path training losses {run['losses']}")
    print(f"NeRV twin run --train-integrator path (device data path, 3 x {NV_SIZE}^2, 10 "
          f"steps): {secs:.2f} s with the calibration, losses "
          f"{[round(x, 4) for x in run['losses']]}; launches {counts}")

    # the Path and the Direct step in turns on one state, the device data path
    kw = dict(size=NV_SIZE, crop_size=NV_SIZE, n_views=3, tone_mapping=True,
              uv_select=rand_uv_mask, log_every=0, nan_policy="raise", device_data=ddata,
              camera_builder=builder)
    gen = torch.Generator(device=dev).manual_seed(1)
    box = {"state": state}

    def steps_of(integrator):
        def steps(n):
            box["state"], _ = train(state.scene, integrator, spec, box["state"], None, None,
                                    None, gen, iters=n, **kw)
        return steps

    paths = {"path": steps_of(Path(max_depth=2, training=True)),
             "direct": steps_of(Direct(training=True))}
    for fn in paths.values():
        fn(2)                                                           # warm-up
    walls = {k: [] for k in paths}
    for k in ("path", "direct", "direct", "path"):
        torch.cuda.synchronize()
        start = time.perf_counter()
        paths[k](10)
        torch.cuda.synchronize()
        walls[k].append(1e3 * (time.perf_counter() - start) / 10)
    out = {"counts": counts, "twin_s": secs}
    for k, fn in (("direct", paths["direct"]), ("path", paths["path"])):
        prof, kernels = steps_profile(torch, lambda: fn(3), 3)
        check(prof["busy_ms"] > 0, f"{k} step: the profiler saw no device time")
        # counted twice: a first count after a profiler session once caught
        # a wait with no frame of the package on its stack
        first = sync_sites(torch, lambda: fn(3))
        syncs = sync_sites(torch, lambda: fn(3))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fn(1)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        ms = float(np.median(walls[k]))
        out[k] = dict(ms=ms, busy_ms=prof["busy_ms"], launches=prof["launches"],
                      idle=1 - prof["busy_ms"] / prof["wall_ms"], syncs=syncs, peak_gib=peak,
                      path=k_path_ms(kernels))
        print(f"NeRV {k} training step on generated data (3 x {NV_SIZE}^2 = "
              f"{3 * NV_SIZE * NV_SIZE} rays, device data path, {card()}): "
              f"{[round(x, 1) for x in walls[k]]} ms/step in turns; a profile of 3 steps: busy "
              f"{out[k]['busy_ms']:.1f} ms a step, idle share {out[k]['idle']:.3f}, "
              f"{out[k]['launches']:.0f} launches a step; K1-K4 device ms a launch: "
              f"{k_line(out[k]['path'])}; {sum(syncs.values())} waits for the card in 3 steps: "
              f"{syncs} (the first count: {first}); peak memory {peak:.3f} GiB")
    n_path, n_direct = (sum(out[k]["syncs"].values()) for k in ("path", "direct"))
    check(n_path <= n_direct, f"the Path step waits for the card {n_path} times in 3 steps, "
          f"the Direct step {n_direct}")
    print(f"NeRV training, Path / Direct step: {out['path']['ms']:.1f} / "
          f"{out['direct']['ms']:.1f} ms/step ({out['path']['ms'] / out['direct']['ms']:.3f}), "
          f"busy {out['path']['busy_ms']:.1f} / {out['direct']['busy_ms']:.1f} ms, peak memory "
          f"{out['path']['peak_gib']:.3f} / {out['direct']['peak_gib']:.3f} GiB")
    out["state"] = box["state"]
    return out


def relit_views(torch, dev, scene, test):
    """(d) workloads.path_nerv.run on ``scene`` and the 4 test views at 64^2,
    4 passes each: PSNR beside Direct's (evaluate, hard shadows) and the
    black render's, a pixel probe."""
    import numpy as np
    from neural_raytracing_tpu_torch.cameras import NeRFCamera
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.training import evaluate
    from neural_raytracing_tpu_torch.workloads import nerv, path_nerv
    args = twin_args(path_nerv, size=NV_SIZE, samples=4, device=str(dev))
    ev = nerv.eval_scene(scene, "hard", 1.2)
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = path_nerv.run(args, test, ev, save=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    check(np.isfinite(out["images"]).all() and out["images"].shape == (4, NV_SIZE, NV_SIZE, 3),
          f"path_nerv: images {out['images'].shape}")
    direct = evaluate(ev, lambda i: NeRFCamera(torch.from_numpy(test.cam_to_worlds[i:i + 1]),
                                               test.focal),
                      test.images, Direct(training=False), size=NV_SIZE,
                      chunk_size=NV_SIZE, log_fn=lambda s: None,
                      light_update=lambda sc, cam, i: sc.lights.set_location(
                          test.light_locs[i:i + 1]))
    print(f"path_nerv twin (4 test views at {NV_SIZE}^2, 4 passes, Path depth 2, hard shadows, "
          f"bounded 1.2): {secs:.2f} s; PSNR {out['avg_psnr']:.3f} dB, Direct's "
          f"{direct['psnr']:.3f}, the black render's {black_psnr(test.images):.3f}; "
          f"{pixel_probe(out['images'])} (a pipeline check, not a quality figure)")
    return out


def phase_path(torch, dev, trained=None):
    """Phase 22: Path and Direct's BSDF arm on the trained NeRV checkpoint at
    full width, the bounce launches, Path training, path_nerv, the other
    integrators of workloads.render.  ``trained``: phase 21's (data, test,
    state), else the NeRV generator's data is made here and (d) renders the
    scene (e) trained.  -> the numbers for the kernels line."""
    import tempfile

    import numpy as np
    from neural_raytracing_tpu_torch.integrators import Direct, Path
    from neural_raytracing_tpu_torch.kernels import launch_counts, reset_launch_counts
    from neural_raytracing_tpu_torch.lights import Constant
    from neural_raytracing_tpu_torch.workloads import render

    print(f"phase 22 on {card()}")
    scene = nerv_scene(torch, dev, 128, 1.2, "hard")
    locs = scene.lights.location.detach().clone()
    scene.lights.set_location(locs[:1])

    # (a) Path at full width against plain_kernels(), the same draws
    path2 = Path(max_depth=2)
    got, counts = counted_view(torch, "Path view", lambda: path_view(torch, dev, scene, path2),
                               {"fused_march": 2, "fused_shadow_march": 2})
    with plain_kernels():
        want = path_view(torch, dev, scene, path2)
    frac, agree, mean_d, max_d = compare_images("Path view", got.cpu().numpy(),
                                                want.cpu().numpy())
    print(f"(a) Path(max_depth=2), hard shadows, NeRV eval view 0 at {NERV_SIZE}^2 (light 0, "
          f"1 pass): kernels against plain_kernels(): lit fraction {frac:.4f}, mask agreement "
          f"{agree:.6f}, mean |diff| {mean_d:.3e}, max |diff| {max_d:.3e}; launches {counts}")

    # (b) depth 1 is Direct (a delta light: only the camera jitter draws)
    direct = path_view(torch, dev, scene, Direct(training=False))
    depth1 = path_view(torch, dev, scene, Path(max_depth=1))
    d1 = (depth1 - direct).abs().max().item()
    check(d1 <= 1e-6, f"Path(max_depth=1) against Direct: max |diff| {d1:.3e} > 1e-6")
    check(got.mean().item() >= direct.mean().item(),
          f"Path depth 2 mean {got.mean().item():.6f} below Direct's {direct.mean().item():.6f}")
    print(f"(b) Path(max_depth=1) against Direct(training=False): max |diff| {d1:.3e}; mean "
          f"radiance Direct {direct.mean().item():.6f}, Path depth 2 {got.mean().item():.6f} "
          f"(+{got.mean().item() / max(direct.mean().item(), 1e-30) - 1:.4f})")

    # (c) ms/view in turns, a profile of one Path view, the bounce launch
    times = in_turns({"direct": lambda: path_view(torch, dev, scene, Direct(training=False)),
                      "path": lambda: path_view(torch, dev, scene, path2)}, reps=3)
    prof = profile_step(torch, lambda: path_view(torch, dev, scene, path2),
                        "one Path view (depth 2, hard shadows)")
    kp = k_path_ms(kernel_profile(torch, lambda: path_view(torch, dev, scene, path2), reps=2))
    print(f"(c) on {card()}: Direct {times['direct']:.1f} ms/view, Path depth 2 "
          f"{times['path']:.1f} ms/view ({times['path'] / times['direct']:.3f}); the Path view's "
          f"K1-K4 device ms a launch: {k_line(kp)}")
    bounce = bounce_launch(torch, dev, scene)

    # (f) Direct's BSDF arm under Constant, kernels against plain, K4 for both arms
    lit = scene.replace(lights=Constant(radius=5.0, intensity=0.5).to(dev))
    mis = Direct(emitter_samples=1, bsdf_samples=1, training=False)
    got_f, counts_f = counted_view(torch, "Direct BSDF arm", lambda: path_view(torch, dev, lit, mis),
                                   {"fused_march": 1, "fused_shadow_march": 2})
    with plain_kernels():
        want_f = path_view(torch, dev, lit, mis)
    frac, agree, mean_d, max_d = compare_images("Direct BSDF arm", got_f.cpu().numpy(),
                                                want_f.cpu().numpy())
    ms_f = cuda_ms(lambda: path_view(torch, dev, lit, mis), 3)
    print(f"(f) Direct(emitter_samples=1, bsdf_samples=1) under Constant(5, 0.5), hard shadows, "
          f"view 0 at {NERV_SIZE}^2: kernels against plain_kernels(): lit fraction {frac:.4f}, "
          f"mask agreement {agree:.6f}, mean |diff| {mean_d:.3e}, max |diff| {max_d:.3e}; "
          f"{ms_f:.1f} ms/view; launches {counts_f}")
    k4_constant = constant_shadow_shapes(torch, dev, lit)
    scene.lights.set_location(locs)
    del lit

    # (g) workloads.render.main --workload nerv with the other integrators
    frames = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("debug", "depth", "silhouette", "path"):
            args = ["--workload", "nerv", "--models", str(ARTIFACTS), "--size",
                    str(ORBIT_SIZE), "--frames", "1", "--device", str(dev), "--outputs", tmp,
                    "--integrator", name]
            render.main(args)                                           # warm-up
            reset_launch_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            frame = render.main(args)
            torch.cuda.synchronize()
            secs = time.perf_counter() - start
            c = launch_counts()
            k1_routes(f"render --integrator {name}")
            dims = 1 if name in ("depth", "silhouette") else 3
            check(c["fused_march"] > 0, f"render --integrator {name}: K2 was not launched")
            check(frame.shape == (1, ORBIT_SIZE, ORBIT_SIZE, dims) and np.isfinite(frame).all(),
                  f"render --integrator {name}: frame {frame.shape}")
            frames[name] = frame
            print(f"(g) workloads.render.main --workload nerv --integrator {name}, one "
                  f"{ORBIT_SIZE}^2 frame: {1e3 * secs:.1f} ms, mean {frame.mean():.4f}; "
                  f"launches {c}")
    check(set(np.unique(frames["silhouette"])) <= {0.0, 1.0}, "silhouette frame not 0/1")

    # (e) Path training on the NeRV generator's data, (d) path_nerv on a trained scene
    if trained is None:
        data, test, _, _ = nerv_generated(torch, dev, NV_SIZE)
    else:
        data, test, _ = trained
    training = path_training(torch, dev, data)
    relit_views(torch, dev, (trained[2] if trained is not None else training["state"]).scene,
                test)
    return dict(counts=counts, times=times, prof=prof, kp=kp, bounce=bounce,
                k4_constant=k4_constant, training=training)


# ---- phase 23: scene editing and the test-split entry points ------------------------

EDIT_SIZE = 256                                    # scripts/test_nerf.py's default
EDIT_STEPS = 256                                   # its --test-max-steps
EDIT_DTU_SIZE = 128                                # scripts/edit_dtu.py's default
EDIT_NERV_SIZE = 200                               # scripts/test_nerv.py's default
EDIT_NERV_WEIGHTS = (0.7, 0.3)
PRIME_ITERS = 200
PRIME_POINTS = 4_096
SURFACE_SIZE = 128


def counted(torch, label, fn):
    """``fn()`` with the launch counts reset just before and read just after;
    every fused net on the tile.  -> (its result, the counts, seconds)."""
    from neural_raytracing_tpu_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    counts = launch_counts()
    k1_routes(label)
    check(counts["fused_mlp_forward"] > 0, f"{label}: K1 was not launched")
    return out, counts, secs


def edit_flagship(torch, dev, root):
    """(a) workloads.edit_nerf on the flagship scene with phase 3's seeded
    shift, saved with save_scene, on one 256^2 test view of the NeRV
    generator twin (NeRF layout) -> the numbers for the summary."""
    from neural_raytracing_tpu_torch.training import NeRFDataset, save_scene
    from neural_raytracing_tpu_torch.workloads import edit_nerf, nerf_synthetic
    from neural_raytracing_tpu_torch.workloads._common import chunk_for
    scene = nerf_synthetic.build_scene().init(torch.Generator().manual_seed(0), device=dev)
    scene.shape.module.load_state_dict(march_surface(torch, dev).state_dict())
    save_scene(str(root / "flagship"), scene)
    _, test, _, _ = nerv_generated(torch, dev, EDIT_SIZE, train_views=1, test_views=1)
    test = NeRFDataset(test.cam_to_worlds, test.focal, test.images, test.masks)
    tiles = (EDIT_SIZE // chunk_for(EDIT_SIZE)) ** 2               # 4 tiles of 16,384 rays
    out = {}

    def run(edit, bend_k=2.5):
        args = twin_args(edit_nerf, size=EDIT_SIZE, models=str(root), edit=edit,
                         bend_k=bend_k, test_max_steps=EDIT_STEPS, device=str(dev))
        return edit_nerf.run(args, test, "flagship", save=False)

    run("none")                                     # warm-ups: K2's path and the plain loop
    run("bend")
    for edit in edit_nerf.EDITS:
        got, counts, secs = counted(torch, f"edit_nerf --edit {edit}", lambda: run(edit))
        with plain_kernels():
            want = run(edit)
        frac, agree, mean_d, max_d = compare_images(f"edit_nerf --edit {edit}",
                                                    got["images"], want["images"])
        k2 = counts["fused_march"]
        if edit == "none":
            check(k2 == tiles, f"edit_nerf --edit none: K2 launched {k2} times, not {tiles}")
        else:
            check(k2 == 0, f"edit_nerf --edit {edit}: K2 launched {k2} times under the edit")
        check(counts["fused_min_scan"] == counts["fused_shadow_march"] == 0,
              f"edit_nerf --edit {edit}: K3 or K4 launched: {counts}")
        out[edit] = dict(ms=1e3 * secs, k1=counts["fused_mlp_forward"], k2=k2,
                         psnr=got["psnr"], agree=agree, mean_diff=mean_d)
        print(f"(a) edit_nerf --edit {edit}, one {EDIT_SIZE}^2 view, {EDIT_STEPS} steps: "
              f"{1e3 * secs:.1f} ms/view, K1 {counts['fused_mlp_forward']} launches, K2 {k2}; "
              f"kernels against plain_kernels(): lit fraction {frac:.4f}, mask agreement "
              f"{agree:.6f}, mean |diff| {mean_d:.3e}, max |diff| {max_d:.3e}; PSNR "
              f"{got['psnr']:.3f} dB (random weights)")
    # the plain warped loop against K2 on the same field
    flat, _, _ = counted(torch, "edit_nerf --edit bend --bend-k 0", lambda: run("bend", 0.0))
    none = run("none")
    frac, agree, mean_d, max_d = compare_images("bend --bend-k 0 against none",
                                                flat["images"], none["images"])
    print(f"(a) edit_nerf --edit bend --bend-k 0 (the plain warped loop) against --edit none "
          f"(K2): mask agreement {agree:.6f}, mean |diff| {mean_d:.3e}, max |diff| "
          f"{max_d:.3e}")
    # bend's and none's ms/view in turns, and one profile each
    scenes = {e: edit_nerf.edited_scene(twin_args(
        edit_nerf, size=EDIT_SIZE, models=str(root), edit=e, test_max_steps=EDIT_STEPS,
        device=str(dev)), "flagship") for e in ("none", "bend")}
    view = lambda s: edit_view(torch, dev, s, test)
    times = in_turns({e: (lambda s=s: view(s)) for e, s in scenes.items()}, reps=1)
    busy = {e: profile_step(torch, lambda s=s: view(s), f"one flagship test view, --edit {e}")
            for e, s in scenes.items()}
    check(all(b is not None for b in busy.values()), "edit_nerf: the profiler saw no device time")
    print(f"(a) on {card()}: one {EDIT_SIZE}^2 test view in turns: --edit none "
          f"{times['none']:.1f} ms/view, --edit bend {times['bend']:.1f} ms/view "
          f"({times['bend'] / times['none']:.2f}x); busy none {busy['none']['busy_ms']:.1f} ms, "
          f"bend {busy['bend']['busy_ms']:.1f} ms")
    return dict(edits=out, times=times, busy=busy, bend_k0=(agree, mean_d))


def edit_view(torch, dev, scene, test):
    """View 0 of ``test`` as evaluate renders it (chunk_for's tile, bundle
    1, background 0, the view's seed)."""
    from neural_raytracing_tpu_torch.cameras import NeRFCamera
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.render import pathtrace
    from neural_raytracing_tpu_torch.training.eval import view_key
    from neural_raytracing_tpu_torch.workloads._common import chunk_for
    cam = NeRFCamera(torch.from_numpy(test.cam_to_worlds[:1]), test.focal)
    return pathtrace(scene, cam, Direct(training=False), size=EDIT_SIZE,
                     chunk_size=chunk_for(EDIT_SIZE),
                     bundle_size=1, background=0.0, key=view_key(0, 0), device=dev)[0]


def edit_dtu_views(torch, dev, root):
    """(b) workloads.edit_dtu at 128^2, 128 steps, on phase 20's generated
    scan (one view), the DTU scene with phase 3's seeded shift: bend, disp
    and --recolor 0, Direct and Debug, kernels against plain_kernels()."""
    from neural_raytracing_tpu_torch.training import save_scene
    from neural_raytracing_tpu_torch.workloads import dtu, edit_dtu
    scene = dtu.build_scene().init(torch.Generator().manual_seed(0), device=dev)
    scene.shape.module.load_state_dict(march_surface(torch, dev).state_dict())
    save_scene(str(root / "dtu_scan"), scene)
    data, _, _ = dtu_scan(torch, dev, EDIT_DTU_SIZE, 1)
    out = {}
    for edit, recolor in (("bend", -1), ("disp", -1), ("none", 0)):
        label = f"edit_dtu --edit {edit} --recolor {recolor}"
        args = twin_args(edit_dtu, size=EDIT_DTU_SIZE, models=str(root), edit=edit,
                         recolor=recolor, views=1, device=str(dev))
        edit_dtu.run(args, data, "scan", save=False)                 # warm-up
        got, counts, secs = counted(torch, label, lambda: edit_dtu.run(args, data, "scan",
                                                                       save=False))
        with plain_kernels():
            want = edit_dtu.run(args, data, "scan", save=False)
        k2 = counts["fused_march"]
        check(k2 == (2 if edit == "none" else 0), f"{label}: K2 launched {k2} times")
        for tag in ("render", "normals"):
            frac, agree, mean_d, max_d = compare_images(f"{label} {tag}", got[tag], want[tag])
            print(f"(b) {label}, {tag} ({'Direct' if tag == 'render' else 'Debug'}), one "
                  f"{EDIT_DTU_SIZE}^2 view: lit fraction {frac:.4f}, mask agreement "
                  f"{agree:.6f}, mean |diff| {mean_d:.3e}, max |diff| {max_d:.3e}")
        out[f"{edit}/{recolor}"] = dict(ms=1e3 * secs / 2, k1=counts["fused_mlp_forward"], k2=k2)
        print(f"(b) {label}: {1e3 * secs / 2:.1f} ms a render, launches {counts}")
    return out


def edit_nerv_frames(torch, dev):
    """(c) workloads.eval_nerv on the checkpoint at 200^2, hard shadows: two
    test frames (eval views 0 and 1) of two of the checkpoint's lights each,
    weights (0.7, 0.3)."""
    import numpy as np
    from neural_raytracing_tpu_torch.training import NeRVDataset
    from neural_raytracing_tpu_torch.workloads import eval_nerv
    from neural_raytracing_tpu_torch.workloads._common import chunk_for
    args = twin_args(eval_nerv, size=EDIT_NERV_SIZE, device=str(dev))
    scene = eval_nerv.build_test_scene(args, str(ARTIFACTS))
    locs = scene.lights.location.detach().cpu().numpy()
    cam = nerv_camera(torch, NERV_EVAL_VIEWS[:2])
    test = NeRVDataset(cam.cam_to_world.numpy(), NERV_FOCAL * EDIT_NERV_SIZE / NERV_SIZE,
                       np.zeros((2, EDIT_NERV_SIZE, EDIT_NERV_SIZE, 3), np.float32),
                       np.ones((2, EDIT_NERV_SIZE, EDIT_NERV_SIZE), np.float32),
                       np.stack([locs[0:2], locs[1:3]]),
                       np.asarray([EDIT_NERV_WEIGHTS] * 2, np.float32))
    eval_nerv.run(args, test, scene, save=False)                     # warm-up
    got, counts, secs = counted(torch, "eval_nerv", lambda: eval_nerv.run(args, test, scene,
                                                                          save=False))
    passes = 2 * 2 * (EDIT_NERV_SIZE // chunk_for(EDIT_NERV_SIZE)) ** 2  # frames x lights x tiles
    check(counts["fused_march"] == passes and counts["fused_shadow_march"] == passes,
          f"eval_nerv: K2 / K4 launched {counts['fused_march']} / "
          f"{counts['fused_shadow_march']} times, not {passes}")
    check(torch.equal(scene.lights.location.detach().cpu(), torch.from_numpy(locs)),
          "eval_nerv: the scene's lights were not restored")
    with plain_kernels():
        want = eval_nerv.run(args, test, scene, save=False)
    frac, agree, mean_d, max_d = compare_images("eval_nerv", got["images"], want["images"])
    # the weighted image against the weighted sum of the single-light passes (same keys)
    worst = 0.0
    for i in range(2):
        frame = eval_nerv.render_frame(scene, test, i, EDIT_NERV_SIZE, dev)
        singles = [eval_nerv.render_frame(
            scene, test._replace(light_locs=test.light_locs[:, j], light_weights=None), i,
            EDIT_NERV_SIZE, dev) for j in range(2)]
        summed = EDIT_NERV_WEIGHTS[0] * singles[0] + EDIT_NERV_WEIGHTS[1] * singles[1]
        worst = max(worst, (frame - summed).abs().max().item())
        check((singles[0] - singles[1]).abs().max().item() > 1e-3,
              f"eval_nerv frame {i}: its two lights render the same image")
    scene.lights.set_location(locs)
    check(worst <= 1e-6, f"eval_nerv: the weighted image is {worst:.3e} from the weighted "
                         f"sum of its single-light renders")
    print(f"(c) eval_nerv on the checkpoint, 2 frames x 2 lights (weights "
          f"{EDIT_NERV_WEIGHTS}), {EDIT_NERV_SIZE}^2, hard shadows: {1e3 * secs / 2:.1f} ms/view, "
          f"launches {counts}; kernels against plain_kernels(): lit fraction {frac:.4f}, mask "
          f"agreement {agree:.6f}, mean |diff| {mean_d:.3e}, max |diff| {max_d:.3e}; the "
          f"weighted image against the weighted single-light renders: max |diff| {worst:.3e}; "
          f"PSNR {got['avg_psnr']:.3f} against a black ground truth")
    return dict(ms=1e3 * secs / 2, counts=counts, weighted_max_diff=worst)


def edit_prime(torch, dev):
    """(d) shapes.prime on SDF(phase 3's SphereSDF(128), 8x128 shift), 200
    steps at 4,096 points onto sphere_sdf; its first step on the kernel
    route against plain; nn.prime_identity on a LightField-width net."""
    from neural_raytracing_tpu_torch.kernels import FusedSkipConnMLP
    from neural_raytracing_tpu_torch.nn import prime_identity
    from neural_raytracing_tpu_torch.shapes import SDF, prime, sphere_sdf

    def first(plain):
        sdf = SDF(march_surface(torch, dev))
        gen = torch.Generator(device=dev).manual_seed(0)
        if not plain:
            return prime(sdf, sphere_sdf, gen, iters=1, batch_size=PRIME_POINTS)
        with plain_kernels():
            return prime(sdf, sphere_sdf, gen, iters=1, batch_size=PRIME_POINTS)

    k, p = first(False).item(), first(True).item()
    check(abs(k - p) <= 1e-4 * abs(p), f"prime: the first step's loss {k} against plain {p}")
    sdf = SDF(march_surface(torch, dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    loss0 = prime(sdf, sphere_sdf, gen, iters=1, batch_size=PRIME_POINTS).item()
    last, counts, secs = counted(torch, "prime", lambda: prime(
        sdf, sphere_sdf, gen, iters=PRIME_ITERS - 1, batch_size=PRIME_POINTS))
    last = last.item()
    check(math.isfinite(last) and last < loss0, f"prime: the loss went {loss0} -> {last}")
    mlp = FusedSkipConnMLP(in_size=3, out=3, num_layers=10, hidden_size=256)
    mlp.reset_parameters(torch.Generator().manual_seed(0))
    mlp.to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    id0 = prime_identity(mlp, gen, iters=1).item()
    idn, id_counts, id_secs = counted(torch, "prime_identity",
                                      lambda: prime_identity(mlp, gen, iters=PRIME_ITERS - 1))
    idn = idn.item()
    check(math.isfinite(idn) and idn < id0, f"prime_identity: the loss went {id0} -> {idn}")
    print(f"(d) prime, SDF(SphereSDF(128), 8x128 shift) onto sphere_sdf, {PRIME_ITERS} steps at "
          f"{PRIME_POINTS:,} points in [-5, 5]^3: loss {loss0:.5f} -> {last:.5f}, "
          f"{1e3 * secs / (PRIME_ITERS - 1):.2f} ms/step, K1 {counts['fused_mlp_forward']} "
          f"launches; its first step on the kernel route {k:.6f} against plain {p:.6f}; "
          f"prime_identity (10x256, LightField's width): loss {id0:.5f} -> {idn:.5f}, "
          f"{1e3 * id_secs / (PRIME_ITERS - 1):.2f} ms/step, K1 "
          f"{id_counts['fused_mlp_forward']} launches")
    return dict(loss=(loss0, last), identity=(id0, idn))


def edit_surfaces(torch, dev):
    """(e) RoundBoxSDF, CapsuleSDF and ParametricSDFSet (seed 0): one 128^2
    Depth render on the card against the same on the CPU; NeRFMMCamera and
    NeRVCamera rays on the card against the same on the CPU."""
    import numpy as np
    from neural_raytracing_tpu_torch import Scene
    from neural_raytracing_tpu_torch.cameras import (
        NeRFCamera, NeRFMMCamera, NeRVCamera, nerf_c2w,
    )
    from neural_raytracing_tpu_torch.integrators import Depth
    from neural_raytracing_tpu_torch.render import _tile_positions, pathtrace
    from neural_raytracing_tpu_torch.shapes import (
        SDF, CapsuleSDF, ParametricSDFSet, RoundBoxSDF,
    )
    focal = 0.5 * SURFACE_SIZE / math.tan(0.5 * 0.6911)
    cam = NeRFCamera(torch.from_numpy(nerf_c2w(30, 45, 1.0)[None, :3]), focal)
    for surface in (RoundBoxSDF(), CapsuleSDF(), ParametricSDFSet()):
        surface.reset_parameters(torch.Generator().manual_seed(0))
        images = {}
        for d in (dev, "cpu"):
            scene = Scene(shape=SDF(surface)).to(d)
            images[str(d)] = pathtrace(scene, cam, Depth(), size=SURFACE_SIZE,
                                       chunk_size=SURFACE_SIZE, bundle_size=1,
                                       background=0.0, device=d)[0].cpu().numpy()
        got, want = images[str(dev)], images["cpu"]
        hit, phit = got[..., 0] > 0, want[..., 0] > 0
        agree = (hit == phit).mean()
        both = hit & phit
        diff = np.abs(got - want)[both]
        name = type(surface).__name__
        check(0.02 < phit.mean() < 0.98, f"{name}: hit fraction {phit.mean():.4f}")
        check(agree >= 0.99 and diff.max() <= 1e-3,
              f"{name}: card against CPU, hit agreement {agree:.4f}, max |depth diff| "
              f"{diff.max():.3e}")
        print(f"(e) {name} (plain loops), one {SURFACE_SIZE}^2 Depth render, card against "
              f"CPU: hit fraction {phit.mean():.4f}, agreement {agree:.6f}, max |depth diff| "
              f"{diff.max():.3e}")
    rng = np.random.default_rng(3)
    axis = rng.normal(size=(2, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    w2c = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    w2c[:, :3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    cams = {"NeRFMMCamera": NeRFMMCamera(
        torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32)),
        torch.from_numpy(rng.uniform(-3, 3, size=(2, 1)).astype(np.float32)),
        torch.from_numpy(axis), torch.from_numpy(rng.uniform(100, 200, (2, 2)).astype(np.float32))),
        "NeRVCamera": NeRVCamera(torch.from_numpy(w2c),
                                 torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32)),
                                 float(focal))}
    for name, c in cams.items():
        rays = {str(d): c.to(d).sample_positions(_tile_positions(0.0, 0.0, SURFACE_SIZE, d),
                                                 bundle_size=2, size=SURFACE_SIZE).cpu()
                for d in (dev, "cpu")}
        err = (rays[str(dev)] - rays["cpu"]).abs().max().item()
        check(rays["cpu"].shape == (2, SURFACE_SIZE, SURFACE_SIZE, 2, 6) and err <= 1e-5,
              f"{name}: card against CPU, max |diff| {err:.3e}")
        print(f"(e) {name}: {tuple(rays['cpu'].shape)} rays, card against CPU max |diff| "
              f"{err:.3e}")


def phase_edit(torch, dev):
    """Phase 23: scene editing and the test-split entry points at full width
    -> the numbers for the summary line."""
    import tempfile
    print(f"phase 23 on {card()}")
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        flagship = edit_flagship(torch, dev, root)
        dtu_edits = edit_dtu_views(torch, dev, root)
    nerv_frames = edit_nerv_frames(torch, dev)
    primed = edit_prime(torch, dev)
    edit_surfaces(torch, dev)
    secs = time.perf_counter() - start
    print(f"phase 23: {secs:.1f} s")
    return dict(flagship=flagship, dtu=dtu_edits, nerv=nerv_frames, prime=primed, secs=secs)


# ---- phase 24: the hash-encoded surface and the rest of the NeRF family ---------------

HASH_POINTS = 65_536                               # (b) the encoding, card against CPU
HASH_STEPS = 3                                     # (a) steps held against plain_kernels()
HASH_TWIN_STEPS = 6                                # (a) workloads.nerf_synthetic.run
FAMILY_POINTS = 16_384                             # (d) each module, card against CPU
SAMPLER_POINTS = 1_000                             # (d) OrthogonalSampler: 37^2 strata
WARP_ITERS = 300                                   # (d) NeuralWarp.prime
WARP_POINTS = 4_096


def flagship_scene(torch, dev, surface):
    """workloads.nerf_synthetic.build_scene(surface=...) at phase 7's
    training settings (64 steps, unbounded), seed-0 weights."""
    from neural_raytracing_tpu_torch.workloads import nerf_synthetic
    scene = nerf_synthetic.build_scene(surface=surface, max_steps=64, march_bound=None)
    return scene.init(torch.Generator().manual_seed(0), device=dev)


def flagship_test_view(torch, dev, scene, c2ws, size=SIZE):
    """-> a function rendering test view 0 of phase 7's GT as the twin's test
    split does (256 steps bounded 1.2, chunk_for's tile, the view's seed),
    at ``size``^2."""
    from neural_raytracing_tpu_torch.cameras import NeRFCamera
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.render import pathtrace
    from neural_raytracing_tpu_torch.training.eval import view_key
    from neural_raytracing_tpu_torch.workloads._common import chunk_for
    test = scene.replace(shape=scene.shape.replace(max_steps=256, march_bound=1.2,
                                                   throughput_mode="full"))
    cam = NeRFCamera(torch.from_numpy(c2ws[:1]), FOCAL)
    return lambda: pathtrace(test, cam, Direct(training=False), size=size,
                             chunk_size=chunk_for(size), bundle_size=1, background=0.0,
                             key=view_key(0, 0), device=dev)[0]


def flagship_step(torch, dev, scene, c2ws, imgs, masks, first_view=0):
    """-> a function taking one training step of ``scene`` (6 views from
    ``first_view`` on, phase 7's silhouette crop, a fresh AdamW; no jitter
    without a generator) -> (TrainState, aux)."""
    import numpy as np
    from neural_raytracing_tpu_torch.cameras import NeRFCamera
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.training import TrainState, build_step_fn, make_optimizer
    idxs = np.asarray([(first_view + j) % len(c2ws) for j in range(N_VIEWS)])
    u, v = silhouette_crop()
    exp = torch.from_numpy(imgs[idxs, u:u + CROP_SIZE, v:v + CROP_SIZE]).to(dev)
    mask = torch.from_numpy(masks[idxs, u:u + CROP_SIZE, v:v + CROP_SIZE]).to(dev)
    camera = NeRFCamera(torch.from_numpy(c2ws[idxs]), FOCAL)
    spec = make_optimizer(LRS)
    step = build_step_fn(scene, Direct(training=True), spec, size=SIZE, crop_size=CROP_SIZE)
    state = TrainState(scene, spec.init(scene), 0)
    return lambda gen=None: step(state, camera, (u, v), exp, mask, gen)


def no_march_kernels(label, counts):
    """A hash surface's route: K1 for the shading nets, none of K2-K5."""
    names = ("fused_march", "fused_min_scan", "fused_shadow_march", "fused_sphere_sdf",
             "fused_march_bf16", "fused_min_scan_bf16", "fused_shadow_march_bf16")
    check(all(counts[n] == 0 for n in names),
          f"{label}: a march kernel was launched on a hash surface: {counts}")


def wall_turns(torch, fns: dict) -> dict:
    """Host-clock ms of one call of each of ``fns`` in turns (a, b, b, a),
    each call synchronised: -> the mean of each's two."""
    names = list(fns)
    times = {k: [] for k in names}
    for k in names + names[::-1]:
        torch.cuda.synchronize()
        start = time.perf_counter()
        fns[k]()
        torch.cuda.synchronize()
        times[k].append(1e3 * (time.perf_counter() - start))
    return {k: sum(v) / len(v) for k, v in times.items()}


def rel_l2(a, b) -> float:
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def hash_flagship(torch, dev, c2ws, imgs, masks):
    """(a) the hash flagship (HashSDF() at its defaults): one 256^2 test view
    and three 6 x 80^2 training steps, each counted and against
    plain_kernels(); workloads.nerf_synthetic.run(--surface hash), its loss
    on a fixed batch before and after, its artifacts reloaded."""
    import copy
    import tempfile

    import numpy as np
    from neural_raytracing_tpu_torch.nn import HashSDF
    from neural_raytracing_tpu_torch.training import NeRFDataset, load_scene
    from neural_raytracing_tpu_torch.workloads import nerf_synthetic
    from neural_raytracing_tpu_torch.workloads._common import chunk_for
    scene = flagship_scene(torch, dev, "hash")
    check(isinstance(scene.shape.module, HashSDF), "the hash flagship's surface")
    enc = scene.shape.module.enc
    out = {}
    view = flagship_test_view(torch, dev, scene, c2ws)
    got, counts, secs = counted(torch, "hash test view", view)
    no_march_kernels("hash test view", counts)
    with plain_kernels():
        want = view()
    frac, agree, mean_d, max_d = compare_images("hash test view", got.cpu().numpy(),
                                                want.cpu().numpy())
    tiles = (SIZE // chunk_for(SIZE)) ** 2
    out["view"] = dict(ms=1e3 * secs, k1=counts["fused_mlp_forward"], agree=agree,
                       mean_diff=mean_d)
    print(f"(a) hash flagship (HashSDF: {enc.levels} levels of 2^"
          f"{int(math.log2(enc.table_size))} x {enc.features}, resolutions "
          f"{enc.resolutions[0]}-{enc.resolutions[-1]}, bound {enc.bound}; 2 x 64 relu net), "
          f"one {SIZE}^2 test view ({tiles} tiles, 256 steps, bounded 1.2): {1e3 * secs:.1f} "
          f"ms (the first), K1 {counts['fused_mlp_forward']} launches, K2-K5 none; against "
          f"plain_kernels(): lit fraction {frac:.4f}, mask agreement {agree:.6f}, mean |diff| "
          f"{mean_d:.3e}, max |diff| {max_d:.3e}")

    steps = []
    for i in range(HASH_STEPS):
        plain = copy.deepcopy(scene)
        (_, aux), counts, secs = counted(torch, f"hash training step {i}", flagship_step(
            torch, dev, scene, c2ws, imgs, masks, i))
        no_march_kernels(f"hash training step {i}", counts)
        with plain_kernels():
            _, paux = flagship_step(torch, dev, plain, c2ws, imgs, masks, i)()
        lk, lp = aux["loss"].item(), paux["loss"].item()
        rel = abs(lk - lp) / abs(lp)
        rel_g = {c: rel_l2(torch.cat([p.grad.reshape(-1) for p in getattr(scene, c).parameters()]),
                           torch.cat([p.grad.reshape(-1) for p in getattr(plain, c).parameters()]))
                 for c in ("shape", "bsdf", "lights")}
        check(math.isfinite(lk) and rel <= 1e-4, f"hash step {i}: loss {lk} against plain {lp}")
        for c, e in rel_g.items():
            check(e <= 1e-2, f"hash step {i}: {c} gradient rel L2 {e:.3e} > 1e-2")
        # the net's output layer starts at zero: from the second step on the
        # features reach the loss
        check(i == 0 or scene.shape.module.enc.tables.grad.abs().max().item() > 0,
              f"hash step {i}: no gradient reached the tables")
        steps.append(dict(ms=1e3 * secs, k1=counts["fused_mlp_forward"], loss=lk))
        print(f"(a) hash training step {i} ({N_VIEWS} x {CROP_SIZE}^2 from view {i}): "
              f"{1e3 * secs:.1f} ms, K1 {counts['fused_mlp_forward']} launches, K2-K5 none; "
              f"loss {lk:.6f} against plain_kernels() {lp:.6f} (rel {rel:.2e}), gradient rel "
              f"L2 {', '.join(f'{c} {e:.2e}' for c, e in rel_g.items())}")
        del plain
    out["steps"] = steps

    def fixed_loss(sc):
        return flagship_step(torch, dev, copy.deepcopy(sc), c2ws, imgs, masks)()[1]["loss"].item()

    data = NeRFDataset(c2ws, FOCAL, imgs, masks)
    with tempfile.TemporaryDirectory() as tmp:
        args = twin_args(nerf_synthetic, surface="hash", size=SIZE, crop_size=CROP_SIZE,
                         n_views=N_VIEWS, iters=HASH_TWIN_STEPS, valid_freq=0, log_every=0,
                         models=tmp, outputs=tmp, device=str(dev))
        before = fixed_loss(flagship_scene(torch, dev, "hash"))
        (state, res), counts, secs = counted(torch, "hash twin", lambda: nerf_synthetic.run(
            args, data, None, "hash"))
        no_march_kernels("hash twin", counts)
        after = fixed_loss(state.scene)
        check(len(res["losses"]) == HASH_TWIN_STEPS and np.isfinite(res["losses"]).all(),
              f"hash twin: losses {res['losses']}")
        check(after < before, f"hash twin: the fixed batch's loss went {before} -> {after}")
        fresh = nerf_synthetic.build_scene(surface="hash").init(
            torch.Generator().manual_seed(5), device=dev)
        load_scene(f"{tmp}/hash", fresh)
        same = all(torch.equal(fresh.state_dict()[k], v)
                   for k, v in state.scene.state_dict().items())
        check(same, "hash twin: the saved artifacts did not reload")
    out["twin"] = dict(ms_step=1e3 * secs / HASH_TWIN_STEPS, before=before, after=after)
    print(f"(a) workloads.nerf_synthetic.run --surface hash on phase 7's GT, "
          f"{HASH_TWIN_STEPS} steps of {N_VIEWS} x {CROP_SIZE}^2: {1e3 * secs / HASH_TWIN_STEPS:.1f} "
          f"ms/step, losses {[round(x, 3) for x in res['losses']]}; the loss of a fixed batch "
          f"(views 0-5, the silhouette crop) {before:.4f} -> {after:.4f}; K1 "
          f"{counts['fused_mlp_forward']} launches, K2-K5 none; the artifacts reload equal")
    return scene, out


def hash_encoding_card(torch, dev):
    """(b) HashEncoding() at its defaults on the card against the CPU: the
    same tables (seeded, scale 0.1) and 65,536 seeded points, forward and
    the gradients to the tables and to the points; the tables' gradient
    twice on the card (same bits?); the forward, and the forward with the
    backward, timed."""
    import copy
    from neural_raytracing_tpu_torch.nn import HashEncoding
    gen = torch.Generator().manual_seed(21)
    enc = HashEncoding()
    with torch.no_grad():
        enc.tables.copy_(0.1 * torch.randn(enc.tables.shape, generator=gen))
    p = 4.4 * torch.rand(HASH_POINTS, 3, generator=gen) - 2.2
    w = torch.randn(HASH_POINTS, enc.out_size, generator=gen)

    def run(module, device):
        module = copy.deepcopy(module).to(device)
        q = p.clone().to(device).requires_grad_()
        f = module(q)
        torch.sum(f * w.to(device)).backward()
        return f.detach().cpu(), module.tables.grad.cpu(), q.grad.cpu()

    cpu = run(enc, "cpu")
    on_card = run(enc, dev)
    again = run(enc, dev)
    errs = {name: (a - b).abs().max().item() / b.abs().max().item()
            for name, a, b in zip(("features", "d tables", "d points"), on_card, cpu)}
    errs["d tables rel L2"] = rel_l2(on_card[1], cpu[1])
    same_bits = torch.equal(on_card[1], again[1])
    for name, e in errs.items():
        check(e <= 1e-5, f"HashEncoding card against CPU: {name} {e:.3e} > 1e-5")
    enc_d = enc.to(dev)
    q = p.to(dev)
    qg = q.clone().requires_grad_()

    def fwd_bwd():
        torch.sum(enc_d(qg)).backward()

    with torch.no_grad():
        fwd = cuda_ms(lambda: enc_d(q), 5)
    both = cuda_ms(fwd_bwd, 5)
    print(f"(b) HashEncoding() on {card()}, {HASH_POINTS:,} points, card against CPU (max "
          f"|diff| over max): features {errs['features']:.2e}, d tables {errs['d tables']:.2e} "
          f"(rel L2 {errs['d tables rel L2']:.2e}), d points {errs['d points']:.2e}; the tables' "
          f"gradient twice on the card the same bits: {same_bits}; forward {fwd:.3f} ms, forward "
          f"and backward {both:.3f} ms")
    return dict(errs=errs, same_bits=same_bits, fwd=fwd, fwd_bwd=both)


def hash_turns(torch, dev, scene, c2ws, imgs, masks):
    """(c) the hash flagship against the sphere flagship in turns: one test
    view and one training step, wall (host clock, a, b, b, a), busy, idle
    share and launches (a profile of a step, and of pathtrace at one tile's
    size, 128^2 with the view's camera: the 256^2 view renders 4 such tiles
    of the same 256 steps, and a whole hash view's ~2.3e5 launches take
    minutes to profile); the launches of one plain march step at an eval
    tile; the peak memory of a step."""
    from neural_raytracing_tpu_torch.kernels import march_plain
    from neural_raytracing_tpu_torch.workloads._common import chunk_for
    scenes = {"spheres": flagship_scene(torch, dev, "spheres"), "hash": scene}
    views = {k: flagship_test_view(torch, dev, s, c2ws) for k, s in scenes.items()}
    steps = {k: flagship_step(torch, dev, s, c2ws, imgs, masks) for k, s in scenes.items()}
    views["spheres"]()                                   # warm-ups (the hash view ran in (a))
    for k in steps:
        steps[k]()
    view_ms = wall_turns(torch, views)
    step_ms = wall_turns(torch, steps)
    busy = {}
    for k, s in scenes.items():
        busy[f"{k} 128^2 view"] = profile_step(
            torch, flagship_test_view(torch, dev, s, c2ws, chunk_for(SIZE)),
            f"one {k} test view at one tile's size, {chunk_for(SIZE)}^2 (one tile)")
        busy[f"{k} step"] = profile_step(torch, steps[k], f"one {k} training step")
    check(all(b is not None for b in busy.values()), "phase 24: the profiler saw no device time")
    peak = {}
    for k in scenes:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps[k]()
        torch.cuda.synchronize()
        peak[k] = torch.cuda.max_memory_allocated() / 2 ** 30
    # one plain march step at an eval tile (16,384 rays of the test view)
    from neural_raytracing_tpu_torch.cameras import NeRFCamera
    from neural_raytracing_tpu_torch.render import _tile_positions
    chunk = chunk_for(SIZE)
    rays = NeRFCamera(torch.from_numpy(c2ws[:1]), FOCAL).to(dev).sample_positions(
        _tile_positions(0.0, 0.0, chunk, dev), size=SIZE).reshape(-1, 6)
    r_o, r_d = rays[:, :3].contiguous(), rays[:, 3:].contiguous()
    # the step's route from the wrappers' own counts (K1 for the spheres' net,
    # none for the hash's plain net), then three profiles of it: the host's
    # launch calls beside the kernels the device trace recorded, so a trace
    # that lost events shows as fewer device kernels than launch calls
    from neural_raytracing_tpu_torch.kernels import launch_counts, reset_launch_counts
    march_step, march_route, march_profiles = {}, {}, {}
    for k, s in scenes.items():
        one = lambda s=s: march_plain(s.shape.sdf, r_o, r_d, 10.0, max_steps=1, epsilon=1e-3)
        with torch.no_grad():
            one()
            reset_launch_counts()
            one()
            torch.cuda.synchronize()
            march_route[k] = {n: c for n, c in launch_counts().items() if c}
            profs = [profile_step(torch, one, f"one plain march step, {k}, {r_o.shape[0]} "
                                  f"rays, profile {i + 1} of 3") for i in range(3)]
        check(all(p is not None for p in profs), "phase 24: the profiler saw no device time")
        march_profiles[k] = [(p["device_kernels"], p["host_launches"]) for p in profs]
        march_step[k] = max(p["host_launches"] for p in profs)
    check(march_route["spheres"].get("fused_mlp_forward", 0) >= 1 and not march_route["hash"],
          f"phase 24: a plain march step's kernel launches {march_route}: K1 for the spheres, "
          f"none for the hash")
    print(f"(c) one plain march step ({r_o.shape[0]} rays): the wrappers' counts {march_route}; "
          + "; ".join(f"{k}: (device kernels, host launch calls) of three profiles {v}"
                      for k, v in march_profiles.items()))
    print(f"(c) on {card()}, in turns (a, b, b, a): one {SIZE}^2 test view spheres "
          f"{view_ms['spheres']:.1f} ms, hash {view_ms['hash']:.1f} ms "
          f"({view_ms['hash'] / view_ms['spheres']:.1f}x); one training step spheres "
          f"{step_ms['spheres']:.1f} ms, hash {step_ms['hash']:.1f} ms "
          f"({step_ms['hash'] / step_ms['spheres']:.1f}x); " + "; ".join(
              f"{k}: busy {b['busy_ms']:.1f} ms of {b['wall_ms']:.1f} (idle "
              f"{1 - b['busy_ms'] / b['wall_ms']:.3f}), {b['launches']} launches"
              for k, b in busy.items()) + " (a 256^2 view: 4 tiles of 128^2)" +
          f"; one plain march step ({r_o.shape[0]} rays): hash {march_step['hash']} launch calls, "
          f"spheres {march_step['spheres']}; peak memory of a step spheres "
          f"{peak['spheres']:.3f} GiB, hash {peak['hash']:.3f} GiB")
    return dict(view_ms=view_ms, step_ms=step_ms, busy=busy, march_step=march_step,
                march_profiles=march_profiles, peak=peak)


def family_views(torch, dev):
    """(d) the NeRV checkpoint under NeuralApprox (K2 a tile, no shadow
    rays) and under Direct with a seeded GlobalNeuralBSDF and its BSDF arm
    under Constant(5, 0.5), hard shadows (K2 once, K4 twice a tile), each
    counted and against plain_kernels()."""
    from neural_raytracing_tpu_torch.bsdf import GlobalNeuralBSDF
    from neural_raytracing_tpu_torch.integrators import Direct, NeuralApprox
    from neural_raytracing_tpu_torch.lights import Constant
    scene = nerv_scene(torch, dev, 128, 1.2, "hard")
    scene.lights.set_location(scene.lights.location.detach()[:1])
    approx = NeuralApprox()
    approx.reset_parameters(torch.Generator().manual_seed(0))
    approx.to(dev)
    gb = GlobalNeuralBSDF()
    gen = torch.Generator().manual_seed(1)
    gb.reset_parameters(gen)
    with torch.no_grad():                      # a mixture of distinct components
        gb.dist.centers.copy_(0.4 * torch.randn(gb.dist.centers.shape, generator=gen))
        gb.dist.vars.copy_(0.3 * torch.randn(gb.dist.vars.shape, generator=gen))
        gb.dist.weights.copy_(torch.randn(gb.dist.weights.shape, generator=gen))
    lit = scene.replace(bsdf=gb.to(dev), lights=Constant(radius=5.0, intensity=0.5).to(dev))
    mis = Direct(emitter_samples=1, bsdf_samples=1, training=False)
    out = {}
    for label, sc, integrator, per_tile in (
            ("NeuralApprox", scene, approx, {"fused_march": 1, "fused_shadow_march": 0}),
            ("Direct + GlobalNeuralBSDF (BSDF arm, Constant)", lit, mis,
             {"fused_march": 1, "fused_shadow_march": 2})):
        fn = lambda sc=sc, integrator=integrator: path_view(torch, dev, sc, integrator)
        got, counts = counted_view(torch, label, fn, per_tile)
        with plain_kernels():
            want = fn()
        frac, agree, mean_d, max_d = compare_images(label, got.cpu().numpy(), want.cpu().numpy())
        ms = cuda_ms(fn, 3)
        out[label] = dict(ms=ms, counts=counts, agree=agree, mean_diff=mean_d)
        print(f"(d) {label}, the NeRV checkpoint, view 0 at {NERV_SIZE}^2: {ms:.1f} ms/view; "
              f"K1 {counts['fused_mlp_forward']}, K2 {counts['fused_march']}, K4 "
              f"{counts['fused_shadow_march']} launches; against plain_kernels(): lit fraction "
              f"{frac:.4f}, mask agreement {agree:.6f}, mean |diff| {mean_d:.3e}, max |diff| "
              f"{max_d:.3e}")
    return out


def family_modules(torch, dev):
    """(d) each other new module once on the card against the CPU, the same
    params and inputs; NeuralWarp.prime on the card (the loss falls)."""
    import copy

    from neural_raytracing_tpu_torch import samplers, warps
    from neural_raytracing_tpu_torch.nn.mlp import (
        AutoDecoder, PartitionedAutoDecoder, TwoStageMLP,
    )
    gen = torch.Generator().manual_seed(31)
    n = FAMILY_POINTS
    p = 2.0 * torch.rand(n, 3, generator=gen) - 1.0
    q = 2.0 * torch.rand(n, 3, generator=gen) - 1.0
    errs = {}

    def card_cpu(name, module, *inputs, tol=1e-4):
        module.reset_parameters(torch.Generator().manual_seed(len(errs)))
        want = module(*inputs).detach()
        got = copy.deepcopy(module).to(dev)(*[x.to(dev) for x in inputs]).detach().cpu()
        errs[name] = (got - want).abs().max().item() / want.abs().max().item()
        check(errs[name] <= tol, f"{name}: card against CPU {errs[name]:.3e} > {tol}")

    card_cpu("TwoStageMLP", TwoStageMLP(), p, q)
    card_cpu("AutoDecoder", AutoDecoder(), p)
    card_cpu("PartitionedAutoDecoder", PartitionedAutoDecoder(), 3.5 * p)
    mm = warps.MipMap()
    val = 2.2 * torch.rand(n, 2, generator=gen) - 1.1
    mm.reset_parameters(torch.Generator().manual_seed(3))
    want = mm.pdf(val).detach()
    mm_d = copy.deepcopy(mm).to(dev)
    errs["MipMap.pdf"] = ((mm_d.pdf(val.to(dev)).detach().cpu() - want).abs().max().item()
                          / want.abs().max().item())
    check(errs["MipMap.pdf"] <= 1e-6, "MipMap.pdf card against CPU")
    uv, pdf = mm_d.sample(torch.Generator(device=dev).manual_seed(4), (n,))
    check(torch.equal(mm_d.pdf(uv), pdf), "MipMap.sample: the pdf at the sample")
    sh = warps.SphericalHarmonics(order=4)
    d = torch.randn(4096, 3, generator=gen)
    values = torch.sin(3 * d[:, 0]) + d[:, 2] ** 2
    want = sh.fit(d, values)
    got = copy.deepcopy(sh).to(dev).fit(d.to(dev), values.to(dev)).cpu()
    errs["SphericalHarmonics.fit"] = (got - want).abs().max().item() / want.abs().max().item()
    check(errs["SphericalHarmonics.fit"] <= 1e-3, "SphericalHarmonics.fit card against CPU")
    idx = torch.arange(3 * 1009)
    kc = samplers.permute_kensler(idx, 1009, 0x51633E2D)
    kd = samplers.permute_kensler(idx.to(dev), 1009, 0x51633E2D).cpu()
    check(torch.equal(kc, kd), "permute_kensler: card against CPU")
    # the strata are integers; the float32 position in a stratum may differ
    # in the last bit (on the card a division by a number is a product with
    # its reciprocal)
    so = {}
    for device in ("cpu", dev):
        s = samplers.OrthogonalSampler(SAMPLER_POINTS, jitter=False,
                                       generator=torch.Generator(device=device).manual_seed(0))
        so[str(device)] = s.next_2d(SAMPLER_POINTS).cpu()
    r = s.resolution
    a, b = so["cpu"], so[str(dev)]
    errs["OrthogonalSampler"] = (a - b).abs().max().item()
    check(torch.equal(torch.floor(a * r), torch.floor(b * r)) and errs["OrthogonalSampler"] <= 1e-6,
          f"OrthogonalSampler dims 0-1: card against CPU {errs['OrthogonalSampler']:.3e}")
    cells = torch.floor(b * r).to(torch.int64)
    check(len({tuple(c) for c in cells.tolist()}) == len(cells),
          "OrthogonalSampler: two samples share a stratum pair")
    warp = warps.NeuralWarp().to(dev)
    wgen = torch.Generator(device=dev).manual_seed(5)
    first = warp.prime(wgen, iters=1, batches=WARP_POINTS).item()
    torch.cuda.synchronize()
    start = time.perf_counter()
    last = warp.prime(wgen, iters=WARP_ITERS - 1, batches=WARP_POINTS).item()
    secs = time.perf_counter() - start
    check(math.isfinite(last) and last < first, f"NeuralWarp.prime: the loss went {first} -> {last}")
    print(f"(d) card against CPU (max |diff| over max): " + ", ".join(
        f"{k} {e:.2e}" for k, e in errs.items()) + f"; permute_kensler the same integers, "
          f"OrthogonalSampler (dims 0-1, {r}^2 strata, no jitter) the same strata; "
          f"NeuralWarp.prime "
          f"{WARP_ITERS} steps at {WARP_POINTS:,} directions: loss {first:.5f} -> {last:.5f}, "
          f"{1e3 * secs / (WARP_ITERS - 1):.2f} ms/step")
    return dict(errs=errs, prime=(first, last))


def phase_hash(torch, dev):
    """Phase 24: the hash-encoded surface and the rest of the NeRF family at
    full width -> the numbers for the summary line."""
    print(f"phase 24 on {card()}")
    start = time.perf_counter()
    c2ws = train_c2ws()
    imgs, masks = sphere_gt(torch, c2ws)
    parts = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        parts[name] = time.perf_counter() - t
        return out

    scene, flagship = timed("a", lambda: hash_flagship(torch, dev, c2ws, imgs, masks))
    enc = timed("b", lambda: hash_encoding_card(torch, dev))
    turns = timed("c", lambda: hash_turns(torch, dev, scene, c2ws, imgs, masks))
    views = timed("d views", lambda: family_views(torch, dev))
    modules = timed("d modules", lambda: family_modules(torch, dev))
    secs = time.perf_counter() - start
    print(f"phase 24 on {card()}: hash test view {turns['view_ms']['hash']:.1f} ms against "
          f"the spheres' {turns['view_ms']['spheres']:.1f} (busy a 128^2 view "
          f"{turns['busy']['hash 128^2 view']['busy_ms']:.1f} / "
          f"{turns['busy']['spheres 128^2 view']['busy_ms']:.1f}), hash step "
          f"{turns['step_ms']['hash']:.1f} ms against {turns['step_ms']['spheres']:.1f}, "
          f"{turns['march_step']['hash']} launch calls a plain hash march step; HashEncoding "
          f"on the card the same bits twice: {enc['same_bits']}; NeuralApprox view "
          f"{views['NeuralApprox']['ms']:.1f} ms, GlobalNeuralBSDF view "
          f"{views['Direct + GlobalNeuralBSDF (BSDF arm, Constant)']['ms']:.1f} ms; "
          f"NeuralWarp.prime {modules['prime'][0]:.4f} -> {modules['prime'][1]:.4f}; "
          f"phase 24 took {secs:.1f} s (" + ", ".join(f"({k}) {v:.1f} s" for k, v in parts.items())
          + ")")
    return dict(flagship=flagship, enc=enc, turns=turns, views=views, modules=modules,
                secs=secs)


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


# ---- phase 25: triangle meshes, the rasterizers, the native ops, the mesh GT ----------

MESH_SIZE = 200                                    # the mirror GT's published size
MESH_DIST = 2.0                                    # its camera distance (RESULTS.md:209)
MESH_TRAIN_VIEWS = 6                               # (c) of the published 100
MESH_TEST_VIEWS = 3                                # (c) of the published 16
MESH_SPP = 4                                       # (c), (d) Path passes, of the published 16
MESH_LIGHT = (1.0, 0.5, 1.2)                       # (a) the shadow rays' light
RASTER_SIZE = 256                                  # (b)
RASTER_BIN = 32
SEED_ITERS = 300                                   # (e) of the published 3,000
SEED_BATCH = 8192
MESH_NERV_STEPS = 10                               # (f)
MESH_NERV_CROP = 64
MESH_DTU_SIZE = 64                                 # (g) make_dtu_dataset's default
MESH_DTU_VIEWS = 6
MESH_DTU_STEPS = 10
MESH_DTU_CROP = 32


def mesh_rays(torch, dev, kind, mirror_plate):
    """(the TriangleMesh on ``dev``, the camera rays of a 200^2 view at
    distance 2 [40,000, 6], shadow rays from their hits towards MESH_LIGHT
    and the light's distances), on ``dev``."""
    from neural_raytracing_tpu_torch.render import _tile_positions
    from neural_raytracing_tpu_torch.shapes import TriangleMesh
    from neural_raytracing_tpu_torch.workloads import make_mesh_dataset as mm
    verts, faces, _ = mm.gt_mesh(kind, 1.0, mirror_plate)
    mesh = TriangleMesh(verts, faces).to(dev)
    cam = mm.nerf_camera(mm.c2w_up(30.0, 33.0, MESH_DIST, up="z"), MESH_SIZE).to(dev)
    rays = cam.sample_positions(_tile_positions(0.0, 0.0, MESH_SIZE, dev),
                                size=MESH_SIZE).reshape(-1, 6)
    it, hit = mesh.intersect(rays)
    to_light = torch.tensor(MESH_LIGHT, device=dev) - it.p[hit]
    dist = torch.linalg.norm(to_light, dim=-1)
    return mesh, rays, torch.cat([it.p[hit], to_light / dist[:, None]], dim=-1), dist


def mesh_intersect_card(torch, dev):
    """(a) TriangleMesh on the card against the CPU and the native backend,
    the gear with its plate and the knot -> {kind: numbers}.  The CPU
    backend takes every 8th ray of the knot (its 25 chunks take seconds on
    the host)."""
    from neural_raytracing_tpu_torch.shapes import TriangleMesh
    out = {}
    for kind, plate in (("gear", 0.7), ("knot", 0.0)):
        mesh, rays, shadow, dist = mesh_rays(torch, dev, kind, plate)
        every = 8 if kind == "knot" else 1
        verts, faces = mesh.verts.cpu().numpy(), mesh.faces.cpu().numpy()
        calls = {"card": (mesh, slice(None)),
                 "cpu": (TriangleMesh(verts, faces), slice(None, None, every)),
                 "native": (TriangleMesh(verts, faces, backend="native"), slice(None))}
        res, ms = {}, {}
        for name, (m, sub) in calls.items():
            r, s, d = ((rays, shadow, dist) if name == "card"
                       else (rays[sub].cpu(), shadow[sub].cpu(), dist[sub].cpu()))

            def both(m=m, r=r, s=s, d=d):
                it, hit = m.intersect(r)
                return it.t, hit, m.intersect_test(s, max_t=d)

            if name == "card":
                ms[name] = cuda_ms(both, 5)
            else:
                both()                                 # warm-up (the native build)
                t0 = time.perf_counter()
                both()
                ms[name] = 1e3 * (time.perf_counter() - t0)
            res[name] = [x.cpu() for x in both()]
        prof = profile_step(torch, lambda: mesh.intersect(rays),
                            f"TriangleMesh.intersect ({kind}, {len(rays):,} rays)")
        t_c, h_c, f_c = res["card"]
        line = [f"{kind}{' + plate ' + str(plate) if plate else ''}: {mesh.n_faces} "
                f"faces ({mesh.faces.shape[0] // mesh.chunk} chunks of {mesh.chunk}), "
                f"{len(rays):,} camera rays (hit {h_c.float().mean().item():.4f}), "
                f"{len(shadow):,} shadow rays (blocked {(~f_c).float().mean().item():.4f})"]
        for other in ("cpu", "native"):
            sub = calls[other][1]
            t_o, h_o, f_o = res[other]
            agree = (h_c[sub] == h_o).float().mean().item()
            both_hit = h_c[sub] & h_o
            dt = (t_c[sub] - t_o).abs()[both_hit].max().item() if both_hit.any() else 0.0
            free_agree = (f_c[sub] == f_o).float().mean().item()
            check(agree >= 0.999, f"TriangleMesh {kind}: hit agreement with {other} {agree}")
            check(dt <= 1e-4, f"TriangleMesh {kind}: |dt| {dt:.3e} against {other}")
            check(free_agree >= 0.999,
                  f"TriangleMesh {kind}: shadow agreement with {other} {free_agree}")
            line.append(f"card vs {other}{' (every 8th ray)' if every > 1 and other == 'cpu' else ''}"
                        f": hits agree {agree:.6f}, max |dt| {dt:.3e}, shadow flags agree "
                        f"{free_agree:.6f}")
        check(0.02 < h_c.float().mean().item() < 0.98, f"TriangleMesh {kind}: hit fraction")
        launches = prof["host_launches"] if prof else None
        line.append(f"intersect + intersect_test ms: card {ms['card']:.2f}, CPU "
                    f"{ms['cpu']:.1f}{' (an eighth of the rays)' if every > 1 else ''}, native "
                    f"{ms['native']:.1f}; launch calls an intersect {launches}")
        print("mesh (a) " + "; ".join(line))
        out[kind] = dict(ms=ms, launches=launches, chunks=mesh.faces.shape[0] // mesh.chunk)
    return out


def mesh_raster_card(torch, dev):
    """(b) the rasterizers on the card: the knot at 256^2, 8 faces a pixel,
    naive and binned (bin 32), equal; points, spheres and PulsarRenderer
    with gradients -> {name: ms}."""
    import numpy as np
    from neural_raytracing_tpu_torch import raster
    from neural_raytracing_tpu_torch.cameras import FoVPerspectiveCamera, look_at_view_transform
    from neural_raytracing_tpu_torch.workloads import make_mesh_dataset as mm
    verts, faces = mm.MESHES["knot"]()
    r, t = look_at_view_transform(dist=1.2, elev=20.0, azim=30.0)
    cam = FoVPerspectiveCamera(R=r.to(dev), T=t.to(dev))
    v = torch.from_numpy(verts).to(dev)
    f = torch.from_numpy(faces).to(dev)
    screen = raster.transform_points_screen(cam, v)
    kw = dict(image_size=RASTER_SIZE, faces_per_pixel=8)
    naive = raster.rasterize_meshes(screen, f, **kw)
    binned = raster.rasterize_meshes(screen, f, bin_size=RASTER_BIN, **kw)
    same = torch.equal(naive.idx, binned.idx)
    cover = (naive.idx[..., 0] >= 0).float().mean().item()
    check(same, "raster: binned idx differs from naive")
    check(all(torch.equal(getattr(naive, k), getattr(binned, k)) for k in ("zbuf", "dists",
                                                                           "bary")),
          "raster: binned fragments differ from naive")
    check(0.05 < cover < 0.95, f"raster: coverage {cover}")
    ms = {"naive": cuda_ms(lambda: raster.rasterize_meshes(screen, f, **kw), 3),
          "binned": cuda_ms(lambda: raster.rasterize_meshes(screen, f, bin_size=RASTER_BIN,
                                                            **kw), 3)}
    # points and spheres with gradients to their coordinates, pulsar to all its inputs
    gen = torch.Generator(device=dev).manual_seed(0)
    pts = screen.detach().clone().requires_grad_(True)
    rad = torch.full((len(verts),), 0.01, device=dev)
    w = torch.randn(RASTER_SIZE, RASTER_SIZE, 8, generator=gen, device=dev)

    def points():
        frags = raster.rasterize_points(pts, RASTER_SIZE, rad, 8)
        (torch.where(frags.idx >= 0, frags.zbuf * w, 0.0).sum()).backward()
        return frags

    def spheres():
        frags = raster.rasterize_spheres(torch.cat([pts, rad[:, None]], -1), RASTER_SIZE, 8)
        (torch.where(frags.idx >= 0, frags.dists * w, 0.0).sum()).backward()
        return frags

    pos = v.clone().requires_grad_(True)
    col = torch.rand(len(verts), 3, generator=gen, device=dev).requires_grad_(True)
    prad = torch.full((len(verts),), 0.02, device=dev, requires_grad=True)
    cam_params = torch.tensor([0.0, 0.0, -1.5, 0.0, 0.0, 0.0, 1.5, 2.0], device=dev,
                              requires_grad=True)
    pulsar = raster.PulsarRenderer(RASTER_SIZE, RASTER_SIZE)

    def render():
        img = pulsar(pos, col, prad, cam_params, gamma=0.1, max_depth=3.0)
        img.sum().backward()
        return img

    for name, fn in (("points", points), ("spheres", spheres), ("pulsar", render)):
        ms[name] = cuda_ms(fn, 3)
        out = fn()
        grads = [pts.grad] if name != "pulsar" else [pos.grad, col.grad, prad.grad,
                                                    cam_params.grad]
        check(all(g is not None and bool(torch.isfinite(g).all()) for g in grads),
              f"raster {name}: non-finite gradient")
        check(any(g.abs().sum().item() > 0 for g in grads), f"raster {name}: zero gradient")
        if name == "pulsar":
            check(out.std().item() > 1e-3, "raster pulsar: a flat image")
    print(f"mesh (b) the knot ({len(faces):,} faces) at {RASTER_SIZE}^2, 8 faces a pixel: "
          f"coverage {cover:.4f}, binned (bin {RASTER_BIN}) idx equal to naive {same}; ms naive {ms['naive']:.2f}, binned "
          f"{ms['binned']:.2f}; with gradients: points {ms['points']:.2f}, spheres "
          f"{ms['spheres']:.2f}, PulsarRenderer {ms['pulsar']:.2f}")
    return ms


def mesh_gt(torch, dev):
    """(c) the mirror GT of RESULTS.md:209 at 200^2 (gear, plate 0.7, nerv
    format, camera distance 2, z up, elevation 8-55, Path depth 2), the
    views and passes cut -> (args, run's dict, ms a view, ms a pass)."""
    import numpy as np
    from neural_raytracing_tpu_torch.kernels import launch_counts, reset_launch_counts
    from neural_raytracing_tpu_torch.workloads import make_mesh_dataset as mm
    args = mm.parser().parse_args([
        "--out", "(in memory)", "--kind", "gear", "--format", "nerv", "--size",
        str(MESH_SIZE), "--cam-dist", str(MESH_DIST), "--up", "z", "--elev-range", "8", "55",
        "--mirror-plate", "0.7", "--gt-bounces", "2", "--gt-spp", str(MESH_SPP),
        "--train-views", str(MESH_TRAIN_VIEWS), "--test-views", str(MESH_TEST_VIEWS),
        "--device", str(dev)])
    reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = mm.run(args, log_fn=lambda s: None)
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    counts = launch_counts()
    images = np.concatenate([out["train"][0], out["test"][0]])
    n_views = len(images) + 2                              # and the 2 exposure probes
    ms_view = 1e3 * secs / n_views
    scene = mm.build_gt_scene("gear", out["scale"], mirror_plate=0.7).init(
        torch.Generator().manual_seed(mm.SEED), device=dev)
    integ, _ = mm.gt_integrator(2)
    c2w = np.asarray(out["test"][1][0]["transform_matrix"], np.float32)
    light = np.asarray(out["test"][1][0]["light_loc"], np.float32)
    one = lambda: mm.render(scene, mm.nerf_camera(c2w, MESH_SIZE), light, out["scale"], integ, 1,
                            size=MESH_SIZE, device=dev)
    pass_ms = cuda_ms(one, 3)
    prof = profile_step(torch, one, "one Path pass of a 200^2 mirror GT view")
    direct, _ = mm.gt_integrator(1)
    direct_ms = cuda_ms(lambda: mm.render(scene, mm.nerf_camera(c2w, MESH_SIZE), light,
                                          out["scale"], direct, 1, size=MESH_SIZE,
                                          device=dev), 3)
    print(generator_report("mesh (c) mirror GT (gear + plate 0.7, Path depth 2, "
                           f"{MESH_SPP} passes a view)", counts, images[..., :3] / 255.0,
                           images[..., 3] > 127, secs))
    print(f"mesh (c) light scale {out['scale']:.4f} (auto-exposure); {ms_view:.1f} ms a view "
          f"({MESH_SPP} Path passes), {pass_ms:.1f} ms a Path pass, a Direct view "
          f"{direct_ms:.1f} ms; launch calls a Path pass "
          f"{prof['host_launches'] if prof else None}, so {MESH_SPP} x that a view")
    return args, out, dict(ms_view=ms_view, pass_ms=pass_ms, direct_ms=direct_ms,
                           launches=prof["host_launches"] if prof else None, secs=secs)


def mesh_nerv_data(out, split):
    from neural_raytracing_tpu_torch.workloads import make_nerv_dataset as mn
    return mn.as_dataset(*out[split], MESH_SIZE)


def mesh_path_demo(torch, dev, gt_args, out):
    """(d) workloads.path_demo.run on (c)'s test views."""
    import numpy as np
    from neural_raytracing_tpu_torch.workloads import path_demo
    args = path_demo.parser().parse_args(["--data", "(in memory)", "--samples", str(MESH_SPP),
                                          "--device", str(dev)])
    start = time.perf_counter()
    res = path_demo.run(args, mesh_nerv_data(out, "test"), out["meta"], log_fn=lambda s: None)
    secs = time.perf_counter() - start
    rows = res["per_view"]
    check(all(np.isfinite([r["psnr_direct"], r["psnr_path"]]).all() for r in rows),
          f"path_demo: {rows}")
    check(res["delta"] > 0, f"path_demo: Path behind Direct on average ({res['delta']:.3f} dB)")
    print(f"mesh (d) path_demo ({len(rows)} test views, {MESH_SPP} passes): PSNR Direct "
          f"{[round(r['psnr_direct'], 3) for r in rows]}, Path "
          f"{[round(r['psnr_path'], 3) for r in rows]}; means {res['avg_psnr_direct']:.3f} / "
          f"{res['avg_psnr_path']:.3f} (delta {res['delta']:+.3f} dB); Path ahead on "
          f"{sum(r['psnr_path'] > r['psnr_direct'] for r in rows)} of {len(rows)} views; "
          f"{secs:.1f} s")
    return res


def mesh_seed(torch, dev, root):
    """(e) workloads.seed_shape for the gear and plate, SEED_ITERS of its
    3,000 iterations at batch 8,192, counted (K1); the scene saved as
    ``{root}/nerv_mesh``."""
    import numpy as np
    from neural_raytracing_tpu_torch.training import save_scene
    from neural_raytracing_tpu_torch.workloads import seed_shape
    args = seed_shape.parser().parse_args([
        "--kind", "gear", "--mirror-plate", "0.7", "--name", "mesh", "--iters",
        str(SEED_ITERS), "--batch", str(SEED_BATCH), "--device", str(dev)])
    res, counts, secs = counted(torch, "seed_shape", lambda: seed_shape.run(
        args, log_fn=lambda s: None))
    # the fit's own ms an iteration: 50 more steps from where it stopped
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seed_shape.fit(res["scene"], res["points"], res["targets"], iters=50, batch=SEED_BATCH,
                   generator=gen, log_fn=lambda s: None)
    torch.cuda.synchronize()
    iter_ms = 1e3 * (time.perf_counter() - t0) / 50
    prof = profile_step(torch, lambda: seed_shape.fit(
        res["scene"], res["points"], res["targets"], iters=1, batch=SEED_BATCH,
        generator=gen, log_fn=lambda s: None), "one seed_shape iteration")
    losses = res["losses"].cpu().numpy()
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    check(np.isfinite(losses).all() and last < first,
          f"seed_shape: the Huber loss did not fall ({first} -> {last})")
    save_scene(str(root / "nerv_mesh"), res["scene"], step=0)
    rep = res["report"]
    print(f"mesh (e) seed_shape (gear + plate, {SEED_ITERS} of 3,000 iterations, batch "
          f"{SEED_BATCH:,}): Huber {losses[0]:.6f} -> {losses[-1]:.6f} (means of the first and "
          f"last 20: {first:.6f} -> {last:.6f}), |f - d| p50 {rep['p50']:.4f} p90 "
          f"{rep['p90']:.4f}, volume frac_neg {rep['frac_neg']:.3f}; run {secs:.2f} s (the "
          f"probes and the report included), {iter_ms:.2f} ms an iteration of the fit, launch "
          f"calls an iteration {prof['host_launches'] if prof else None}; K1 launches "
          f"{counts['fused_mlp_forward']}; launches {counts}")
    return res, iter_ms


def mesh_nerv(torch, dev, root, out):
    """(f) the NeRV twin on (c)'s data from the seeded scene: one step with
    hard occlusion against plain_kernels(), then workloads.nerv.run
    (the published flags: --load --dist 3.4 --no-ssim --nan-skip
    --device-data --clip-norm 10) for MESH_NERV_STEPS steps, counted
    (K1-K4), and its test view in both shadow modes."""
    import copy

    import numpy as np
    from neural_raytracing_tpu_torch.cameras import NeRFCamera
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.render import _tile_positions
    from neural_raytracing_tpu_torch.training import (
        NeRVDataset, TrainState, build_step_fn, load_scene, make_optimizer,
    )
    from neural_raytracing_tpu_torch.workloads import nerv
    data, test = mesh_nerv_data(out, "train"), mesh_nerv_data(out, "test")
    scene = nerv.build_scene(dist=3.4, occlusion="hard").init(
        torch.Generator().manual_seed(0), device=dev)
    load_scene(str(root / "nerv_mesh"), scene)
    spec = make_optimizer(NERV_LRS)
    make_camera = lambda idxs: NeRFCamera(torch.from_numpy(data.cam_to_worlds[np.asarray(idxs)]),
                                          data.focal)
    idxs = [0, 1, 2]
    u = v = (MESH_SIZE - MESH_NERV_CROP) // 2
    exp = torch.from_numpy(data.images[idxs, u:u + MESH_NERV_CROP, v:v + MESH_NERV_CROP]).to(dev)
    mask = torch.from_numpy(data.masks[idxs, u:u + MESH_NERV_CROP, v:v + MESH_NERV_CROP]).to(dev)
    rays = make_camera(idxs).to(dev).sample_positions(
        _tile_positions(float(u), float(v), MESH_NERV_CROP, dev), size=MESH_SIZE)
    res = {}
    for label in ("kernels", "plain"):
        sc = copy.deepcopy(scene)
        sc.lights.set_location(data.light_locs[idxs])
        step = build_step_fn(sc, Direct(training=True), spec, size=MESH_SIZE,
                             crop_size=MESH_NERV_CROP, tone_mapping=True)
        if label == "plain":
            with plain_kernels():
                _, aux = step(TrainState(sc, spec.init(sc), 0), make_camera(idxs), (u, v), exp,
                              mask)
                with torch.no_grad():
                    _, hit = sc.shape.intersect(rays, primary=False)
        else:
            (_, aux), counts, _ = counted(torch, "mesh NeRV step", lambda: step(
                TrainState(sc, spec.init(sc), 0), make_camera(idxs), (u, v), exp, mask))
            with torch.no_grad():
                _, hit = sc.shape.intersect(rays, primary=False)
        grads = {c: torch.cat([p.grad.reshape(-1) for p in getattr(sc, c).parameters()
                               if p.grad is not None] or [torch.zeros(1, device=dev)])
                 for c in ("shape", "bsdf", "lights")}
        res[label] = (aux["loss"].item(), grads, hit)
        del sc
    for name in ("fused_mlp_forward", "fused_march", "fused_min_scan", "fused_shadow_march"):
        check(counts[name] > 0, f"mesh NeRV step: kernel {name} was not launched")
    (lk, gk, hk), (lp, gp, hp) = res["kernels"], res["plain"]
    rel_loss = abs(lk - lp) / abs(lp)
    n_hit_diff = int((hk != hp).sum().item())
    rel_g = {c: ((gk[c] - gp[c]).norm() / gp[c].norm().clamp_min(1e-30)).item() for c in gk}
    print(f"mesh (f) NeRV step on the mirror GT from the seeded scene (hard occlusion, 3 x "
          f"{MESH_NERV_CROP}^2 at the centre; kernels vs plain_kernels()): loss {lk:.6f} vs "
          f"{lp:.6f} (rel {rel_loss:.3e}), rays whose hit differs {n_hit_diff} of {hk.numel()} "
          f"(hit fraction {hp.float().mean().item():.4f}), gradient rel L2 "
          f"{', '.join(f'{c} {e:.3e}' for c, e in rel_g.items())}; launches {counts}")
    check(np.isfinite(lk) and rel_loss <= 1e-4, f"mesh NeRV step: loss rel {rel_loss:.3e}")
    check(n_hit_diff <= 0.001 * hk.numel(), f"mesh NeRV step: {n_hit_diff} hit flags differ")
    check(hp.any().item(), "mesh NeRV step: no ray hit the seeded surface")
    for c, e in rel_g.items():
        check(gp[c].norm().item() > 0, f"mesh NeRV step: no {c} gradient")
        check(e <= 1e-2, f"mesh NeRV step: {c} gradient rel L2 {e:.3e} > 1e-2")

    args = twin_args(nerv, size=MESH_SIZE, crop_size=MESH_NERV_CROP, iters=MESH_NERV_STEPS,
                     log_every=0, device=str(dev), device_data=True, load=True, dist=3.4,
                     no_ssim=True, nan_skip=True, clip_norm=10.0, models=str(root))
    one_test = NeRVDataset(test.cam_to_worlds[:1], test.focal, test.images[:1],
                           test.masks[:1], test.light_locs[:1], None)
    (state, tres), counts, secs = counted(torch, "mesh NeRV twin", lambda: nerv.run(
        args, data, one_test, name="mesh", save=False))
    for name in ("fused_mlp_forward", "fused_march", "fused_min_scan", "fused_shadow_march"):
        check(counts[name] > 0, f"mesh NeRV twin: kernel {name} was not launched")
    check(np.isfinite(tres["losses"]).all(), f"mesh NeRV twin: losses {tres['losses']}")
    for tag in ("soft", "hard"):
        check(all(np.isfinite(v) for v in tres[tag].values()), f"mesh NeRV test: {tres[tag]}")
    black = black_psnr(np.clip(one_test.images, 0, 1))
    print(f"mesh (f) workloads.nerv.run --load (seeded) --dist 3.4 --no-ssim --nan-skip "
          f"--device-data --clip-norm 10, {MESH_NERV_STEPS} steps of 3 x {MESH_NERV_CROP}^2 and "
          f"one test view: {secs:.1f} s, losses {[round(x, 4) for x in tres['losses']]}; test "
          f"PSNR soft {tres['soft']['psnr']:.3f}, hard {tres['hard']['psnr']:.3f} dB (black "
          f"{black:.3f}); launches {counts}")
    return dict(rel_loss=rel_loss, counts=counts, psnr={t: tres[t]["psnr"] for t in
                                                        ("soft", "hard")}, black=black)


def mesh_dtu(torch, dev):
    """(g) make_dtu_dataset --mesh knot at 64^2, then workloads.dtu.run on
    it (K1-K3) with its masked test view."""
    import numpy as np
    from neural_raytracing_tpu_torch.kernels import launch_counts, reset_launch_counts
    from neural_raytracing_tpu_torch.training import dtu_dataset
    from neural_raytracing_tpu_torch.workloads import dtu
    from neural_raytracing_tpu_torch.workloads import make_dtu_dataset as md
    scene = md.build_scene(mesh="knot").init(torch.Generator().manual_seed(md.SEED), device=dev)
    reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    images, masks, cams = md.render_scan(scene, MESH_DTU_VIEWS, MESH_DTU_SIZE, device=dev,
                                         log_fn=lambda s: None, rig=md.mesh_rig())
    secs = time.perf_counter() - start
    gen_counts = launch_counts()
    imgs, msks = md.as_arrays(images, masks)
    print(generator_report("mesh (g) DTU generator --mesh knot (variety, 3-light ring)",
                           gen_counts, imgs, msks, secs))
    data = dtu_dataset(cams, imgs, msks, MESH_DTU_SIZE, src_size=(MESH_DTU_SIZE, MESH_DTU_SIZE))
    args = twin_args(dtu, size=MESH_DTU_SIZE, crop_size=MESH_DTU_CROP, iters=MESH_DTU_STEPS,
                     log_every=0, device=str(dev), device_data=True)
    (state, res), counts, secs = counted(torch, "mesh DTU twin", lambda: dtu.run(
        args, data, save=False))
    for name in ("fused_mlp_forward", "fused_march", "fused_min_scan"):
        check(counts[name] > 0, f"mesh DTU twin: kernel {name} was not launched")
    check(np.isfinite(res["losses"]).all() and np.isfinite(res["test"]["psnr"]),
          f"mesh DTU twin: {res['losses']}, {res['test']}")
    test_idx = dtu.split(len(data.images), args.test_every)[1]
    gt = data.images[test_idx] * data.masks[test_idx, ..., None]
    print(f"mesh (g) workloads.dtu.run on the knot scan ({MESH_DTU_VIEWS} views at "
          f"{MESH_DTU_SIZE}^2, {MESH_DTU_STEPS} steps of 3 x {MESH_DTU_CROP}^2, the device data "
          f"path) and its masked test on views {[int(i) for i in test_idx]}: {secs:.1f} s, losses "
          f"{[round(x, 4) for x in res['losses']]}, test PSNR {res['test']['psnr']:.3f} dB "
          f"(black {black_psnr(gt):.3f}); launches {counts}")
    return counts


def phase_mesh(torch, dev):
    """Phase 25: triangle meshes, the rasterizers, the native host ops and
    the mesh ground truth with its users -> the numbers for the summary."""
    import tempfile
    print(f"phase 25 on {card()}")
    start = time.perf_counter()
    parts = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        parts[name] = time.perf_counter() - t
        return out

    inter = timed("a", lambda: mesh_intersect_card(torch, dev))
    ras = timed("b", lambda: mesh_raster_card(torch, dev))
    gt_args, gt, gt_ms = timed("c", lambda: mesh_gt(torch, dev))
    demo = timed("d", lambda: mesh_path_demo(torch, dev, gt_args, gt))
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        _, seed_ms = timed("e", lambda: mesh_seed(torch, dev, root))
        nv = timed("f", lambda: mesh_nerv(torch, dev, root, gt))
    dt = timed("g", lambda: mesh_dtu(torch, dev))
    secs = time.perf_counter() - start
    print(f"phase 25 on {card()}: TriangleMesh intersect + test on 40,000 + shadow rays gear "
          f"{inter['gear']['ms']['card']:.2f} ms ({inter['gear']['launches']} launches an "
          f"intersect), knot {inter['knot']['ms']['card']:.2f} ms "
          f"({inter['knot']['launches']}); raster at 256^2 naive {ras['naive']:.2f} ms, binned "
          f"{ras['binned']:.2f}; mirror GT {gt_ms['pass_ms']:.1f} ms a Path pass "
          f"({gt_ms['launches']} launches), Direct {gt_ms['direct_ms']:.1f} ms a view; "
          f"path_demo delta {demo['delta']:+.3f} dB; seed fit {seed_ms:.2f} ms an iteration; "
          f"phase 25 took {secs:.1f} s (" + ", ".join(f"({k}) {v:.1f} s"
                                                       for k, v in parts.items()) + ")")
    return dict(intersect=inter, raster=ras, gt=gt_ms, demo=demo, seed_ms=seed_ms, nerv=nv,
                dtu=dt, secs=secs)


PARALLEL_STEPS = 3                                 # (a)
FIT_SIZE = 64                                      # (b) scripts/fit_sphere.py's default
FIT_ITERS = 100
VIS_SIZE = 128                                     # (c) the vis scripts' default
VIS_GEN_SIZE = 64                                  # (c) the NeRV and DTU data
GAN_SIZE = 64                                      # (d) the critic's native size
GAN_VIEWS = 2
GAN_STEPS = 5


def nonblack_on_hits(label, img, hit, least: float) -> float:
    """The share of the hit pixels where ``img`` is not black; fails below
    ``least`` or when nothing is hit."""
    import numpy as np
    check(np.isfinite(img).all(), f"{label}: not finite")
    check(hit.any(), f"{label}: the surface is hit nowhere")
    share = float((np.abs(img).max(axis=-1) > 0)[hit].mean())
    check(share >= least, f"{label}: black on {1 - share:.4f} of the hit pixels")
    return share


def hit_mask(torch, scene, camera, size) -> "np.ndarray":
    """Where the scene's surface is hit on ``camera``'s unjittered pixel
    centres ``[size, size]``."""
    from neural_raytracing_tpu_torch.render import _tile_positions
    dev = next(scene.parameters()).device
    rays = camera.to(dev).sample_positions(_tile_positions(0.0, 0.0, size, dev), size=size)
    with torch.no_grad():
        _, hit = scene.shape.intersect(rays, primary=False)
    return hit[0, ..., 0].cpu().numpy()


def parallel_flagship(torch, dev, mesh, c2ws, imgs, masks):
    """(a) train(mesh=) against train(mesh=None), the kernel_bwd step and
    sharded_render_rays -> the numbers for the summary."""
    import numpy as np
    from neural_raytracing_tpu_torch.cameras import NeRFCamera
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.kernels import launch_counts, reset_launch_counts
    from neural_raytracing_tpu_torch.parallel import sharded_render_rays
    from neural_raytracing_tpu_torch.render import _tile_positions
    from neural_raytracing_tpu_torch.training import TrainState, make_optimizer, train
    spec = make_optimizer(LRS)
    make_camera = lambda idxs: NeRFCamera(torch.from_numpy(c2ws[np.asarray(idxs)]), FOCAL)

    def run(with_mesh, label, iters=PARALLEL_STEPS, kernel_bwd=False):
        scene = flagship_scene(torch, dev, "spheres")
        set_kernel_bwd(torch, scene, kernel_bwd, 0)
        state = TrainState(scene, spec.init(scene), 0)
        reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, losses = train(scene, Direct(training=True), spec, state, make_camera, imgs,
                              masks, torch.Generator(device=dev).manual_seed(1), size=SIZE,
                              crop_size=CROP_SIZE, iters=iters, n_views=N_VIEWS, log_every=0,
                              mesh=mesh if with_mesh else None)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - start) / iters
        counts = launch_counts()
        k1_routes(label)
        check(len(losses) == iters and np.isfinite(losses).all(), f"{label}: losses {losses}")
        return dict(losses=losses, state={k: v.clone() for k, v in scene.state_dict().items()},
                    counts=counts, ms=ms, scene=scene)

    # one step of each route first: the plain loop's allocator and the NCCL
    # communicator the mesh route sets up at its first collective
    run(False, "(a) train, warm-up", iters=1)
    run(True, "(a) train, mesh warm-up", iters=1)
    runs = {}
    for i, with_mesh in enumerate((False, True, True, False)):
        label = f"{'mesh' if with_mesh else 'plain'} {i}"
        runs[label] = run(with_mesh, f"(a) train, {label}")
    plain, meshed = runs["plain 0"], runs["mesh 1"]
    same_state = all(torch.equal(plain["state"][k], v) for k, v in meshed["state"].items())
    plain_again = all(torch.equal(plain["state"][k], v)
                      for k, v in runs["plain 3"]["state"].items())
    kernels = ("fused_mlp_forward", "fused_march", "fused_min_scan")
    for name in kernels:
        check(plain["counts"][name] > 0, f"(a) {name} was not launched on the plain loop")
    print(f"  (a) {PARALLEL_STEPS} steps: losses plain {plain['losses']}, mesh "
          f"{meshed['losses']}; the same loss bits {plain['losses'] == meshed['losses']}, "
          f"parameter bits {same_state} (plain against plain: {plain_again}); launches "
          + ", ".join(f"{n} {plain['counts'][n]} / {meshed['counts'][n]}" for n in kernels))
    check(plain["losses"] == meshed["losses"] and runs["mesh 2"]["losses"] == meshed["losses"],
          "(a) the world-one step's losses are not the plain loop's bits")
    check(same_state, "(a) the world-one step's parameters are not the plain loop's bits")
    check(all(plain["counts"][n] == meshed["counts"][n] for n in kernels),
          "(a) the world-one step launched K1-K3 another number of times")
    ms = {k: (runs[f"{k} 0" if k == "plain" else "mesh 1"]["ms"]
              + runs["plain 3" if k == "plain" else "mesh 2"]["ms"]) / 2
          for k in ("plain", "mesh")}
    step_ms, busy = mesh_step_turns(torch, dev, mesh, spec, make_camera, imgs, masks)
    bwd = run(True, "(a) train, mesh, kernel_bwd", iters=1, kernel_bwd=True)
    check(bwd["counts"]["fused_mlp_backward"] > 0, "(a) K6 was not launched under the mesh")

    scene = meshed["scene"]
    test = scene.replace(shape=scene.shape.replace(max_steps=256, march_bound=1.2))
    rays = make_camera([0]).to(dev).sample_positions(
        _tile_positions((SIZE - CHUNK) / 2, (SIZE - CHUNK) / 2, CHUNK, dev),
        size=SIZE).reshape(-1, 6)
    reset_launch_counts()
    with torch.no_grad():
        values, active = sharded_render_rays(test, rays, Direct(training=False), mesh)
        want, want_active, _ = Direct(training=False).sample(test, rays)
    render_counts = launch_counts()
    err = (values - want).abs().max().item()
    same = torch.equal(values, want) and torch.equal(active, want_active)
    check(err <= 1e-5 and torch.equal(active, want_active),
          f"(a) sharded_render_rays differs from Direct.sample by {err:.3e}")
    check(render_counts["fused_march"] > 0, "(a) sharded_render_rays: K2 was not launched")
    print(f"  (a) world-one step {ms['mesh']:.1f} ms against the plain loop's "
          f"{ms['plain']:.1f} ms (host clock, the mean of two turns after a warm-up step "
          "of each route; "
          + ", ".join(f"{k} {v['ms']:.1f}" for k, v in runs.items()) + "); kernel_bwd step under "
          f"the mesh: K6 launches {bwd['counts']['fused_mlp_backward']}; sharded_render_rays "
          f"on a {CHUNK}^2 eval tile: max |difference| {err:.3e}, the same bits {same}, hit "
          f"fraction {active.float().mean().item():.4f}")
    return dict(ms=ms, step_ms=step_ms, busy=busy, counts=meshed["counts"],
                same_bits=same_state, render_same=same)


def mesh_step_turns(torch, dev, mesh, spec, make_camera, imgs, masks):
    """The step alone, warm (no loop, no broadcast): phase 7's first 6 views
    and silhouette crop through the plain step and the world-one step in
    turns (CUDA events, the median of 5 calls a turn), then one profile of
    each -> (ms by route, the profiles)."""
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.parallel import make_parallel_train_step
    from neural_raytracing_tpu_torch.training import TrainState, build_step_fn
    idxs = list(range(N_VIEWS))
    u, v = silhouette_crop()
    exp = torch.from_numpy(imgs[idxs, u:u + CROP_SIZE, v:v + CROP_SIZE]).to(dev)
    mask = torch.from_numpy(masks[idxs, u:u + CROP_SIZE, v:v + CROP_SIZE]).to(dev)
    camera = make_camera(idxs)
    kw = dict(size=SIZE, crop_size=CROP_SIZE)
    fns = {}
    for label in ("plain", "mesh"):
        scene = flagship_scene(torch, dev, "spheres")
        step = (build_step_fn(scene, Direct(training=True), spec, **kw) if label == "plain"
                else make_parallel_train_step(scene, Direct(training=True), spec, mesh,
                                              n_views=N_VIEWS, **kw))
        box = [TrainState(scene, spec.init(scene), 0),
               torch.Generator(device=dev).manual_seed(1)]

        def one(step=step, box=box):
            box[0] = step(box[0], camera, (u, v), exp, mask, box[1])[0]
        fns[label] = one
    ms = in_turns(fns)
    busy = {k: profile_step(torch, fn, f"(a) one step, {k}") for k, fn in fns.items()}
    print(f"  (a) the step alone, warm, in turns: world-one {ms['mesh']:.2f} ms against the "
          f"plain step's {ms['plain']:.2f} ms (CUDA events, the median of the turns' medians)"
          + "".join(f"; {k}: busy {b['busy_ms']:.1f} ms, {b['launches']} launches, host "
                    f"launch calls {b['host_launches']}" for k, b in busy.items() if b))
    return ms, busy


def parallel_fit_sphere(torch, dev):
    """(b) workloads.fit_sphere.run at 64^2 for 100 iterations."""
    import numpy as np
    from neural_raytracing_tpu_torch.workloads import fit_sphere
    args = fit_sphere.parser().parse_args(["--size", str(FIT_SIZE), "--iters", str(FIT_ITERS),
                                           "--log-every", "0", "--device", str(dev)])
    out, counts, secs = counted(torch, "(b) fit_sphere",
                                lambda: fit_sphere.run(args, save=False, log_fn=lambda *a: None))
    losses = np.asarray(out["losses"])
    for name in ("fused_march", "fused_min_scan"):
        check(counts[name] > 0, f"(b) fit_sphere: {name} was not launched")
    check(losses[-10:].mean() < losses[:10].mean(), f"(b) fit_sphere: the loss did not fall "
          f"({losses[:10].mean():.4f} -> {losses[-10:].mean():.4f})")
    check(all(np.isfinite(v) for v in out["metrics"].values()), f"(b) {out['metrics']}")
    print(f"  (b) fit_sphere at {FIT_SIZE}^2: {FIT_ITERS} iterations and its evaluate in "
          f"{secs:.2f} s, loss {losses[:10].mean():.4f} -> {losses[-10:].mean():.4f} (the means "
          f"of the first and last 10), test PSNR {out['metrics']['psnr']:.3f}; launches K1 "
          f"{counts['fused_mlp_forward']}, K2 {counts['fused_march']}, K3 "
          f"{counts['fused_min_scan']}")
    return dict(secs=secs, counts=counts, loss=(losses[:10].mean(), losses[-10:].mean()))


def parallel_vis(torch, dev, root, c2ws, imgs, masks):
    """(c) the three visualization twins on models that 2 training steps of
    each workload twin saved."""
    import numpy as np
    from neural_raytracing_tpu_torch.cameras import NeRFCamera
    from neural_raytracing_tpu_torch.training import NeRFDataset, save_scene
    from neural_raytracing_tpu_torch.workloads import (
        dtu, dtu_vis, nerf_synthetic, nerv, nerv_vis, visualize,
    )
    from neural_raytracing_tpu_torch.workloads._common import load_trained
    models = str(root / "models")
    quiet = dict(log_every=0, device=str(dev), models=models)
    state, _ = nerf_synthetic.run(
        twin_args(nerf_synthetic, size=SIZE, crop_size=CROP_SIZE, n_views=N_VIEWS, iters=2,
                  valid_freq=0, **quiet),
        NeRFDataset(c2ws, FOCAL, imgs, masks), None, name="smoke", save=False)
    save_scene(f"{models}/smoke", state.scene)
    nv, _, _, _ = nerv_generated(torch, dev, VIS_GEN_SIZE, train_views=4, test_views=1)
    state, _ = nerv.run(twin_args(nerv, size=VIS_GEN_SIZE, crop_size=VIS_GEN_SIZE, iters=2,
                                  **quiet), nv, None, name="smoke", save=False)
    save_scene(f"{models}/nerv_smoke", state.scene)
    scan, _, _ = dtu_scan(torch, dev, VIS_GEN_SIZE, 4)
    state, _ = dtu.run(twin_args(dtu, size=VIS_GEN_SIZE, crop_size=32, iters=2, **quiet), scan,
                       name="smoke", save=False)
    save_scene(f"{models}/dtu_smoke", state.scene)

    focal = FOCAL * VIS_SIZE / SIZE
    view = NeRFDataset(c2ws, focal, np.zeros((len(c2ws), VIS_SIZE, VIS_SIZE, 3)),
                       np.zeros((len(c2ws), VIS_SIZE, VIS_SIZE)))
    shares = {}
    v, counts, secs_v = counted(torch, "(c) visualize", lambda: visualize.run(
        twin_args(visualize, size=VIS_SIZE, n_orbit=1, **quiet), view, "smoke", save=False,
        log_fn=lambda *a: None))
    check(counts["fused_march"] > 0, "(c) visualize: K2 was not launched")
    scene = load_trained(nerf_synthetic.build_scene(max_steps=128), f"{models}/smoke", dev)
    hit = hit_mask(torch, scene, NeRFCamera(torch.from_numpy(c2ws[:1]), focal), VIS_SIZE)
    shares["visualize render"] = nonblack_on_hits("(c) visualize render", v["orbit"][0], hit, 0.9)
    shares["visualize normals"] = nonblack_on_hits("(c) visualize normals", v["normals"][0], hit,
                                                   0.99)
    weights = np.concatenate(v["basis"], axis=-1)
    shares["visualize weights"] = nonblack_on_hits("(c) visualize weights", weights, hit, 0.99)
    for b, img in enumerate(v["spheres"]):
        check(np.isfinite(img).all() and img.max() > 0, f"(c) visualize sphere {b}")

    n, counts_n, secs_n = counted(torch, "(c) nerv_vis", lambda: nerv_vis.run(
        twin_args(nerv_vis, size=VIS_GEN_SIZE, views=2, **quiet), nv, "smoke", save=False))
    scene = load_trained(nerv.build_scene(max_steps=128), f"{models}/nerv_smoke", dev)
    for i in n["normals"]:
        hit = hit_mask(torch, scene, NeRFCamera(torch.from_numpy(nv.cam_to_worlds[i:i + 1]),
                                                nv.focal), VIS_GEN_SIZE)
        shares[f"nerv_vis normals {i}"] = nonblack_on_hits(
            f"(c) nerv_vis normals {i}", n["normals"][i], hit, 0.99)
        shares[f"nerv_vis weights {i}"] = nonblack_on_hits(
            f"(c) nerv_vis weights {i}", np.concatenate(n["weights"][i], axis=-1), hit, 0.99)
        check(np.isfinite(n["sil"][i]).all(), f"(c) nerv_vis silhouette {i}")

    d, counts_d, secs_d = counted(torch, "(c) dtu_vis", lambda: dtu_vis.run(
        twin_args(dtu_vis, size=VIS_GEN_SIZE, views=2, **quiet), scan, "smoke", save=False))
    scene = load_trained(dtu.build_scene(max_steps=128), f"{models}/dtu_smoke", dev)
    make_camera = dtu.camera_maker(scan)
    for i in d["normals"]:
        hit = hit_mask(torch, scene, make_camera([i]), VIS_GEN_SIZE)
        shares[f"dtu_vis normals {i}"] = nonblack_on_hits(
            f"(c) dtu_vis normals {i}", d["normals"][i], hit, 0.99)
        shares[f"dtu_vis render {i}"] = nonblack_on_hits(
            f"(c) dtu_vis render {i}", d["render"][i], hit, 0.9)
    for label, c in (("nerv_vis", counts_n), ("dtu_vis", counts_d)):
        check(c["fused_march"] > 0, f"(c) {label}: K2 was not launched")
    print(f"  (c) visualize {secs_v:.2f} s ({VIS_SIZE}^2, 1 orbit view, 8 sphere renders), "
          f"nerv_vis {secs_n:.2f} s, dtu_vis {secs_d:.2f} s ({VIS_GEN_SIZE}^2, 2 views); "
          f"non-black share of the hit pixels: "
          + ", ".join(f"{k} {v:.4f}" for k, v in shares.items())
          + f"; launches K1/K2: visualize {counts['fused_mlp_forward']}/"
          f"{counts['fused_march']}, nerv_vis {counts_n['fused_mlp_forward']}/"
          f"{counts_n['fused_march']}, dtu_vis {counts_d['fused_mlp_forward']}/"
          f"{counts_d['fused_march']}")
    return dict(counts=counts, shares=shares)


def parallel_gan(torch, dev, imgs):
    """(d) workloads.exp_gan.train_gan for 5 steps."""
    import numpy as np
    from neural_raytracing_tpu_torch.kernels import launch_counts, reset_launch_counts
    from neural_raytracing_tpu_torch.workloads import exp_gan
    step = SIZE // GAN_SIZE
    reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = exp_gan.train_gan(imgs[:, ::step, ::step], size=GAN_SIZE, n_views=GAN_VIEWS,
                            iters=GAN_STEPS, device=dev, log_every=0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    counts = launch_counts()
    check(counts["fused_composite"] > 0, "(d) exp_gan: K8 was not launched")
    check(np.isfinite(out["d_losses"] + out["g_losses"]).all(), f"(d) exp_gan: {out}")
    print(f"  (d) exp_gan: {GAN_STEPS} steps at {GAN_SIZE}^2 x {GAN_VIEWS} views in "
          f"{secs:.2f} s ({1e3 * secs / GAN_STEPS:.1f} ms a step), critic losses "
          f"{[round(x, 4) for x in out['d_losses']]}, generator "
          f"{[round(x, 4) for x in out['g_losses']]}; K8 launches {counts['fused_composite']}")
    return dict(secs=secs, counts=counts)


def parallel_trace(torch, dev, root, mesh, c2ws, imgs, masks):
    """(e) profiling.trace over one data-parallel step."""
    import numpy as np
    from neural_raytracing_tpu_torch import profiling
    from neural_raytracing_tpu_torch.cameras import NeRFCamera
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.training import TrainState, make_optimizer, train
    spec = make_optimizer(LRS)
    scene = flagship_scene(torch, dev, "spheres")
    make_camera = lambda idxs: NeRFCamera(torch.from_numpy(c2ws[np.asarray(idxs)]), FOCAL)
    with profiling.trace(str(root / "trace")) as prof:
        with profiling.annotate("nrt_parallel_step"):
            train(scene, Direct(training=True), spec, TrainState(scene, spec.init(scene), 0),
                  make_camera, imgs, masks, torch.Generator(device=dev).manual_seed(1),
                  size=SIZE, crop_size=CROP_SIZE, iters=1, n_views=N_VIEWS, log_every=0,
                  mesh=mesh)
            torch.cuda.synchronize()
    text = Path(prof.trace_path).read_text()
    check("nrt_parallel_step" in text, "(e) the annotate range is not in the trace")
    kernel = "nrt_mlp_tile_f32_kernel" in text
    print(f"  (e) profiling.trace: {Path(prof.trace_path).name}, "
          f"{len(text) / 2**20:.1f} MiB, the annotate range in it, K1's kernel in it {kernel}")
    return dict(mib=len(text) / 2**20, kernel=kernel)


def phase_parallel(torch, dev):
    """Phase 26: data parallelism in an NCCL group of one, fit_sphere, the
    visualization twins, exp_gan and profiling.trace -> the numbers for the
    summary."""
    import tempfile

    import torch.distributed as dist
    from neural_raytracing_tpu_torch.parallel import make_mesh
    print(f"phase 26 on {card()}")
    start = time.perf_counter()
    parts = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        parts[name] = time.perf_counter() - t
        return out

    c2ws = train_c2ws()
    imgs, masks = sphere_gt(torch, c2ws)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        dist.init_process_group("nccl", init_method=f"file://{root / 'store'}", world_size=1,
                                rank=0)
        try:
            mesh = make_mesh()
            check(mesh.size == 1 and mesh.collective and dist.get_backend() == "nccl",
                  f"(a) not an NCCL group of one: {mesh}")
            fl = timed("a", lambda: parallel_flagship(torch, dev, mesh, c2ws, imgs, masks))
            tr = timed("e", lambda: parallel_trace(torch, dev, root, mesh, c2ws, imgs, masks))
        finally:
            dist.destroy_process_group()
        fit = timed("b", lambda: parallel_fit_sphere(torch, dev))
        vis = timed("c", lambda: parallel_vis(torch, dev, root, c2ws, imgs, masks))
    gan = timed("d", lambda: parallel_gan(torch, dev, imgs))
    secs = time.perf_counter() - start
    print(f"phase 26 on {card()}: world-one step {fl['ms']['mesh']:.1f} ms against the plain "
          f"loop's {fl['ms']['plain']:.1f} ms, the same bits {fl['same_bits']}; the step alone "
          f"{fl['step_ms']['mesh']:.2f} against {fl['step_ms']['plain']:.2f} ms; fit_sphere "
          f"{FIT_ITERS} iterations {fit['secs']:.2f} s; exp_gan {1e3 * gan['secs'] / GAN_STEPS:.1f} "
          f"ms a step; phase 26 took {secs:.1f} s ("
          + ", ".join(f"({k}) {v:.1f} s" for k, v in sorted(parts.items())) + ")")
    return dict(flagship=fl, fit=fit, vis=vis, gan=gan, trace=tr, secs=secs)


# ---- slice 19: the JAX options the port takes ---------------------------------------------

OPT_SIZE = 128                                     # (a) the flagship eval view
OPT_POINTS = 16_384                                # (a) the weight net's input gradient
OPT_STEPS = 3                                      # (c)
OPT_EYES = 1_000                                   # (d)
# (a) the preprocess: a fixed affine map of the hit points
OPT_AFFINE = ((0.9, 0.2, -0.1), (0.0, 1.1, 0.3), (0.2, -0.4, 0.8))
OPT_SHIFT = (0.05, -0.1, 0.02)


def launched(label, counts, names):
    for name in names:
        check(counts[name] > 0, f"{label}: kernel {name} was not launched")


def plain_run(fn):
    """-> (``fn()`` under plain_kernels(), its host ms; ``fn`` waits for the
    card)."""
    with plain_kernels():
        start = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - start)


def options_preprocess(torch, dev):
    """(a) the flagship with ComposeSpatialVarying(preprocess=affine)."""
    import numpy as np
    from neural_raytracing_tpu_torch.bsdf import identity
    from neural_raytracing_tpu_torch.cameras import NeRFCamera, nerf_c2w
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.kernels import route_counts
    from neural_raytracing_tpu_torch.render import pathtrace
    from neural_raytracing_tpu_torch.workloads import nerf_synthetic
    from neural_raytracing_tpu_torch.workloads._common import chunk_for
    a = torch.tensor(OPT_AFFINE, device=dev)
    b = torch.tensor(OPT_SHIFT, device=dev)
    affine = lambda p: p @ a + b                          # noqa: E731
    scene = nerf_synthetic.build_scene(max_steps=256, march_bound=1.2)
    scene.bsdf.preprocess = affine
    scene.init(torch.Generator().manual_seed(0), device=dev)
    cam = NeRFCamera(torch.from_numpy(nerf_c2w(30.0, 45.0, 2.0)[None, :3]), FOCAL)

    def view():
        with torch.no_grad():
            return pathtrace(scene, cam, Direct(training=False), size=OPT_SIZE,
                             chunk_size=chunk_for(OPT_SIZE), bundle_size=1, background=0.0,
                             key=0, device=dev)[0].cpu().numpy()

    view()                                                                   # warm-up
    got, counts, secs = counted(torch, "(a) preprocess view", view)
    launched("(a) preprocess view", counts, ("fused_march",))
    routes, ms = route_counts()["fused_mlp_forward"], 1e3 * secs
    want, plain_ms = plain_run(view)
    frac, agree, mean_d, max_d = compare_images("(a) preprocess view", got, want)
    scene.bsdf.preprocess = identity
    ident = view()
    scene.bsdf.preprocess = affine
    check(np.abs(ident - got).max() > 0, "(a) the preprocess does not change the view")
    # the weight net's input gradient through the preprocess, kernel against plain
    g = torch.Generator(device=dev).manual_seed(3)
    pts = 0.6 * torch.rand(OPT_POINTS, 3, generator=g, device=dev) - 0.3
    w = torch.randn(OPT_POINTS, 8, generator=g, device=dev)

    def grad():
        p = pts.clone().requires_grad_()
        k, _ = scene.bsdf.normalized_weights(p)
        return torch.autograd.grad(torch.sum(k * w), p)[0]

    gk, gcounts, _ = counted(torch, "(a) weight-net gradient", grad)
    gp, _ = plain_run(grad)
    g_err = (gk - gp).abs().max().item()
    g_scale = gp.abs().max().item()
    check(g_scale > 0 and g_err <= 1e-4 * g_scale,
          f"(a) weight-net input gradient: max |kernel - plain| {g_err:.3e} > 1e-4 x {g_scale:.3e}")
    print(f"  (a) flagship {OPT_SIZE}^2 eval view with preprocess = affine: {ms:.1f} ms "
          f"(plain_kernels() {plain_ms:.1f} ms), lit fraction {frac:.4f}, mask agreement "
          f"{agree:.6f}, mean |diff| {mean_d:.3e}, max |diff| {max_d:.3e}; max |diff| from the "
          f"identity's view {np.abs(ident - got).max():.3e}; launches K1 "
          f"{counts['fused_mlp_forward']} (routes {routes}), K2 {counts['fused_march']}; the "
          f"weight net's input gradient on {OPT_POINTS:,} points: max |kernel - plain| "
          f"{g_err:.3e} of max {g_scale:.3e}, K1 launches {gcounts['fused_mlp_forward']}")
    return dict(ms=ms, plain_ms=plain_ms, counts=counts, grad_counts=gcounts, grad_err=g_err,
                agree=agree, mean_diff=mean_d)


def options_conductor(torch, dev):
    """(b) the colocate scene with Conductor(activation=, threshold=)."""
    import numpy as np
    from neural_raytracing_tpu_torch.bsdf import Conductor
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.render import _tile_positions, pathtrace
    from neural_raytracing_tpu_torch.workloads import colocate
    from neural_raytracing_tpu_torch.workloads import make_dataset as md
    scene = colocate.build_scene()
    check(isinstance(scene.bsdf.bsdfs[3], Conductor), "(b) the colocate scene's lobe 3")
    scene.bsdf.bsdfs[3] = Conductor(activation="softplus", threshold=0.9)
    scene.init(torch.Generator().manual_seed(0), device=dev)
    test = colocate.eval_scene(scene)
    test.lights.set_location(md.relight_light(2, 0).to(dev))
    cam = md.camera_at(1.0, md.CAM_ELEVS[1], md.CAM_AZIMS[2])

    def view():
        with torch.no_grad():
            return pathtrace(test, cam, Direct(training=False), size=CO_SIZE,
                             chunk_size=CO_CHUNK, bundle_size=1, background=0.0, key=0,
                             device=dev)[0].cpu().numpy()

    view()                                                                   # warm-up
    got, counts, secs = counted(torch, "(b) conductor view", view)
    launched("(b) conductor view", counts, ("fused_march", "fused_shadow_march"))
    ms = 1e3 * secs
    rays = cam.to(dev).sample_positions(_tile_positions(0.0, 0.0, CO_SIZE, dev), size=CO_SIZE)
    blocked, hit = blocked_shadow_rays(torch, test, rays)
    check(blocked > 0, "(b) no shadow ray blocked")
    want, plain_ms = plain_run(view)
    frac, agree, mean_d, max_d = compare_images("(b) conductor view", got, want)
    # the defaults: the same weights and key under the explicit defaults and none
    state = scene.bsdf.bsdfs[3].state_dict()
    images = {}
    for label, lobe in (("explicit", Conductor(activation="sigmoid", threshold=0.94)),
                        ("default", Conductor())):
        lobe.load_state_dict(state)
        scene.bsdf.bsdfs[3] = lobe.to(dev)
        images[label] = view()
    same = np.array_equal(images["explicit"], images["default"])
    check(same, "(b) Conductor() and Conductor('sigmoid', 0.94) render other bits")
    moved = float(np.abs(images["default"] - got).max())
    check(moved > 0, "(b) activation and threshold do not change the view")
    print(f"  (b) colocate {CO_SIZE}^2 test view, hard shadows, Conductor(softplus, 0.9): "
          f"{ms:.1f} ms (plain_kernels() {plain_ms:.1f} ms), hit fraction "
          f"{hit.float().mean().item():.4f}, blocked shadow rays {blocked}, lit fraction "
          f"{frac:.4f}, mask agreement {agree:.6f}, mean |diff| {mean_d:.3e}, max |diff| "
          f"{max_d:.3e}; launches K1 {counts['fused_mlp_forward']}, K2 {counts['fused_march']}, "
          f"K4 {counts['fused_shadow_march']}; Conductor('sigmoid', 0.94) and Conductor() the "
          f"same bits {same}, max |diff| from (softplus, 0.9) {moved:.3e}")
    return dict(ms=ms, plain_ms=plain_ms, counts=counts, same_bits=same, agree=agree,
                mean_diff=mean_d, blocked=blocked)


def options_step_fn(torch, dev):
    """(c) train(step_fn=) against train() without it."""
    import numpy as np
    from neural_raytracing_tpu_torch.cameras import NeRFCamera
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.training import (
        TrainState, build_step_fn, make_optimizer, train,
    )
    c2ws = train_c2ws()
    imgs, masks = sphere_gt(torch, c2ws)
    spec = make_optimizer(LRS)
    make_camera = lambda idxs: NeRFCamera(torch.from_numpy(c2ws[np.asarray(idxs)]), FOCAL)

    def run(own, label):
        scene = flagship_scene(torch, dev, "spheres")
        kw, calls = {}, []
        if own:
            step = build_step_fn(scene, Direct(training=True), spec, size=SIZE,
                                 crop_size=CROP_SIZE)

            def step_fn(*args):
                calls.append(1)
                return step(*args)
            kw["step_fn"] = step_fn

        def go():
            return train(scene, Direct(training=True), spec, TrainState(scene, spec.init(scene), 0),
                         make_camera, imgs, masks, torch.Generator(device=dev).manual_seed(1),
                         size=SIZE, crop_size=CROP_SIZE, iters=OPT_STEPS, n_views=N_VIEWS,
                         log_every=0, **kw)[1]
        losses, counts, secs = counted(torch, label, go)
        launched(label, counts, ("fused_march", "fused_min_scan"))
        check(len(losses) == OPT_STEPS and np.isfinite(losses).all(), f"{label}: {losses}")
        check(not own or len(calls) == OPT_STEPS, f"{label}: the given step ran {len(calls)} times")
        return dict(losses=losses, counts=counts, ms=1e3 * secs / OPT_STEPS,
                    state={k: v.clone() for k, v in scene.state_dict().items()})

    run(False, "(c) train, warm-up")
    built, given = run(False, "(c) train"), run(True, "(c) train(step_fn=)")
    same_losses = built["losses"] == given["losses"]
    same_state = all(torch.equal(built["state"][k], v) for k, v in given["state"].items())
    check(same_losses and same_state, f"(c) train(step_fn=) differs from train(): losses "
          f"{given['losses']} against {built['losses']}, parameters the same {same_state}")
    names = ("fused_mlp_forward", "fused_march", "fused_min_scan")
    print(f"  (c) {OPT_STEPS} flagship steps ({N_VIEWS} x {CROP_SIZE}^2): train(step_fn=) "
          f"{given['ms']:.1f} ms a step, train() {built['ms']:.1f}; losses {given['losses']}, "
          f"the same loss and parameter bits {same_losses and same_state}; launches (given / "
          "built) " + ", ".join(f"{n} {given['counts'][n]} / {built['counts'][n]}" for n in names))
    return dict(ms=given["ms"], built_ms=built["ms"], counts=given["counts"], same_bits=True)


def options_eye(torch, dev):
    """(d) look_at_view_transform(eye=) on the card."""
    from neural_raytracing_tpu_torch.cameras import look_at_view_transform
    from neural_raytracing_tpu_torch.cameras.cameras import camera_position_from_spherical_angles
    g = torch.Generator(device=dev).manual_seed(5)
    dist = 0.5 + 3.0 * torch.rand(OPT_EYES, generator=g, device=dev)
    elev = 170.0 * torch.rand(OPT_EYES, generator=g, device=dev) - 85.0
    azim = 360.0 * torch.rand(OPT_EYES, generator=g, device=dev) - 180.0
    at = torch.tensor([[0.1, -0.2, 0.3]], device=dev)
    eye = camera_position_from_spherical_angles(dist, elev, azim, device=dev) + at
    r, t = look_at_view_transform(eye=eye, at=at, device=dev)
    r0, t0 = look_at_view_transform(dist=dist, elev=elev, azim=azim, at=at, device=dev)
    check(r.is_cuda and t.is_cuda and r.shape == (OPT_EYES, 3, 3), "(d) R, T not on the card")
    err = max((r - r0).abs().max().item(), (t - t0).abs().max().item())
    check(err <= 1e-6, f"(d) the eye form differs from the spherical form by {err:.3e}")
    print(f"  (d) look_at_view_transform(eye=) at {OPT_EYES:,} centres on the card: max "
          f"|difference| from the (dist, elev, azim) form {err:.3e}")
    return dict(err=err)


def phase_options(torch, dev):
    """Phase 27: the JAX options the port takes, on the card -> the numbers
    for the summary."""
    print(f"phase 27 on {card()}")
    start = time.perf_counter()
    out = dict(preprocess=options_preprocess(torch, dev), conductor=options_conductor(torch, dev),
               step_fn=options_step_fn(torch, dev), eye=options_eye(torch, dev))
    out["secs"] = time.perf_counter() - start
    print(f"phase 27 on {card()}: preprocess view {out['preprocess']['ms']:.1f} ms, conductor "
          f"view {out['conductor']['ms']:.1f} ms, train(step_fn=) "
          f"{out['step_fn']['ms']:.1f} ms a step; phase 27 took {out['secs']:.1f} s")
    return out


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
    if sys.argv[1:2] == ["--path"]:
        phase_path(torch, dev)
        return
    if sys.argv[1:2] == ["--edit"]:
        phase_edit(torch, dev)
        return
    if sys.argv[1:2] == ["--hash"]:
        phase_hash(torch, dev)
        return
    if sys.argv[1:2] == ["--mesh"]:
        phase_mesh(torch, dev)
        return
    if sys.argv[1:2] == ["--parallel"]:
        phase_parallel(torch, dev)
        return
    if sys.argv[1:2] == ["--options"]:
        phase_options(torch, dev)
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
    pt = phase_path(torch, dev, (nv["data"], nv["test"], nv["state"]))
    ed = phase_edit(torch, dev)
    hs = phase_hash(torch, dev)
    mh = phase_mesh(torch, dev)
    pl = phase_parallel(torch, dev)
    op = phase_options(torch, dev)

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
                    "path_parent_ms", "kernel_ms", "path_kernel_ms", "same_bits",
                    "bounce_launch_ms", "bounce_launch_bound_ms", "bsdf_arm_launch_ms",
                    "bsdf_arm_launch_bound_ms"):
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
    # K2 and K4 (phase 22): a Path tile's bounce launch, Direct's BSDF-arm shadow launch
    k2["bounded"]["bounce_launch_ms"] = pt["bounce"]["bounce"]["ms"]
    k2["bounded"]["bounce_launch_bound_ms"] = pt["bounce"]["bounce"]["bound_ms"]
    bsdf_arm = pt["k4_constant"]["BSDF arm (max_t Constant.intersect)"]
    k4["bsdf_arm_launch_ms"], k4["bsdf_arm_launch_bound_ms"] = bsdf_arm[:2]
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
    fl = ed["flagship"]
    print(f"editing (phase 23): flagship test view --edit none {fl['times']['none']:.1f} "
          f"ms/view (busy {fl['busy']['none']['busy_ms']:.1f}), --edit bend "
          f"{fl['times']['bend']:.1f} ms/view (busy {fl['busy']['bend']['busy_ms']:.1f}), K1 "
          f"{fl['edits']['bend']['k1']} and K2 {fl['edits']['bend']['k2']} launches a bent "
          f"view; multi-light NeRV test view {ed['nerv']['ms']:.1f} ms/view; prime loss "
          f"{ed['prime']['loss'][0]:.5f} -> {ed['prime']['loss'][1]:.5f}; phase 23 took "
          f"{ed['secs']:.1f} s")
    ht = hs["turns"]
    print(f"hash surface and NeRF family (phase 24): hash test view {ht['view_ms']['hash']:.1f} "
          f"ms against the spheres' {ht['view_ms']['spheres']:.1f}, hash training step "
          f"{ht['step_ms']['hash']:.1f} ms against {ht['step_ms']['spheres']:.1f}, "
          f"{ht['march_step']['hash']} launch calls a plain hash march step; NeuralApprox view "
          f"{hs['views']['NeuralApprox']['ms']:.1f} ms; phase 24 took {hs['secs']:.1f} s")
    print(f"meshes (phase 25): TriangleMesh on the card gear {mh['intersect']['gear']['ms']['card']:.2f} "
          f"ms, knot {mh['intersect']['knot']['ms']['card']:.2f} ms an intersect and shadow test "
          f"of a 200^2 view; raster 256^2 naive {mh['raster']['naive']:.2f} ms, binned "
          f"{mh['raster']['binned']:.2f}; mirror GT {mh['gt']['pass_ms']:.1f} ms a Path pass; "
          f"path_demo delta {mh['demo']['delta']:+.3f} dB; seed fit {mh['seed_ms']:.2f} ms an "
          f"iteration; phase 25 took {mh['secs']:.1f} s")
    print(f"data parallelism and the last twins (phase 26): world-one step "
          f"{pl['flagship']['ms']['mesh']:.1f} ms against the plain loop's "
          f"{pl['flagship']['ms']['plain']:.1f} ms, the same bits; the step alone "
          f"{pl['flagship']['step_ms']['mesh']:.2f} against "
          f"{pl['flagship']['step_ms']['plain']:.2f} ms; fit_sphere {FIT_ITERS} "
          f"iterations {pl['fit']['secs']:.2f} s; exp_gan "
          f"{1e3 * pl['gan']['secs'] / GAN_STEPS:.1f} ms a step; phase 26 took "
          f"{pl['secs']:.1f} s")
    print(f"the JAX options (phase 27): preprocess view {op['preprocess']['ms']:.1f} ms "
          f"(K1 {op['preprocess']['counts']['fused_mlp_forward']}, K2 "
          f"{op['preprocess']['counts']['fused_march']}), Conductor(softplus, 0.9) view "
          f"{op['conductor']['ms']:.1f} ms (K4 {op['conductor']['counts']['fused_shadow_march']}), "
          f"the defaults the same bits {op['conductor']['same_bits']}; train(step_fn=) "
          f"{op['step_fn']['ms']:.1f} ms a step (K3 {op['step_fn']['counts']['fused_min_scan']}); "
          f"phase 27 took {op['secs']:.1f} s")
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
          f"{nv['turns']['device']['ms']:.1f} ms/step; NeRV Path view (depth 2) "
          f"{pt['times']['path']:.1f} ms/view (Direct {pt['times']['direct']:.1f}), Path "
          f"training step {pt['training']['path']['ms']:.1f} ms/step (Direct "
          f"{pt['training']['direct']['ms']:.1f}), peak memory "
          f"{pt['training']['path']['peak_gib']:.3f} GiB (Direct "
          f"{pt['training']['direct']['peak_gib']:.3f})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
