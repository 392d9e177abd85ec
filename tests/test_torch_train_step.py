"""Port parity: the training step as a whole, and its CUDA graph.

The reduced flagship of ``test_torch_params`` (n = 8 spheres, nets 16 wide)
with ``throughput_steps`` 16 and ``max_steps`` 16, JAX params carried across,
2 views of a 16x16 image cropped to 12x12 (SSIM's 11-pixel window needs at
least 11) over the analytic sphere of ``test_torch_training``, in both
throughput modes.  The JAX step draws its throughput jitter from the step
key, so the JAX SDF's ``throughput`` is replaced (an instance attribute) by
one that passes ``key=None``; the port runs without a generator.  The JAX
side is its jitted ``make_train_step`` (loss, updated params) and the same
loss under ``jax.value_and_grad`` (gradients).
Tolerances: the loss rtol 1e-5; each gradient leaf within 1e-4 of its
max|JAX gradient| (float32 sums in another order, through the march, the
min-scan and the eikonal double backward); the Adam update within 1e-3 of the
learning rate where the JAX gradient is above 1e-3 of the leaf's max (Adam's
first step is ~lr * sign(g), so a gradient near 0 may flip its sign), and
never above the learning rate.

The step's CUDA graph (``training.step_graph``): on the CPU, off the card,
under a mesh and with the NaN check the step never captures, and the graph's
key and static inputs follow the inputs, the state and the scene's settings
(its routes, modes, march steps and precisions).  The tests marked
``cuda`` hold the graphed step against its own eager step
(``step._eager``) on the flagship scene at its published widths, 2 views of
16x16 crops of a 64x64 view, on the card.  This file imports JAX only inside
the JAX comparison, so they run on a card without JAX:

    python -m pytest --noconftest tests/test_torch_train_step.py -q -m cuda
"""

import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import neural_raytracing_tpu_torch.kernels as kernels
import neural_raytracing_tpu_torch.training as T
from neural_raytracing_tpu_torch import profiling
from neural_raytracing_tpu_torch.cameras import NeRFCamera, nerf_c2w
from neural_raytracing_tpu_torch.integrators import Direct
from neural_raytracing_tpu_torch.kernels import FusedSkipConnMLP, set_kernel_mode
from neural_raytracing_tpu_torch.render import _tile_positions
from neural_raytracing_tpu_torch.training import step_graph
from neural_raytracing_tpu_torch.training.step_graph import GraphedStep

torch.set_num_threads(1)
CROP, UV = 12, (0, 2)


def _jax_loss_and_grads(jscene, tree, exp, mask):
    """The JAX step's loss_fn (training/loop.py:83-111) without a key."""
    import jax
    import jax.numpy as jnp
    import neural_raytracing_tpu.training as JT
    from neural_raytracing_tpu.cameras import NeRFCamera as JNeRF
    from neural_raytracing_tpu.integrators import Direct as JDirect
    from neural_raytracing_tpu.integrators import NeRFIntegrator
    from neural_raytracing_tpu.ops.losses import masked_loss
    from neural_raytracing_tpu.render import _tile_positions
    from test_torch_training import C2W, FOCAL, SIZE
    camera = JNeRF(cam_to_world=jnp.asarray(C2W), focal=FOCAL)

    def loss_fn(params):
        rays = camera.sample_positions(_tile_positions(*map(float, UV), CROP),
                                       size=SIZE)
        values, _, it = NeRFIntegrator(JDirect(training=True)).sample(
            jscene, params, rays, training=True)
        got = jnp.mean(values, axis=-2)
        loss = masked_loss(got[..., :3], exp, jnp.mean(it.throughput, -1), mask,
                           mask_weight=15.0)
        return loss + JT.default_extra_loss(it, got, exp, mask)

    return jax.jit(jax.value_and_grad(loss_fn))(tree)


def _step_case(mode):
    from neural_raytracing_tpu.shapes import SDF as JSDF
    from test_torch_params import scene_pair
    from test_torch_training import _gt
    jscene, tree, scene = scene_pair(max_steps=16)
    for s in (jscene.shape, scene.shape):
        s.throughput_steps = 16
        s.throughput_mode = mode
    js = jscene.shape
    js.throughput = lambda params, r_o, r_d, key=None: JSDF.throughput(
        js, params, r_o, r_d, key=None)
    img, mask = _gt()
    exp = img[:, UV[0]:UV[0] + CROP, UV[1]:UV[1] + CROP]
    msk = mask[:, UV[0]:UV[0] + CROP, UV[1]:UV[1] + CROP]
    return jscene, tree, scene, exp, msk


@pytest.mark.parametrize("mode", ["full", "half_res"])
def test_training_step_matches_jax(mode):
    import jax
    import jax.numpy as jnp
    import neural_raytracing_tpu.training as JT
    from neural_raytracing_tpu.cameras import NeRFCamera as JNeRF
    from neural_raytracing_tpu.integrators import Direct as JDirect
    from test_torch_training import C2W, FOCAL, LRS, SIZE, _flat
    jscene, tree, scene, exp, msk = _step_case(mode)
    assert 0 < msk.mean() < 1
    jopt = JT.make_optimizer(LRS)
    jstep = JT.make_train_step(jscene, JDirect(training=True), jopt, donate=False,
                               size=SIZE, crop_size=CROP)
    jstate = JT.TrainState(tree, jopt.init(tree), jnp.int32(0))
    camera = JNeRF(cam_to_world=jnp.asarray(C2W), focal=FOCAL)
    jnew, jaux = jstep(jstate, camera, tuple(map(jnp.float32, UV)), jnp.asarray(exp),
                       jnp.asarray(msk), jax.random.PRNGKey(0))
    jloss, jgrads = _jax_loss_and_grads(jscene, tree, jnp.asarray(exp), jnp.asarray(msk))
    np.testing.assert_allclose(float(jloss), float(jaux["loss"]), rtol=1e-6)

    spec = T.make_optimizer(LRS)
    state = T.TrainState(scene, spec.init(scene), 0)
    step = T.build_step_fn(scene, Direct(training=True), spec, size=SIZE, crop_size=CROP)
    old = {k: p.detach().clone() for k, p in scene.named_parameters()}
    state, aux = step(state, NeRFCamera(torch.from_numpy(C2W), FOCAL), UV,
                      torch.from_numpy(exp), torch.from_numpy(msk))
    assert state.step == 1
    with torch.no_grad():
        rays = NeRFCamera(torch.from_numpy(C2W), FOCAL).sample_positions(
            _tile_positions(*map(float, UV), CROP, "cpu"), size=SIZE)
        assert scene.shape.intersect(rays, primary=False)[1].float().mean() > 0
    np.testing.assert_allclose(aux["loss"].item(), float(jloss), rtol=1e-5)
    # the silhouette and the shading both reach the loss
    alpha = aux["got"][..., 3]
    assert (alpha > 0.5).any() and (alpha < 0.5).any()

    want_g, want_p = _flat(jgrads), _flat(jnew.params)
    lrs = {k: LRS[k.split(".")[0]] for k in want_g}
    for k, p in scene.named_parameters():
        g, wg = p.grad.numpy(), want_g[k]
        scale = np.abs(wg).max()
        np.testing.assert_allclose(g, wg, rtol=0, atol=1e-4 * scale + 1e-12, err_msg=k)
        upd, wupd = (p.detach() - old[k]).numpy(), want_p[k] - old[k].numpy()
        sure = np.abs(wg) > 1e-3 * scale
        np.testing.assert_allclose(upd[sure], wupd[sure], rtol=0, atol=1e-3 * lrs[k],
                                   err_msg=k)
        assert np.all(np.abs(upd) <= 1.01 * lrs[k])


# ---- the step's CUDA graph: what the CPU can check ---------------------------

def _tiny_case(**step_kw):
    """A 4-sphere scene with a plain 8-wide shift net, its AdamW, a step and
    2 views of 12x12 crops of a 16x16 view, on the CPU."""
    from test_torch_tracing import C2W as C2W_T, FOCAL as FOCAL_T, SIZE as SIZE_T, small_scene
    scene = small_scene(occlusion="none")
    spec = T.make_optimizer({"shape": 1e-3, "bsdf": 1e-3, "lights": 1e-3})
    state = T.TrainState(scene, spec.init(scene), 0)
    step = T.build_step_fn(scene, Direct(training=True), spec, size=SIZE_T, crop_size=CROP,
                           **step_kw)
    camera = NeRFCamera(torch.from_numpy(C2W_T), FOCAL_T)
    exp = torch.rand(2, CROP, CROP, 3, generator=torch.Generator().manual_seed(4))
    return state, step, camera, exp, torch.ones(2, CROP, CROP)


class _NoGraph:
    def __init__(self, *args, **kwargs):
        raise AssertionError("the step tried to capture a CUDA graph")


def _graph_counts(counts: dict) -> tuple:
    """(captures, replays, fallbacks) from the ``step.graph_*`` counters."""
    return tuple(counts.get(f"step.graph_{k}", 0) for k in ("captures", "replays", "fallbacks"))


@pytest.mark.parametrize("case", ["cpu", "mesh", "skip_nan_updates"])
def test_step_never_captures_off_the_card(monkeypatch, case):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _NoGraph)
    if case == "mesh":
        # a mesh step is built eagerly; running it needs its process group
        step = _tiny_case(mesh=object(), n_real_views=2)[1]
        assert not isinstance(step, GraphedStep)
        return
    state, step, camera, exp, mask = _tiny_case(skip_nan_updates=case == "skip_nan_updates")
    assert isinstance(step, GraphedStep) == (case == "cpu")
    assert not any(g["capturable"] for g in state.optimizer.param_groups)   # on the CPU
    gen = torch.Generator().manual_seed(1)
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.reset_counters()
        for _ in range(3):
            state, aux = step(state, camera, (1, 2), exp, mask, gen)
        counts = profiling.counters()
    profiling.reset_counters()
    assert state.step == 3 and torch.isfinite(aux["loss"])
    assert not any(k.startswith("step.graph") for k in counts)
    if case == "cpu":
        assert not GraphedStep.engages(state, camera, gen)
        assert not step._graphs and not step._seen


def test_graph_key_follows_inputs_and_state():
    state, step, camera, exp, mask = _tiny_case()
    gen = torch.Generator().manual_seed(1)
    state, _ = step._eager(state, camera, (1, 2), exp, mask, gen)    # AdamW's state
    key = lambda *a: step.key(state, *a)
    first = key(camera, exp, mask, gen)
    assert first is not None and first == key(camera, exp, mask, gen)
    # new values in the same tensors, or another crop corner: the same graph
    with torch.no_grad():
        for p in state.scene.parameters():
            p.add_(1.0)
    other = NeRFCamera(camera.cam_to_world + 1.0, camera.focal)
    assert key(other, exp + 1.0, mask, gen) == first
    # the half batch, another focal length, a rebound parameter, another
    # learning rate or generator: another graph
    half = NeRFCamera(camera.cam_to_world[:1], camera.focal)
    assert key(half, exp[:1], mask[:1], gen) != first
    assert key(NeRFCamera(camera.cam_to_world, 2.0 * camera.focal), exp, mask, gen) != first
    assert key(camera, exp, mask, torch.Generator().manual_seed(1)) != first
    param = next(state.scene.lights.parameters())
    param.data = param.data.clone()
    rebound = key(camera, exp, mask, gen)
    assert rebound != first
    state.optimizer.param_groups[0]["lr"] *= 2
    assert key(camera, exp, mask, gen) not in (first, rebound)
    # a camera field neither a tensor nor hashable keeps the step eager
    assert key(NeRFCamera(camera.cam_to_world, [camera.focal]), exp, mask, gen) is None


# what a caller may change on a live scene that changes the work its step does
SETTINGS = {
    "max_steps": lambda sc: setattr(sc.shape, "max_steps", sc.shape.max_steps + 1),
    "throughput_mode": lambda sc: setattr(sc.shape, "throughput_mode", "half_res"),
    "march_dtype": lambda sc: setattr(sc.shape, "march_dtype", torch.bfloat16),
    "kernel_mode": lambda sc: set_kernel_mode(sc, "off"),
    # the surface module an SDF keeps unregistered
    "surface": lambda sc: setattr(sc.shape.module, "k", 2.0 * sc.shape.module.k),
    "eval": lambda sc: sc.eval(),
}


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_graph_key_follows_the_scene_settings(setting):
    state, step, camera, exp, mask = _tiny_case()
    gen = torch.Generator().manual_seed(1)
    first = step.key(state, camera, exp, mask, gen)
    SETTINGS[setting](state.scene)
    assert step.key(state, camera, exp, mask, gen) not in (None, first)


@pytest.mark.parametrize("attr, value", [("kernel_bwd", True), ("kernel_bwd_segments", 0),
                                         ("compute_dtype", torch.bfloat16)])
def test_settings_hold_a_nets_backward_route_and_precision(attr, value):
    net = FusedSkipConnMLP(in_size=3, out=2, num_layers=3, hidden_size=16, freqs=4)
    before = step_graph.settings(net)
    setattr(net, attr, value)
    after = step_graph.settings(net)
    assert (attr, value) in after and after != before


def test_launches_apart_are_given_back_by_add_launches():
    fwd = kernels.fused_mlp_forward
    kernels.reset_launch_counts()
    fwd.launches, fwd.route_launches["tile"] = 2, 2
    with kernels.launches_apart() as taken:
        fwd.launches += 3
        fwd.route_launches["tile"] += 3
        kernels.pack_tile_weights.launches += 1
    assert taken == {"fused_mlp_forward": 3, ("fused_mlp_forward", "tile"): 3,
                     "pack_tile_weights": 1}
    assert kernels.launch_counts()["fused_mlp_forward"] == 2
    assert kernels.launch_counts()["pack_tile_weights"] == 0
    for _ in range(2):
        kernels.add_launches(taken)
    assert kernels.launch_counts()["fused_mlp_forward"] == 8
    assert kernels.launch_counts()["pack_tile_weights"] == 2
    assert kernels.route_counts()["fused_mlp_forward"] == {"tile": 8, "general": 0}
    kernels.reset_launch_counts()


def test_static_inputs_take_each_call():
    _, _, camera, exp, mask = _tiny_case()
    static = step_graph.static_inputs("cpu", camera, exp, mask)
    cam, uv, sexp, smask = static
    assert cam.focal == camera.focal and cam.cam_to_world is not camera.cam_to_world
    for u, v in [(1, 2), (torch.tensor(3), torch.tensor(4.0))]:
        new_exp = torch.rand_like(exp)
        step_graph.fill_inputs(static, NeRFCamera(camera.cam_to_world * 2, camera.focal),
                               (u, v), new_exp, mask * 0.5)
        assert torch.equal(cam.cam_to_world, camera.cam_to_world * 2)
        assert (uv[0].item(), uv[1].item()) == (float(u), float(v))
        assert uv[0].dtype == torch.float32 and uv[0].dim() == 0
        assert torch.equal(sexp, new_exp) and torch.equal(smask, mask * 0.5)
    # the crop's positions from the 0-d corner are those from the numbers
    assert torch.equal(_tile_positions(uv[0], uv[1], CROP, "cpu"),
                       _tile_positions(3, 4, CROP, "cpu"))


# ---- the step's CUDA graph on the card ----------------------------------------

G_SIZE, G_CROP, G_VIEWS = 64, 16, 2
G_LRS = {"shape": 8e-5, "bsdf": 8e-4, "lights": 8e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _flagship(device, extra_loss=T.default_extra_loss, clip_norm=None):
    """The flagship scene at its published widths from seed 0, its AdamW
    (capturable on the card) and a step of 16x16 crops."""
    from neural_raytracing_tpu_torch.workloads.nerf_synthetic import build_scene
    scene = build_scene(max_steps=32).init(torch.Generator().manual_seed(0), device=device)
    spec = T.make_optimizer(G_LRS, clip_norm=clip_norm)
    state = T.TrainState(scene, spec.init(scene), 0)
    assert all(g["capturable"] for g in state.optimizer.param_groups)
    step = T.build_step_fn(scene, Direct(training=True), spec, size=G_SIZE,
                           crop_size=G_CROP, extra_loss=extra_loss)
    return state, step


def _batches(device, n, views=G_VIEWS, seed=0):
    """``n`` steps' inputs: host cameras (2 views), crop corners as numbers,
    ground truth on the card."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        c2w = np.stack([nerf_c2w(rng.uniform(10, 50), rng.uniform(0, 360), 2.0)
                        for _ in range(views)])[:, :3].astype(np.float32)
        focal = 0.5 * G_SIZE / np.tan(0.5 * 0.6911)
        u, v = (int(x) for x in rng.integers(0, G_SIZE - G_CROP + 1, 2))
        exp = torch.from_numpy(rng.uniform(size=(views, G_CROP, G_CROP, 3)).astype(np.float32))
        mask = torch.from_numpy((rng.uniform(size=(views, G_CROP, G_CROP)) > 0.3)
                                .astype(np.float32))
        out.append((NeRFCamera(torch.from_numpy(c2w), focal), (u, v), exp.to(device),
                    mask.to(device)))
    return out


def _run(step, state, batches, generator):
    """The steps over ``batches`` under a profiler session -> (state, the
    losses, the counts they made)."""
    losses = []
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        for camera, uv, exp, mask in batches:
            state, aux = step(state, camera, uv, exp, mask, generator)
            losses.append(aux["loss"])
        torch.cuda.synchronize()
        counts = profiling.counters()
    profiling.reset_counters()
    return state, losses, counts


def _leaves(state) -> dict:
    """Every parameter and both AdamW moments of each."""
    out = {}
    for k, p in state.scene.named_parameters():
        out[k] = p.detach()
        for m in ("exp_avg", "exp_avg_sq"):
            out[f"{k}:{m}"] = state.optimizer.state[p][m]
    return out


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), (k, (got[k] - want[k]).abs().max().item())


def _assert_same_losses(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g.item(), w.item())


def _generator(seed=7):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.cuda
def test_graphed_step_matches_eager(cuda):
    batches = _batches(cuda, 5)
    state, step = _flagship(cuda, clip_norm=10.0)
    twin, twin_step = _flagship(cuda, clip_norm=10.0)
    gen, twin_gen = _generator(), _generator()
    state, losses, counts = _run(step, state, batches, gen)
    twin, want, _ = _run(twin_step._eager, twin, batches, twin_gen)
    # step 1 eager, step 2 its warm-up and capture, steps 3-5 replays
    assert _graph_counts(counts) == (1, 3, 0)
    assert state.step == twin.step == 5
    _assert_same_losses(losses, want)
    _assert_same(_leaves(state), _leaves(twin))
    assert torch.equal(gen.get_state(), twin_gen.get_state())
    # the replays' losses are three tensors of their own, not the graph's output
    entry = next(iter(step._graphs.values()))
    ptrs = {t.data_ptr() for t in losses[2:]} | {entry.aux["loss"].data_ptr()}
    assert len(ptrs) == 4
    assert len({float(t) for t in losses[2:]}) == 3


@pytest.mark.cuda
def test_new_shapes_and_rebound_parameters_capture_anew(cuda):
    state, step = _flagship(cuda)
    twin, twin_step = _flagship(cuda)
    gen, twin_gen = _generator(), _generator()
    full, half = _batches(cuda, 3), _batches(cuda, 3, views=1, seed=1)
    twin_run = lambda s, b: _run(twin_step._eager, s, b, twin_gen)[:2]
    state, _, counts = _run(step, state, full, gen)
    twin, _ = twin_run(twin, full)
    assert _graph_counts(counts) == (1, 1, 0)
    state, losses, counts = _run(step, state, half, gen)        # the half batch
    twin, want = twin_run(twin, half)
    assert _graph_counts(counts) == (1, 1, 0)
    for p in (next(state.scene.lights.parameters()), next(twin.scene.lights.parameters())):
        p.data = p.data.clone()                                  # a rebound parameter
    state, more, counts = _run(step, state, full, gen)
    twin, more_want = twin_run(twin, full)
    assert _graph_counts(counts) == (1, 1, 0)
    assert len(step._graphs) == step_graph.MAX_GRAPHS
    _assert_same_losses(losses + more, want + more_want)
    _assert_same(_leaves(state), _leaves(twin))


def _shading_nets(scene):
    from neural_raytracing_tpu_torch.kernels import FusedSkipConnMLP as Fused
    return [m for part in (scene.bsdf, scene.lights) for m in part.modules()
            if isinstance(m, Fused)]


@pytest.mark.cuda
def test_a_changed_backward_route_captures_anew(cuda):
    """K6's backward switched on between calls of one live step: the step
    captures the new route and computes what the eager step computes with
    it, and the route's launches are counted at each replay."""
    state, step = _flagship(cuda)
    twin, twin_step = _flagship(cuda)
    gen, twin_gen = _generator(), _generator()
    first, then = _batches(cuda, 3), _batches(cuda, 3, seed=2)
    state, _, _ = _run(step, state, first, gen)
    twin, _, _ = _run(twin_step._eager, twin, first, twin_gen)
    for m in _shading_nets(state.scene) + _shading_nets(twin.scene):
        m.kernel_bwd, m.kernel_bwd_segments = True, 0
    kernels.reset_launch_counts()
    state, losses, counts = _run(step, state, then, gen)
    graphed = kernels.launch_counts()["fused_mlp_backward"]
    kernels.reset_launch_counts()
    twin, want, _ = _run(twin_step._eager, twin, then, twin_gen)
    assert _graph_counts(counts) == (1, 1, 0)
    assert graphed == kernels.launch_counts()["fused_mlp_backward"] > 0
    _assert_same_losses(losses, want)
    _assert_same(_leaves(state), _leaves(twin))
    kernels.reset_launch_counts()


@pytest.mark.cuda
def test_a_resume_file_from_the_cpu_resumes_graphed(cuda, tmp_path):
    """A resume file whose AdamW was not capturable (written on the CPU)
    loads into the card's AdamW, which stays capturable: the step still
    captures and replays."""
    state, step = _flagship(cuda)
    state, _, _ = _run(step._eager, state, _batches(cuda, 1), _generator())
    for group in state.optimizer.param_groups:
        group["capturable"] = False
    T.save_train_state(str(tmp_path / "state.pt"), state.scene, state.optimizer, 1)
    resumed, resumed_step = _flagship(cuda)
    assert T.load_train_state(str(tmp_path / "state.pt"), resumed.scene,
                              resumed.optimizer) == 1
    assert all(g["capturable"] for g in resumed.optimizer.param_groups)
    _, losses, counts = _run(resumed_step, resumed, _batches(cuda, 3, seed=4), _generator())
    assert _graph_counts(counts) == (1, 1, 0) and all(torch.isfinite(x) for x in losses)


@pytest.mark.cuda
def test_a_step_that_waits_for_the_card_runs_eagerly(cuda):
    def waits(it, got, exp, mask):
        return T.default_extra_loss(it, got, exp, mask) + 0.0 * float(got.mean().item())

    batches = _batches(cuda, 4)
    state, step = _flagship(cuda, extra_loss=waits)
    twin, twin_step = _flagship(cuda, extra_loss=waits)
    gen, twin_gen = _generator(), _generator()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, losses, counts = _run(step, state, batches, gen)
    assert sum("CUDA graph" in str(w.message) for w in caught) == 1
    assert _graph_counts(counts) == (0, 0, 1)
    twin, want, _ = _run(twin_step._eager, twin, batches, twin_gen)
    _assert_same_losses(losses, want)
    _assert_same(_leaves(state), _leaves(twin))
    assert torch.equal(gen.get_state(), twin_gen.get_state())
    # the broken capture left the device's default generator working too
    torch.rand(4, device=cuda)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_replays_give_back_the_steps_counts(cuda):
    batches = _batches(cuda, 5)
    state, step = _flagship(cuda)
    twin, twin_step = _flagship(cuda)

    def launched(fn):
        kernels.reset_launch_counts()
        out = fn()
        counts = (kernels.launch_counts(), kernels.route_counts())
        kernels.reset_launch_counts()
        return out, counts

    (twin, _, eager), (eager_launches, eager_routes) = launched(
        lambda: _run(twin_step._eager, twin, batches[:1], _generator()))
    gen = _generator()
    state, _, _ = _run(step, state, batches[:2], gen)                 # eager, then capture
    (state, _, replayed), (launches, routes) = launched(
        lambda: _run(step, state, batches[2:], gen))
    n = len(batches) - 2
    assert _graph_counts(replayed) == (0, n, 0)
    for name in ("k1.flops", "k1.bytes", "k1.calls", "scan.samples", "march.rays"):
        assert eager[name] > 0 and replayed[name] == n * eager[name], name
    # the kernels' own launch counts: each replay launches what an eager step does
    assert eager_launches["fused_min_scan"] > 0 and eager_launches["pack_tile_weights"] > 0
    assert launches == {k: n * c for k, c in eager_launches.items()}
    assert routes == {k: {r: n * c for r, c in rc.items()} for k, rc in eager_routes.items()}


@pytest.mark.cuda
def test_train_loop_over_the_graph_matches_eager(cuda):
    """``train`` with the graphed step: its draw and its loss read wait for
    nothing, and the losses and the state are the eager loop's."""
    rng = np.random.default_rng(3)
    views = 4
    c2ws = np.stack([nerf_c2w(rng.uniform(10, 50), rng.uniform(0, 360), 2.0)
                     for _ in range(views)])[:, :3].astype(np.float32)
    focal = 0.5 * G_SIZE / np.tan(0.5 * 0.6911)
    imgs = rng.uniform(size=(views, G_SIZE, G_SIZE, 3)).astype(np.float32)
    masks = (rng.uniform(size=(views, G_SIZE, G_SIZE)) > 0.3).astype(np.float32)
    make_camera = lambda idxs: NeRFCamera(torch.from_numpy(c2ws[np.asarray(idxs)]), focal)
    runs = []
    for graphed in (True, False):
        state, step = _flagship(cuda)
        profiling.reset_counters()
        with profile(activities=[ProfilerActivity.CPU]):
            state, losses = T.train(
                state.scene, Direct(training=True), T.make_optimizer(G_LRS), state,
                make_camera, imgs, masks, _generator(), size=G_SIZE, crop_size=G_CROP,
                iters=5, n_views=G_VIEWS, log_every=0, seed=5,
                step_fn=step if graphed else step._eager)
            torch.cuda.synchronize()
            counts = profiling.counters()
        profiling.reset_counters()
        runs.append((losses, _leaves(state)))
        assert _graph_counts(counts) == ((1, 3, 0) if graphed else (0, 0, 0))
    assert runs[0][0] == runs[1][0] and len(runs[0][0]) == 5
    _assert_same(runs[0][1], runs[1][1])
