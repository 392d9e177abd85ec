"""Port parity: data parallelism over ``torch.distributed``.

``parallel.pad_batch`` / ``padded_size`` / ``shard_batch`` against the JAX
package's on the same numpy arrays.  The data-parallel step
(``make_parallel_train_step``) computes the unsharded loss of the first
``n_views`` views, so at every world size it must equal the single-process
step: at a world of one (no process group) bit for bit; in gloo worlds of
2 (6 views, divisible, with a generator) and 4 (6 views, padded to 8,
keyless as below), spawned side by side and joined by
``initialize_multihost`` at a ``file://`` rendezvous in ``tmp_path``, within
``tests/test_parallel.py``'s tolerances (the loss rtol 1e-5, the parameters
atol 1e-5 and rtol 1e-4).  Under a shard the per-ray draws are the rank's
rows of the whole batch's (``pathtrace_sample(shard=)``, exactly).
The world-4 step also equals JAX's ``make_parallel_train_step`` on
``make_mesh(8)`` (the suite's 8 CPU devices) from carried params, at
``tests/test_parallel.py``'s tiny scene; the JAX step draws its silhouette
jitter from its key, so there the JAX SDF's ``throughput`` is keyless and
the port runs without a generator (``test_torch_train_step``'s way).
``sharded_render_rays`` at a world of 2 equals the unsharded render (atol
1e-5), and ``train(mesh=)`` for 3 iterations at a world of 2 equals
``train(mesh=None)``.

The spawned children import torch and the port only (JAX is imported
inside the tests that use it): the JAX side is computed here and handed
over as numpy.  Each spawn has a timeout, so a hung collective fails.
"""

import functools
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import neural_raytracing_tpu_torch as T
from neural_raytracing_tpu_torch import parallel as P
from neural_raytracing_tpu_torch.bsdf import Diffuse
from neural_raytracing_tpu_torch.cameras import FoVPerspectiveCamera, look_at_view_transform
from neural_raytracing_tpu_torch.integrators import Direct
from neural_raytracing_tpu_torch.lights import PointLights
from neural_raytracing_tpu_torch.nn import SkipConnMLP
from neural_raytracing_tpu_torch.shapes import SDF, SphereSDF
from neural_raytracing_tpu_torch.training import (
    TrainState, build_step_fn, make_optimizer, make_train_step, train,
)

torch.set_num_threads(1)
LRS = {"shape": 1e-3, "bsdf": 1e-3, "lights": 1e-3}
N_VIEWS, SIZE, CROP, UV = 6, 32, 16, (8, 8)
SPAWN_TIMEOUT = 120.0


def tiny_scene(state=None):
    """``tests/test_parallel.py``'s tiny scene in the port (seed-0 weights,
    or ``state``)."""
    sdf = SDF(SphereSDF(n=8, mlp=SkipConnMLP(
        in_size=3, out=1, num_layers=2, hidden_size=16, freqs=4,
        activation="softplus", init="zeros")), max_steps=8, throughput_steps=8)
    scene = T.Scene(shape=sdf, bsdf=Diffuse(),
                    lights=PointLights(location=(0.0, 1.0, 4.0), scale=50.0))
    scene.init(torch.Generator().manual_seed(0), device="cpu")
    if state is not None:
        scene.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return scene


def cameras(n):
    r, t = look_at_view_transform(dist=2.0, elev=np.linspace(0, 30, n),
                                  azim=np.linspace(-45, 45, n))
    return FoVPerspectiveCamera(R=r, T=t)


def batch(n):
    """A crop's ground truth that the tiny sphere set only partly covers."""
    rng = np.random.default_rng(3)
    exp = torch.from_numpy(rng.uniform(0.0, 0.5, (n, CROP, CROP, 3)).astype(np.float32))
    mask = torch.from_numpy((rng.uniform(size=(n, CROP, CROP)) > 0.3).astype(np.float32))
    return cameras(n), exp, mask


def one_step(state_np, mesh, seed, clip_norm=None):
    """One step of the tiny scene from ``state_np`` (``mesh`` None: the
    single-process step) -> (loss, the state after it)."""
    scene = tiny_scene(state_np)
    spec = make_optimizer(LRS, clip_norm=clip_norm)
    kw = dict(size=SIZE, crop_size=CROP)
    step = (build_step_fn(scene, Direct(training=True), spec, **kw) if mesh is None
            else P.make_parallel_train_step(scene, Direct(training=True), spec, mesh,
                                            n_views=N_VIEWS, **kw))
    camera, exp, mask = batch(N_VIEWS)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    state, aux = step(TrainState(scene, spec.init(scene), 0), camera, UV, exp, mask, gen)
    return aux["loss"].item(), {k: v.numpy().copy() for k, v in scene.state_dict().items()}


def render_rays():
    """19 rays (not a multiple of the world), as tests/test_parallel.py's."""
    xs = torch.linspace(-0.3, 0.3, 19)
    r_o = torch.stack([xs, torch.zeros_like(xs), torch.full_like(xs, 2.0)], -1)
    return torch.cat([r_o, torch.tensor([0.0, 0.0, -1.0]).expand(19, 3)], -1)


def train_loop(state_np, mesh):
    scene = tiny_scene(state_np)
    spec = make_optimizer({"shape": 1e-3, "bsdf": 1e-3, "lights": 0.0})
    cams = cameras(N_VIEWS)

    def make_camera(idxs):
        idxs = torch.as_tensor(np.asarray(idxs))
        return FoVPerspectiveCamera(R=cams.R[idxs], T=cams.T[idxs])

    rng = np.random.default_rng(5)
    imgs = rng.uniform(0.0, 0.5, (N_VIEWS, SIZE, SIZE, 3)).astype(np.float32)
    masks = (rng.uniform(size=(N_VIEWS, SIZE, SIZE)) > 0.3).astype(np.float32)
    logs = []
    _, losses = train(scene, Direct(training=True), spec, TrainState(scene, spec.init(scene), 0),
                      make_camera, imgs, masks, torch.Generator().manual_seed(1), size=SIZE,
                      crop_size=CROP, iters=3, n_views=N_VIEWS, mesh=mesh, log_every=1,
                      log_fn=logs.append)
    return losses, {k: v.numpy().copy() for k, v in scene.state_dict().items()}, logs


def _worker(rank, world, store_path, cases, in_path, out_path):
    """A spawned rank: join the gloo group through ``initialize_multihost``
    (a ``file://`` rendezvous), run ``cases``, rank 0 saves."""
    torch.set_num_threads(1)
    P.initialize_multihost(f"file://{store_path}", world, rank)
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    try:
        mesh = P.make_mesh(world, device="cpu")
        state = dict(np.load(in_path))
        out = {}
        for case in cases:
            if case.startswith("step"):
                seed = None if case == "step_keyless" else 7
                loss, new = one_step(state, mesh, seed, clip_norm=0.5 if case == "step_clip"
                                     else None)
                out[f"{case}/loss"] = np.float64(loss)
                out.update({f"{case}/{k}": v for k, v in new.items()})
            elif case == "render":
                with torch.no_grad():
                    values, active = P.sharded_render_rays(
                        tiny_scene(state), render_rays(), Direct(training=False), mesh,
                        generator=torch.Generator().manual_seed(1))
                out["render/values"], out["render/active"] = values.numpy(), active.numpy()
            elif case == "train":
                losses, new, logs = train_loop(state, mesh)
                out["train/losses"] = np.asarray(losses)
                out["train/logs"] = np.asarray(len(logs))
                out.update({f"train/{k}": v for k, v in new.items()})
        all_logs = [None] * world
        dist.all_gather_object(all_logs, int(out.get("train/logs", 0)))
        out["logs_by_rank"] = np.asarray(all_logs)
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


def spawn(tmp_path, worlds: dict, state_np) -> dict:
    """Run ``worlds[n]``'s cases in a gloo world of ``n`` ranks, the worlds
    side by side -> rank 0's results by world size."""
    in_path = str(tmp_path / "in.npz")
    np.savez(in_path, **state_np)
    ctxs = {world: mp.start_processes(
        _worker, args=(world, str(tmp_path / f"store{world}"), cases, in_path,
                       str(tmp_path / f"out{world}.npz")),
        nprocs=world, join=False, start_method="spawn") for world, cases in worlds.items()}
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        for world, ctx in ctxs.items():
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    pytest.fail(f"the world-{world} spawn took over {SPAWN_TIMEOUT} s "
                                "(a hung collective?)")
    finally:
        for ctx in ctxs.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    out = {}
    for world in worlds:
        with np.load(tmp_path / f"out{world}.npz") as f:
            out[world] = dict(f)
    return out


def assert_state(got: dict, want: dict, prefix: str = ""):
    for k, w in want.items():
        np.testing.assert_allclose(got[prefix + k], w, atol=1e-5, rtol=1e-4, err_msg=k)


# ---- the batch helpers ---------------------------------------------------------------

@pytest.mark.parametrize("n_views,n", [(6, 4), (8, 4), (6, 8), (5, 2), (3, 1)])
def test_pad_and_shard_match_jax(n_views, n):
    import jax.numpy as jnp
    from neural_raytracing_tpu.parallel import mesh as JM
    rng = np.random.default_rng(n_views * 10 + n)
    exp = rng.normal(size=(n_views, 4, 4, 3)).astype(np.float32)
    other = rng.normal(size=(n_views + 1, 2)).astype(np.float32)
    assert P.padded_size(n_views, n) == JM.padded_size(n_views, n)
    want = JM.pad_batch({"exp": jnp.asarray(exp), "other": jnp.asarray(other)}, n_views, n)
    for tree in ({"exp": exp, "other": other},
                 {"exp": torch.from_numpy(exp), "other": torch.from_numpy(other)}):
        got = P.pad_batch(tree, n_views, n)
        np.testing.assert_array_equal(np.asarray(got["exp"]), np.asarray(want["exp"]))
        np.testing.assert_array_equal(np.asarray(got["other"]), other)
        # padded once, padded no further
        again = P.pad_batch(got, n_views, n)
        assert again["exp"] is got["exp"] or n_views % n == 0
        np.testing.assert_array_equal(np.asarray(again["exp"]), np.asarray(want["exp"]))
    padded = np.asarray(want["exp"])
    per = padded.shape[0] // n
    for rank in range(n):
        mesh = P.Mesh(n, rank, torch.device("cpu"))
        shard = P.shard_batch(torch.from_numpy(exp), mesh, n_views)
        np.testing.assert_array_equal(shard.numpy(), padded[rank * per:(rank + 1) * per])
    # the camera NamedTuple shards leaf by leaf
    cam = P.shard_batch(cameras(n_views), P.Mesh(n, n - 1, torch.device("cpu")), n_views)
    assert cam.R.shape[0] == per and cam.fov == 60.0


def test_make_mesh_world_of_one_and_the_size_check():
    mesh = P.make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.collective) == (1, 0, False)
    assert P.make_mesh(1, device="cpu").size == 1
    with pytest.raises(ValueError, match="world size is 1"):
        P.make_mesh(8, device="cpu")
    assert P.replicated(mesh).kind == "replicated" and P.data_sharding(mesh).kind == "data"
    P.initialize_multihost(num_processes=1)       # nothing to do for one process
    assert not dist.is_initialized()


def test_view_shard_draws_the_padded_batchs_rows():
    from neural_raytracing_tpu_torch.ops import sampling
    gen = lambda: torch.Generator().manual_seed(4)          # noqa: E731
    whole = sampling.uniform(gen(), (8, 5, 2), "cpu")
    steps = sampling.normal(gen(), (3, 8, 5), "cpu")
    for rank in range(4):
        with sampling.view_shard(rank, 2, 8):
            part = sampling.uniform(gen(), (2, 5, 2), "cpu", batch_axis=0)
            inner = sampling.normal(gen(), (3, 2, 5), "cpu", batch_axis=1)
            # a 0-d draw is the same on every rank
            scalar = sampling.uniform(gen(), (), "cpu")
            # a draw that names no batch axis, or one of another length, has
            # no rows of this rank: it raises, though its leading axis is 2
            for shape, axis in (((2, 5), None), ((5, 2), 0), ((2, 5), 1)):
                with pytest.raises(ValueError, match="batch axis"):
                    sampling.uniform(gen(), shape, "cpu", batch_axis=axis)
        torch.testing.assert_close(part, whole[2 * rank:2 * rank + 2], rtol=0, atol=0)
        torch.testing.assert_close(inner, steps[:, 2 * rank:2 * rank + 2], rtol=0, atol=0)
        torch.testing.assert_close(scalar, sampling.uniform(gen(), (), "cpu"), rtol=0, atol=0)
    # outside a shard the batch axis changes nothing
    torch.testing.assert_close(sampling.uniform(gen(), (8, 5, 2), "cpu", batch_axis=0), whole,
                               rtol=0, atol=0)


def test_a_shards_render_is_its_rows_of_the_whole_render():
    """``pathtrace_sample(shard=)``: the camera jitter (no view axis, here of
    a crop of 2, the shard's view count) is drawn whole on every rank, and
    Path's per-ray BSDF draws are the rank's rows of the whole batch's, so
    each rank of 4 renders its 2 rows of the padded batch of 8.  A shard's
    field without a leading view axis is refused by ``gather_views``."""
    from neural_raytracing_tpu_torch.integrators import Path
    from neural_raytracing_tpu_torch.render import pathtrace_sample
    scene = tiny_scene(_seed_state(radius=0.3))
    cam = cameras(8)
    kw = dict(crop_size=2, size=6, with_noise=1.0, training=False)
    with torch.no_grad():
        want, want_hit, _ = pathtrace_sample(scene, Path(max_depth=2), cam, (2, 2),
                                             torch.Generator().manual_seed(5), **kw)
        assert 0 < want_hit.float().mean() < 1
        for rank in range(4):
            local = P.shard_batch(cam, P.Mesh(4, rank, torch.device("cpu")), 8)
            got, hit, it = pathtrace_sample(scene, Path(max_depth=2), local, (2, 2),
                                            torch.Generator().manual_seed(5),
                                            shard=(rank, 2, 8), **kw)
            rows = slice(2 * rank, 2 * rank + 2)
            torch.testing.assert_close(hit, want_hit[rows], rtol=0, atol=0)
            torch.testing.assert_close(got, want[rows], rtol=1e-5, atol=1e-6)
    mesh = P.make_mesh(device="cpu")
    assert P.gather_views((got, None), mesh, 2)[0] is got
    with pytest.raises(ValueError, match="no leading view axis"):
        P.gather_views((got, torch.zeros(3)), mesh, 2)


# ---- the steps -------------------------------------------------------------------------

def _seed_state(radius=0.0):
    """The seed-0 state, the sphere radii raised by ``radius``."""
    state = {k: v.numpy().copy() for k, v in tiny_scene().state_dict().items()}
    state["shape.radii"] = state["shape.radii"] + np.float32(radius)
    return state


def test_world_of_one_equals_the_plain_step_bit_for_bit():
    state = _seed_state()
    mesh = P.make_mesh(device="cpu")
    for seed in (None, 7):
        want_loss, want = one_step(state, None, seed)
        got_loss, got = one_step(state, mesh, seed)
        assert got_loss == want_loss
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # make_train_step is the plain step; donate changes nothing
    scene = tiny_scene(state)
    spec = make_optimizer(LRS)
    step = make_train_step(scene, Direct(training=True), spec, donate=True, size=SIZE,
                           crop_size=CROP)
    camera, exp, mask = batch(N_VIEWS)
    _, aux = step(TrainState(scene, spec.init(scene), 0), camera, UV, exp, mask,
                  torch.Generator().manual_seed(7))
    assert aux["loss"].item() == one_step(state, None, 7)[0]


def test_padded_views_carry_no_gradient():
    """``n_real_views``: a batch padded by repeating the last view gives the
    step of the unpadded batch."""
    state = _seed_state()
    want_loss, want = one_step(state, None, 7)
    scene = tiny_scene(state)
    spec = make_optimizer(LRS)
    step = build_step_fn(scene, Direct(training=True), spec, size=SIZE, crop_size=CROP,
                         n_real_views=N_VIEWS)
    camera, exp, mask = P.pad_batch(batch(N_VIEWS), N_VIEWS, 4)
    assert len(camera) == 8
    _, aux = step(TrainState(scene, spec.init(scene), 0), camera, UV, exp, mask,
                  torch.Generator().manual_seed(7))
    np.testing.assert_allclose(aux["loss"].item(), want_loss, rtol=1e-6)
    assert_state({k: v.numpy() for k, v in scene.state_dict().items()}, want)


@functools.lru_cache(maxsize=None)
def jax_params():
    """The JAX tiny scene's PRNGKey(0) params as numpy, the sphere radii
    raised by 0.3 so that about a tenth of the crop's rays hit."""
    import jax
    import test_parallel as JP
    tree = jax.tree.map(np.asarray, JP.tiny_scene().init(jax.random.PRNGKey(0)))
    tree["shape"]["radii"] = tree["shape"]["radii"] + np.float32(0.3)
    return tree


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The gloo worlds of 2 and 4, each spawned once, from ``jax_params``
    carried into the port."""
    from neural_raytracing_tpu_torch.params import state_dict_from_jax as flat
    state = {k: v.numpy() for k, v in flat(jax_params()).items()}
    tmp = tmp_path_factory.mktemp("worlds")
    return state, spawn(tmp, {2: ["step", "step_clip", "render", "train"],
                              4: ["step_keyless"]}, state)


@pytest.mark.parametrize("world,case,seed", [(2, "step", 7), (4, "step_keyless", None)],
                         ids=["2", "4"])
def test_gloo_world_equals_the_single_process_step(worlds, world, case, seed):
    state, out = worlds
    want_loss, want = one_step(state, None, seed)
    np.testing.assert_allclose(float(out[world][f"{case}/loss"]), want_loss, rtol=1e-5)
    assert_state(out[world], want, f"{case}/")
    changed = [k for k in want if not np.array_equal(want[k], state[k])]
    assert "shape.centers" in changed and "bsdf.reflectance" in changed


def test_gloo_world_clips_the_reduced_gradient(worlds):
    state, out = worlds
    want_loss, want = one_step(state, None, 7, clip_norm=0.5)
    np.testing.assert_allclose(float(out[2]["step_clip/loss"]), want_loss, rtol=1e-5)
    assert_state(out[2], want, "step_clip/")


def test_world_four_equals_jaxs_eight_device_step(worlds):
    import jax
    import jax.numpy as jnp
    import test_parallel as JP
    from neural_raytracing_tpu.cameras import FoVPerspectiveCamera as JFoV
    from neural_raytracing_tpu.cameras import look_at_view_transform as jlook
    from neural_raytracing_tpu.integrators import Direct as JDirect
    from neural_raytracing_tpu.parallel import make_mesh, make_parallel_train_step, replicate
    from neural_raytracing_tpu.shapes import SDF as JSDF
    import neural_raytracing_tpu.training as JT
    from neural_raytracing_tpu.training import make_optimizer as jmake_optimizer
    from neural_raytracing_tpu_torch.params import state_dict_from_jax as flat
    state, out = worlds
    jscene = JP.tiny_scene()
    js = jscene.shape
    js.throughput = lambda params, r_o, r_d, key=None: JSDF.throughput(
        js, params, r_o, r_d, key=None)
    jopt = jmake_optimizer(LRS)
    params = jax.tree.map(jnp.asarray, jax_params())
    jstate = JT.TrainState(params, jopt.init(params), jnp.int32(0))
    r, t = jlook(dist=2.0, elev=np.linspace(0, 30, N_VIEWS), azim=np.linspace(-45, 45, N_VIEWS))
    _, exp, mask = batch(N_VIEWS)
    mesh8 = make_mesh(8)
    step8 = make_parallel_train_step(jscene, JDirect(training=True), jopt, mesh8,
                                     n_views=N_VIEWS, size=SIZE, crop_size=CROP)
    s8, aux8 = step8(replicate(jstate, mesh8), JFoV(R=r, T=t), tuple(map(jnp.float32, UV)),
                     jnp.asarray(exp.numpy()), jnp.asarray(mask.numpy()),
                     jax.random.PRNGKey(1))
    np.testing.assert_allclose(float(out[4]["step_keyless/loss"]), float(aux8["loss"]),
                               rtol=1e-5)
    want = {k: v.numpy() for k, v in flat(jax.tree.map(np.asarray, s8.params)).items()}
    assert_state(out[4], want, "step_keyless/")


def test_sharded_render_rays_equals_the_unsharded_render(worlds):
    state, out = worlds
    scene = tiny_scene(state)
    with torch.no_grad():
        values, active, _ = Direct(training=False).sample(
            scene, render_rays(), generator=torch.Generator().manual_seed(1))
    assert out[2]["render/values"].shape == (19, 3)
    np.testing.assert_allclose(out[2]["render/values"], values.numpy(), atol=1e-5)
    np.testing.assert_array_equal(out[2]["render/active"], active.numpy())
    assert active.any() and not active.all()
    # a world of one without a group is the plain render
    with torch.no_grad():
        v1, a1 = P.sharded_render_rays(scene, render_rays(), Direct(training=False),
                                       P.make_mesh(device="cpu"),
                                       generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(v1.numpy(), values.numpy())


def test_train_with_a_mesh_equals_train_without(worlds):
    state, out = worlds
    want_losses, want, logs = train_loop(state, None)
    assert len(want_losses) == 3 and len(logs) == 3
    np.testing.assert_allclose(out[2]["train/losses"], want_losses, rtol=1e-5)
    assert_state(out[2], want, "train/")
    # only rank 0 logs
    assert list(out[2]["logs_by_rank"]) == [3, 0]


def test_train_refuses_a_mesh_beside_device_data_or_light_update():
    mesh = P.make_mesh(device="cpu")
    scene = tiny_scene()
    spec = make_optimizer(LRS)
    st = TrainState(scene, spec.init(scene), 0)
    with pytest.raises(ValueError, match="single-device"):
        train(scene, Direct(training=True), spec, st, None, None, None, size=SIZE,
              crop_size=CROP, iters=1, mesh=mesh, device_data={}, camera_builder=lambda c: c)
    with pytest.raises(ValueError, match="per-view lights"):
        train(scene, Direct(training=True), spec, st, None, None, None, size=SIZE,
              crop_size=CROP, iters=1, mesh=mesh, light_update=lambda *a: None)


def test_nerf_synthetic_data_parallel_trains_on_a_world_of_one(monkeypatch, capsys):
    """``nerf_synthetic --data-parallel --device cpu``: the flagship trains
    2 steps on a world of one, on the analytic sphere of
    ``test_torch_training`` (the loader stubbed)."""
    import neural_raytracing_tpu_torch.training as training
    from neural_raytracing_tpu_torch.training import NeRFDataset
    from neural_raytracing_tpu_torch.workloads import nerf_synthetic
    from test_torch_training import C2W, FOCAL, _gt
    img, mask = _gt()
    data = NeRFDataset(np.concatenate([C2W, C2W[::-1]]), FOCAL,
                       np.concatenate([img, img[::-1]]), np.concatenate([mask, mask[::-1]]))
    monkeypatch.setattr(training, "load_nerf_synthetic", lambda *a, **k: data)
    state, results = nerf_synthetic.main([
        "--data", "unused", "--size", "16", "--iters", "2", "--crop-size", "12",
        "--n-views", "2", "--data-parallel", "--device", "cpu", "--skip-test",
        "--valid-freq", "0", "--log-every", "1"], save=False)
    assert "data-parallel over 1 devices" in capsys.readouterr().out
    assert state.step == 2 and len(results["losses"]) == 2
    assert all(np.isfinite(results["losses"]))
