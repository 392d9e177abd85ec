"""Port parity: the hash-encoded surface — ``HashEncoding``, ``HashSDF`` and
the flagship with ``--surface hash``.

The encoding runs at 4 levels, 2^10 entries, 2 features and resolutions
4-32 with seeded tables of scale 0.1 (the init's 1e-4 would hide the
features); the points reach every level's far corner (coordinates up to
33, so ``c * 2654435761`` overflows 32 bits), the bound itself and beyond
it.  ``HashSDF`` runs over that encoding with a 2 x 16 relu net whose zero
output layer is replaced by a seeded one.  The flagship is the reduced one
of ``test_torch_params`` with that surface in place of the spheres.
Tolerances: encoding and SDF values rtol 1e-6 / atol 1e-6 of the largest;
gradients (tables, points, the eikonal double backward) rtol 1e-5 / atol
1e-5 of the largest; at ``p = 0`` JAX's norm gradient is NaN and torch's 0
(ROADMAP.md Queue 3), so normals and their gradients are compared where
JAX's are finite; the training step and the eval tile as
``test_torch_train_step`` and ``test_torch_render`` (loss rtol 1e-5, each
gradient leaf within 1e-4 of its largest, pixels within 1e-4 where the
masks agree on >= 99%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import neural_raytracing_tpu as J
import neural_raytracing_tpu.training as JT
from neural_raytracing_tpu.cameras import NeRFCamera as JNeRF
from neural_raytracing_tpu.integrators import Direct as JDirect
from neural_raytracing_tpu.nn.hash_encoding import HashEncoding as JHashEncoding
from neural_raytracing_tpu.nn.hash_encoding import HashSDF as JHashSDF
from neural_raytracing_tpu.ops.math import eikonal_loss as jeikonal
from neural_raytracing_tpu.shapes import SDF as JSDF
import neural_raytracing_tpu_torch as T
import neural_raytracing_tpu_torch.kernels.fused_sdf as fused_sdf_mod
import neural_raytracing_tpu_torch.shapes.sdf as sdf_mod
import neural_raytracing_tpu_torch.training as TT
from neural_raytracing_tpu_torch.cameras import NeRFCamera
from neural_raytracing_tpu_torch.integrators import Direct
from neural_raytracing_tpu_torch.kernels import supports
from neural_raytracing_tpu_torch.nn import HashEncoding, HashSDF
from neural_raytracing_tpu_torch.ops.math import eikonal_loss
from neural_raytracing_tpu_torch.params import load_jax_params, state_dict_from_jax
from neural_raytracing_tpu_torch.render import _tile_positions
from neural_raytracing_tpu_torch.shapes import SDF
from neural_raytracing_tpu_torch.workloads import nerf_synthetic
from test_torch_params import build_scene as sphere_scene
from test_torch_params import scene_params
from test_torch_render import C2W as VIEW_C2W
from test_torch_render import CHUNK
from test_torch_render import FOCAL as VIEW_FOCAL
from test_torch_render import SIZE as VIEW_SIZE
from test_torch_train_step import CROP, UV, _jax_loss_and_grads
from test_torch_training import C2W, FOCAL, LRS, SIZE, _gt

torch.set_num_threads(1)
ENC = dict(levels=4, table_size_log2=10, features=2, base_resolution=4, max_resolution=32)


def _flat(tree):
    return {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree.map(np.asarray, tree)).items()}


def _close(got, want, what, rtol=1e-6, scale=1e-6):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=scale * np.abs(want).max(),
                               err_msg=what)


def _points(n=512, seed=0, bound=2.0):
    """Seeded points in and around ``[-bound, bound]^3``: the bound's faces and
    corner exactly, points beyond it, the origin and voxel edges."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.1 * bound, 1.1 * bound, size=(n, 3)).astype(np.float32)
    p[0] = bound
    p[1] = -bound
    p[2] = (bound, -bound, 0.3)
    p[3] = 0.0
    p[4] = (0.25, -0.5, 1.0)          # on voxel edges of every level
    p[5] = (3.0, -2.5, 2.2)           # beyond the bound on all three axes
    return p


def _tables(seed=1):
    shape = (ENC["levels"], 2 ** ENC["table_size_log2"], ENC["features"])
    return (0.1 * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


# ---- HashEncoding -------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [{}, ENC, dict(levels=1), dict(levels=3, max_resolution=100)])
def test_resolutions_match_jax(cfg):
    assert HashEncoding(**cfg).resolutions == JHashEncoding(**cfg).resolutions
    assert HashEncoding(**cfg).out_size == JHashEncoding(**cfg).out_size


def test_hash_products_overflow_32_bits_and_match_jax():
    enc, jenc = HashEncoding(**ENC), JHashEncoding(**ENC)
    c = np.random.default_rng(2).integers(0, max(enc.resolutions) + 2, size=(4096, 3))
    c[:3] = max(enc.resolutions) + 1
    assert (c[:, 1].astype(np.int64) * 2654435761 >= 2 ** 32).mean() > 0.9
    want = np.asarray(jenc._hash(jnp.asarray(c, jnp.int32)))
    got = enc.hash(torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("stacked", [False, True])
def test_hash_encoding_matches_jax(stacked):
    # the port's one body against each JAX variant; its flag changes nothing
    enc = HashEncoding(**ENC, stacked=stacked)
    jenc = JHashEncoding(**ENC, stacked=stacked)
    tables, p = _tables(), _points()
    w = np.random.default_rng(3).normal(size=(len(p), enc.out_size)).astype(np.float32)

    def jloss(params, q):
        return jnp.sum(jenc(params, q) * w)

    params = {"tables": jnp.asarray(tables)}
    want = np.asarray(jenc(params, jnp.asarray(p)))
    jg_tables, jg_p = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(p))

    load_jax_params(enc, {"tables": tables}, device="cpu")
    q = torch.from_numpy(p).requires_grad_()
    got = enc(q)
    torch.sum(got * torch.from_numpy(w)).backward()
    assert got.shape == want.shape == (len(p), 8)
    _close(got, want, "features")
    _close(enc.tables.grad, jg_tables["tables"], "d tables", 1e-5, 1e-5)
    _close(q.grad, jg_p, "d p", 1e-5, 1e-5)
    # beyond the bound the clip's gradient is 0; on it, half (the tie forms)
    assert (q.grad[5] == 0).all() and (q.grad[0] != 0).any()


def test_hash_encoding_at_its_defaults_matches_jax_on_batched_points():
    """8 levels, 2^14 entries, resolutions 16-512, over a ``[4, 64, 3]``
    batch: the port's one gather against the JAX per-level loop (rtol 1e-6,
    atol 1e-6 of the largest)."""
    enc, jenc = HashEncoding(), JHashEncoding()
    tables = (0.1 * np.random.default_rng(8).normal(
        size=(8, 2 ** 14, 2))).astype(np.float32)
    p = _points(n=256, seed=9).reshape(4, 64, 3)
    want = np.asarray(jenc({"tables": jnp.asarray(tables)}, jnp.asarray(p)))
    load_jax_params(enc, {"tables": tables}, device="cpu")
    with torch.no_grad():
        got = enc(torch.from_numpy(p))
    assert got.shape == want.shape == (4, 64, 16)
    _close(got, want, "features at the defaults")


def test_hash_encoding_init_draws_and_keeps_its_constants_out_of_the_state():
    enc = HashEncoding(**ENC)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    t = enc.tables.detach()
    assert 0 < t.abs().max() <= 1e-4 and t.min() < 0 < t.max()
    assert list(enc.state_dict()) == ["tables"]


# ---- HashSDF -------------------------------------------------------------------------------

def _sdf_params(jmodule, seed=0):
    """JAX HashSDF params with scale-0.1 tables and a seeded output layer."""
    tree = jax.tree.map(np.asarray, jmodule.init(jax.random.PRNGKey(seed)))
    tree["enc"]["tables"] = _tables(seed + 1)
    rng = np.random.default_rng(seed + 2)
    tree["mlp"]["out"] = {k: (0.1 * rng.normal(size=v.shape)).astype(np.float32)
                          for k, v in tree["mlp"]["out"].items()}
    return tree


def _sdf_pair():
    jmodule = JHashSDF(encoding=JHashEncoding(**ENC), hidden_size=16)
    module = HashSDF(encoding=HashEncoding(**ENC), hidden_size=16)
    tree = _sdf_params(jmodule)
    return jmodule, tree, load_jax_params(module, tree, device="cpu")


def test_hash_sdf_starts_as_the_sphere_and_names_its_params_as_jax():
    jmodule = JHashSDF(encoding=JHashEncoding(**ENC), hidden_size=16)
    tree = jax.tree.map(np.asarray, jmodule.init(jax.random.PRNGKey(0)))
    module = HashSDF(encoding=HashEncoding(**ENC), hidden_size=16)
    assert set(module.state_dict()) == set(_flat(tree))
    assert module.encoding is module.enc
    module.reset_parameters(torch.Generator().manual_seed(0))
    p = torch.from_numpy(_points(seed=6))
    with torch.no_grad():
        np.testing.assert_allclose(module(p).numpy(),
                                   (torch.linalg.norm(p, dim=-1) - 0.5).numpy(), rtol=0, atol=0)
    assert not supports(module)


def test_hash_sdf_values_normals_and_eikonal_match_jax():
    jmodule, tree, module = _sdf_pair()
    jsdf, sdf = JSDF(jmodule), SDF(module)
    p = _points(seed=7, bound=1.0)
    params = jax.tree.map(jnp.asarray, tree)
    want = np.asarray(jsdf.sdf(params, jnp.asarray(p)))
    want_n = np.asarray(jsdf.normals(params, jnp.asarray(p)))
    jloss, jg = jax.value_and_grad(
        lambda pr: jeikonal(jsdf.normals(pr, jnp.asarray(p[4:]))))(params)

    with torch.no_grad():
        _close(sdf.sdf(torch.from_numpy(p)), want, "sdf")
    got_n = sdf.normals(torch.from_numpy(p)).detach().numpy()
    finite = np.isfinite(want_n).all(-1)
    assert finite[4:].all() and np.isfinite(got_n).all() and not finite[3]
    _close(got_n[finite], want_n[finite], "normals", 1e-5, 1e-5)
    loss = eikonal_loss(sdf.normals(torch.from_numpy(p[4:])))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want_g = _flat(jg)
    for k, prm in sdf.named_parameters():
        # no gradient reaches the output bias (torch: None, JAX: zeros)
        g = torch.zeros_like(prm) if prm.grad is None else prm.grad
        _close(g, want_g[k], f"eikonal d {k}", 1e-5, 1e-5)


def _kernels_fail(monkeypatch):
    """Every kernel route a surface can take (K2-K4 in ``shapes.sdf``, the
    bf16 plain stand-in, K5) fails; returns the routes taken."""
    taken = []

    def fail(name):
        def fn(*a, **k):
            taken.append(name)
            raise AssertionError(f"{name} was routed to")
        return fn

    for name in ("fused_march", "fused_min_scan", "fused_shadow_march",
                 "sphere_sdf_eval_plain"):
        monkeypatch.setattr(sdf_mod, name, fail(name))
    monkeypatch.setattr(fused_sdf_mod, "fused_sphere_sdf", fail("fused_sphere_sdf"))
    return taken


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_kernel_route_for_a_hash_surface(dtype, monkeypatch):
    _, _, module = _sdf_pair()
    sdf = SDF(module, max_steps=16, fused_loops="force", march_dtype=dtype)
    assert not sdf._use_kernel(torch.zeros(1, 3)) and sdf._loop_sdf() == sdf.sdf
    taken = _kernels_fail(monkeypatch)
    rays = NeRFCamera(torch.from_numpy(VIEW_C2W), VIEW_FOCAL).sample_positions(
        _tile_positions(0.0, 0.0, VIEW_SIZE, "cpu"), size=VIEW_SIZE)
    with torch.no_grad():
        _, hit = sdf.intersect(rays, primary=True)
        sdf.intersect_test(rays)
        sdf.throughput(rays[..., :3], rays[..., 3:])
    assert taken == [] and 0 < hit.float().mean() < 1


# ---- the hash flagship ---------------------------------------------------------------------

def hash_scene(lib, max_steps=64, march_bound=None, radius=0.5):
    """The reduced flagship of ``test_torch_params`` with the hash surface."""
    scene = sphere_scene(lib, max_steps=max_steps, march_bound=march_bound)
    if lib == "jax":
        module = JHashSDF(encoding=JHashEncoding(**ENC), hidden_size=16,
                          init_sphere_radius=radius)
        return scene.replace(shape=JSDF(module, max_steps=max_steps, march_bound=march_bound))
    module = HashSDF(encoding=HashEncoding(**ENC), hidden_size=16, init_sphere_radius=radius)
    return scene.replace(shape=SDF(module, max_steps=max_steps, march_bound=march_bound))


def hash_pair(radius=0.5, **kw):
    jscene = hash_scene("jax", radius=radius, **kw)
    tree = scene_params(sphere_scene("jax", **kw))
    tree["shape"] = _sdf_params(jscene.shape.module)
    return jscene, tree, load_jax_params(hash_scene("torch", radius=radius, **kw), tree,
                                         device="cpu")


def test_hash_flagship_training_step_matches_jax():
    # a smaller sphere than the default 0.5: the camera is at distance 1
    jscene, tree, scene = hash_pair(max_steps=16, radius=0.25)
    for s in (jscene.shape, scene.shape):
        s.throughput_steps = 16
    js = jscene.shape
    js.throughput = lambda params, r_o, r_d, key=None: JSDF.throughput(
        js, params, r_o, r_d, key=None)
    img, mask = _gt()
    exp = img[:, UV[0]:UV[0] + CROP, UV[1]:UV[1] + CROP]
    msk = mask[:, UV[0]:UV[0] + CROP, UV[1]:UV[1] + CROP]
    jloss, jgrads = _jax_loss_and_grads(jscene, tree, jnp.asarray(exp), jnp.asarray(msk))

    spec = TT.make_optimizer(LRS)
    state = TT.TrainState(scene, spec.init(scene), 0)
    step = TT.build_step_fn(scene, Direct(training=True), spec, size=SIZE, crop_size=CROP)
    state, aux = step(state, NeRFCamera(torch.from_numpy(C2W), FOCAL), UV,
                      torch.from_numpy(exp), torch.from_numpy(msk))
    np.testing.assert_allclose(aux["loss"].item(), float(jloss), rtol=1e-5)
    alpha = aux["got"][..., 3]
    assert (alpha > 0.5).any() and (alpha < 0.5).any()
    want_g = _flat(jgrads)
    assert np.abs(want_g["shape.enc.tables"]).max() > 0
    for k, p in scene.named_parameters():
        wg = want_g[k]
        np.testing.assert_allclose(p.grad.numpy(), wg, rtol=0,
                                   atol=1e-4 * np.abs(wg).max() + 1e-12, err_msg=k)


def test_hash_flagship_eval_tile_matches_jax():
    jscene, tree, scene = hash_pair(max_steps=256, march_bound=1.2)
    want, _ = J.pathtrace(jscene, tree, JNeRF(cam_to_world=jnp.asarray(VIEW_C2W),
                                              focal=VIEW_FOCAL),
                          JDirect(training=False), size=VIEW_SIZE, chunk_size=CHUNK,
                          bundle_size=1, background=0.0, key=None)
    want = np.asarray(want)
    got, _ = T.pathtrace(scene, NeRFCamera(torch.from_numpy(VIEW_C2W), VIEW_FOCAL),
                         Direct(training=False), size=VIEW_SIZE, chunk_size=CHUNK,
                         bundle_size=1, background=0.0, device="cpu")
    got = got.numpy()
    mask, jmask = np.abs(got).sum(-1) > 0, np.abs(want).sum(-1) > 0
    assert 0 < jmask.mean() < 1 and (mask == jmask).mean() >= 0.99
    agree = mask == jmask
    np.testing.assert_allclose(got[agree], want[agree], atol=1e-4, rtol=0)


def test_hash_artifacts_load_both_ways(tmp_path):
    _, tree, scene = hash_pair()
    # the port's artifacts restore in flax, and the JAX package's in the port
    TT.save_scene(str(tmp_path / "port"), scene, step=3)
    data = (tmp_path / "port" / "shape.msgpack").read_bytes()
    restored = serialization.from_bytes(tree["shape"], data)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(tree["shape"]),
                                jax.tree_util.tree_leaves_with_path(restored)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    JT.save_scene(str(tmp_path / "jax"), tree, step=3)
    fresh = hash_scene("torch").init(torch.Generator().manual_seed(9), device="cpu")
    TT.load_scene(str(tmp_path / "jax"), fresh)
    for k, v in scene.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_nerf_synthetic_builds_the_hash_surface_at_its_defaults():
    scene = nerf_synthetic.build_scene(surface="hash")
    module = scene.shape.module
    assert isinstance(module, HashSDF) and not supports(module)
    assert module.enc.resolutions == (16, 26, 43, 70, 115, 190, 312, 512)
    assert tuple(module.enc.tables.shape) == (8, 2 ** 14, 2)
    want = _flat(JHashSDF().init(jax.random.PRNGKey(0)))
    got = {k: tuple(v.shape) for k, v in scene.shape.state_dict().items()}
    assert got == {k: v.shape for k, v in want.items()}


@pytest.mark.timeout(180)
def test_nerf_synthetic_surface_hash_trains_tests_and_saves_on_the_cpu(tmp_path):
    """``run(--surface hash)`` on the analytic sphere: 2 steps, a validation
    render each, the test split; the artifacts reload into a fresh hash
    scene."""
    img, mask = _gt()
    data = TT.NeRFDataset(C2W, FOCAL, img, mask)
    args = nerf_synthetic.parser().parse_args([
        "--data", "unused", "--surface", "hash", "--size", str(SIZE), "--iters", "2",
        "--crop-size", str(CROP), "--n-views", "2", "--valid-freq", "1",
        "--test-max-steps", "16", "--log-every", "1", "--device", "cpu",
        "--outputs", str(tmp_path / "out"), "--models", str(tmp_path / "models")])
    state, results = nerf_synthetic.run(args, data, data, "sphere")
    assert state.step == 2 and np.isfinite(results["losses"]).all()
    assert results["test_images"].shape == (2, SIZE, SIZE, 3)
    assert isinstance(state.scene.shape.module, HashSDF)
    fresh = nerf_synthetic.build_scene(surface="hash").init(torch.Generator().manual_seed(5),
                                                            device="cpu")
    TT.load_scene(str(tmp_path / "models" / "sphere"), fresh)
    for k, v in state.scene.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
