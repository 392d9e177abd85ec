"""Port parity: the rest of the NeRF family — ``param_rusin``,
``random_on_sphere``, ``TwoStageMLP``, the auto-decoders,
``DensityEstimator``, the learned warps (``NeuralWarp``, ``MipMap``,
``SphericalHarmonics``), the samplers (``permute_kensler``,
``OrthogonalSampler``), ``GlobalNeuralBSDF`` and ``NeuralApprox``.

Params come from the JAX package's ``init`` and go across with
``load_jax_params``; the density estimators take seeded, perturbed params
(at init every component is the same unit Gaussian).  Draws are replayed:
``ops.sampling.uniform`` by the ``replay`` fixture of
``test_torch_bsdf_sampling``, ``ops.sampling.normal`` by ``replay_normals``,
each from the JAX key the function under test splits.  Sizes: the nets at
3 layers x 32, ``prime`` 3 steps, the reduced NeRV scene of
``test_torch_occlusion`` for ``NeuralApprox``.
Tolerances: forwards rtol 1e-5 / atol 1e-6 of the largest, gradients rtol
1e-4 / atol 1e-5 of the largest (float32 in another order); ``prime``'s
loss rtol 1e-5 and its parameters rtol 1e-4 / atol 1e-6 (three Adam steps
of 1e-3); ``SphericalHarmonics.fit`` rtol 1e-4 (two least-squares
routines); the samplers' integers exactly; the ``NeuralApprox`` render as
``test_torch_path`` (hit flags equal on >= 99%, values within 1e-4, and
each component's gradient within 1e-4 relative L2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_raytracing_tpu import samplers as jsamplers
from neural_raytracing_tpu import warps as jwarps
from neural_raytracing_tpu.bsdf.bsdfs import GlobalNeuralBSDF as JGlobal
from neural_raytracing_tpu.integrators import NeuralApprox as JNeuralApprox
from neural_raytracing_tpu.nn import mlp as jmlp
from neural_raytracing_tpu.ops.rusin import param_rusin as j_param_rusin
from neural_raytracing_tpu.ops.warps import random_on_sphere as j_random_on_sphere
from neural_raytracing_tpu_torch import samplers, warps
from neural_raytracing_tpu_torch.bsdf import GlobalNeuralBSDF
from neural_raytracing_tpu_torch.integrators import NeuralApprox
from neural_raytracing_tpu_torch.nn import mlp
from neural_raytracing_tpu_torch.ops import sampling
from neural_raytracing_tpu_torch.ops.rusin import param_rusin
from neural_raytracing_tpu_torch.ops.warps import random_on_sphere
from neural_raytracing_tpu_torch.params import load_jax_params
from test_torch_bsdf_sampling import (  # noqa: F401  (replay: a fixture)
    GEN, _close, _close_grads, _flat, _interactions, _rel_l2, replay, uniform,
)
from test_torch_occlusion import nerv_pair
from test_torch_path import _camera_rays, _compare

torch.set_num_threads(1)
NET = dict(num_layers=3, hidden_size=32, freqs=4, sigma=2.0)


class _Normals:
    """``sampling.normal`` replaced by the JAX normals, in call order."""

    def __init__(self, arrays):
        self.arrays = [np.array(a, np.float32) for a in arrays]

    def __call__(self, generator, shape, device, batch_axis=None):
        assert self.arrays, "the port drew more normals than the JAX function"
        a = self.arrays.pop(0)
        assert a.shape == tuple(shape), (a.shape, tuple(shape))
        return torch.from_numpy(a).to(device)


@pytest.fixture
def replay_normals(monkeypatch):
    made = []

    def pin(arrays):
        made.append(_Normals(arrays))
        monkeypatch.setattr(sampling, "normal", made[-1])

    yield pin
    assert all(not r.arrays for r in made), "the port drew fewer normals than JAX"


def _tree(jmodule, seed=0):
    return jax.tree.map(np.asarray, jmodule.init(jax.random.PRNGKey(seed)))


def _params(tree):
    return jax.tree.map(jnp.asarray, tree)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


# ---- the ops --------------------------------------------------------------------------------

def test_param_rusin_matches_jax():
    rng = np.random.default_rng(0)
    n, wo, wi = _unit(rng, 256), _unit(rng, 256), _unit(rng, 256)
    n[0] = (0.0, 0.0, 1.0)          # n on +z, the bisector's own axis
    n[1] = (0.0, 0.0, -1.0)         # n on -z: the bisector is the zero vector
    wo[2], wi[2] = (0.0, 0.0, 1.0), (0.0, 0.0, 1.0)
    w = rng.normal(size=(256, 3)).astype(np.float32)
    args = [jnp.asarray(a) for a in (n, wo, wi)]
    want = np.asarray(j_param_rusin(*args))
    jg = jax.grad(lambda a, b, c: jnp.sum(j_param_rusin(a, b, c) * w), argnums=(0, 1, 2))(*args)
    ts = [torch.from_numpy(a).requires_grad_() for a in (n, wo, wi)]
    got = param_rusin(*ts)
    torch.sum(got * torch.from_numpy(w)).backward()
    _close(got, want, "param_rusin", rtol=1e-5)
    for t, g, name in zip(ts, jg, ("n", "wo", "wi")):
        finite = np.isfinite(np.asarray(g)).all(-1)
        assert finite.mean() > 0.99
        _close(t.grad[finite], np.asarray(g)[finite], f"d {name}", rtol=1e-4, scale=1e-5)


def test_random_on_sphere_matches_jax(replay):
    key = jax.random.PRNGKey(3)
    jd, juv = j_random_on_sphere(key, 300)
    replay([uniform(key, (300, 2))])
    d, uv = random_on_sphere(GEN, 300, "cpu")
    _close(uv, juv, "uv", rtol=0, scale=0)
    _close(d, jd, "directions")
    np.testing.assert_allclose(np.linalg.norm(d.numpy(), axis=-1), 1.0, atol=1e-6)


def test_normal_draw_is_seeded_and_needs_a_generator():
    a = sampling.normal(torch.Generator().manual_seed(1), (4, 3), "cpu")
    b = sampling.normal(torch.Generator().manual_seed(1), (4, 3), "cpu")
    assert torch.equal(a, b) and a.dtype == torch.float32 and a.shape == (4, 3)
    with pytest.raises(ValueError):
        sampling.normal(None, (1,), "cpu")


# ---- TwoStageMLP and the auto-decoders -------------------------------------------------------

def _two_stage_inputs(n=200, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, size=(n, 3)).astype(np.float32),
            rng.uniform(-1, 1, size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))


def _check_two_stage(jnet, tree, net):
    i1, i2, w = _two_stage_inputs()
    want = np.asarray(jnet(_params(tree), jnp.asarray(i1), jnp.asarray(i2)))
    jg = jax.grad(lambda p: jnp.sum(jnet(p, jnp.asarray(i1), jnp.asarray(i2)) * w))(
        _params(tree))
    got = net(torch.from_numpy(i1), torch.from_numpy(i2))
    torch.sum(got * torch.from_numpy(w)).backward()
    assert got.shape == want.shape == (200, 3)
    _close(got, want, "TwoStageMLP", rtol=1e-5)
    _close_grads(net, jg, "TwoStageMLP")


@pytest.mark.parametrize("weight_norm", [True, False])
def test_two_stage_mlp_matches_jax(weight_norm):
    jnet = jmlp.TwoStageMLP(weight_norm=weight_norm, **NET)
    tree = _tree(jnet)
    # a perturbed g, so the weight norm's own factor shows
    if weight_norm:
        for layer in tree["layers1"] + tree["layers2"]:
            layer["g"] = layer["g"] * np.float32(1.3)
    net = load_jax_params(mlp.TwoStageMLP(weight_norm=weight_norm, **NET), tree, device="cpu")
    assert set(net.state_dict()) == set(_flat(tree))
    assert ("layers1.0.v" in net.state_dict()) == weight_norm
    _check_two_stage(jnet, tree, net)


def test_a_plain_layout_tree_loads_into_a_two_stage_mlp_built_plain():
    """The JAX package applies a plain-layout tree (old checkpoints) as plain
    whatever the net's flag; the port picks the layout when the net is
    built: such a tree loads into ``weight_norm=False`` and computes what the
    JAX weight-normed net computes with it, and a strict load into a
    weight-normed net refuses it rather than rebuild the layers."""
    plain = _tree(jmlp.TwoStageMLP(weight_norm=False, **NET), seed=4)
    net = load_jax_params(mlp.TwoStageMLP(weight_norm=False, **NET), plain, device="cpu")
    _check_two_stage(jmlp.TwoStageMLP(weight_norm=True, **NET), plain, net)
    normed = mlp.TwoStageMLP(weight_norm=True, **NET)
    with pytest.raises(RuntimeError, match="layers1.0.v"):
        load_jax_params(normed, plain, device="cpu")
    assert "layers1.0.v" in normed.state_dict()


def test_two_stage_mlp_init_starts_at_the_plain_function():
    net = mlp.TwoStageMLP(weight_norm=True, **NET)
    net.reset_parameters(torch.Generator().manual_seed(0))
    for layer in list(net.layers1) + list(net.layers2):
        np.testing.assert_allclose(layer.weight().detach().numpy(), layer.v.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("own_code", [True, False])
def test_auto_decoder_matches_jax(own_code):
    kw = dict(code_size=8, **NET)
    jnet = jmlp.AutoDecoder(**kw)
    tree = _tree(jnet, seed=2)
    net = load_jax_params(mlp.AutoDecoder(**kw), tree, device="cpu")
    rng = np.random.default_rng(3)
    p = rng.uniform(-1, 1, size=(2, 50, 3)).astype(np.float32)
    code = None if own_code else rng.normal(size=8).astype(np.float32)
    w = rng.normal(size=(2, 50, 3)).astype(np.float32)
    jcode = None if code is None else jnp.asarray(code)
    want = np.asarray(jnet(_params(tree), jnp.asarray(p), jcode))
    jg = jax.grad(lambda pr: jnp.sum(jnet(pr, jnp.asarray(p), jcode) * w))(_params(tree))
    got = net(torch.from_numpy(p), None if code is None else torch.from_numpy(code))
    torch.sum(got * torch.from_numpy(w)).backward()
    _close(got, want, "AutoDecoder", rtol=1e-5)
    _close_grads(net, jg, "AutoDecoder")
    assert (net.code.grad is not None) == own_code


def test_partitioned_auto_decoder_matches_jax():
    # partition 5 over bound 2: the scale is 1, so the cell edges are the integers
    kw = dict(code_size=8, partition_size=5, bound=2.0, **NET)
    jnet = jmlp.PartitionedAutoDecoder(**kw)
    tree = _tree(jnet, seed=6)
    net = load_jax_params(mlp.PartitionedAutoDecoder(**kw), tree, device="cpu")
    rng = np.random.default_rng(7)
    p = rng.uniform(-2.5, 2.5, size=(300, 3)).astype(np.float32)
    p[0] = (-1.0, 0.0, 1.0)          # cell edges
    p[1] = 2.0                       # the bound: the last cell
    p[2] = -2.0
    p[3] = (3.0, -3.0, 2.0)          # beyond it
    p[4] = (np.nextafter(np.float32(-1.0), np.float32(0)), 0.999999, 1e-7)
    flat, local = net.partition(torch.from_numpy(p))
    jflat, jlocal = jnet.partition(jnp.asarray(p))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    _close(local, jlocal, "local", rtol=0, scale=0)
    assert flat[1] == 4 + 4 * 5 + 4 * 25 and flat[2] == 0
    w = rng.normal(size=(300, 3)).astype(np.float32)
    want = np.asarray(jnet(_params(tree), jnp.asarray(p)))
    jg = jax.grad(lambda pr: jnp.sum(jnet(pr, jnp.asarray(p)) * w))(_params(tree))
    got = net(torch.from_numpy(p))
    torch.sum(got * torch.from_numpy(w)).backward()
    _close(got, want, "PartitionedAutoDecoder", rtol=1e-5)
    _close_grads(net, jg, "PartitionedAutoDecoder")


# ---- DensityEstimator and the warps -----------------------------------------------------------

def _estimator_tree(dists=6, seed=8):
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    return {"centers": f(0.4 * rng.normal(size=(dists, 2))),
            "vars": f(0.3 * rng.normal(size=(dists, 3))),
            "weights": f(rng.normal(size=dists))}


def test_density_estimator_pdf_matches_jax():
    jest, tree = jmlp.DensityEstimator(dists=6), _estimator_tree()
    est = load_jax_params(mlp.DensityEstimator(dists=6), tree, device="cpu")
    val = np.random.default_rng(9).uniform(-1.5, 1.5, size=(4, 40, 2)).astype(np.float32)
    w = np.random.default_rng(10).normal(size=(4, 40, 1)).astype(np.float32)
    want = np.asarray(jest.pdf(_params(tree), jnp.asarray(val)))
    jg = jax.grad(lambda pr: jnp.sum(jest.pdf(pr, jnp.asarray(val)) * w))(_params(tree))
    got = est.pdf(torch.from_numpy(val))
    torch.sum(got * torch.from_numpy(w)).backward()
    assert got.shape == want.shape == (4, 40, 1)
    _close(got, want, "pdf", rtol=1e-5)
    _close_grads(est, jg, "pdf")


def test_density_estimator_sample_matches_jax(replay_normals):
    jest, tree = jmlp.DensityEstimator(dists=6), _estimator_tree()
    est = load_jax_params(mlp.DensityEstimator(dists=6), tree, device="cpu")
    key = jax.random.PRNGKey(11)
    jval, jpdf = jest.sample(_params(tree), key, (3, 20))
    replay_normals([jax.random.normal(key, (3, 20, 6, 2))])
    val, pdf = est.sample(GEN, (3, 20))
    _close(val, jval, "values", rtol=1e-5)
    _close(pdf, jpdf, "pdf", rtol=1e-5)


def test_neural_warp_sample_and_pdf_match_jax(replay_normals):
    jw = jwarps.NeuralWarp(dists=6)
    tree = {"estim": _estimator_tree()}
    warp = load_jax_params(warps.NeuralWarp(dists=6), tree, device="cpu")
    key = jax.random.PRNGKey(12)
    jd, jpdf = jw.sample(_params(tree), key, (50,))
    replay_normals([jax.random.normal(key, (50, 6, 2))])
    d, pdf = warp.sample(GEN, (50,))
    _close(d, jd, "directions", rtol=1e-5)
    _close(pdf, jpdf, "pdf", rtol=1e-5)
    val = np.random.default_rng(13).uniform(-1, 1, size=(50, 2)).astype(np.float32)
    _close(warp.pdf(torch.from_numpy(val)), jw.pdf(_params(tree), jnp.asarray(val)),
           "pdf(val)", rtol=1e-5)


def test_neural_warp_prime_matches_jax(replay):
    jw = jwarps.NeuralWarp(dists=6)
    tree = {"estim": _estimator_tree()}
    warp = load_jax_params(warps.NeuralWarp(dists=6), tree, device="cpu")
    key = jax.random.PRNGKey(14)
    jparams, jloss = jw.prime(_params(tree), key, iters=3, batches=256, lr=1e-3)
    draws, k = [], key
    for _ in range(3):
        skey, k = jax.random.split(k)
        draws.append(uniform(skey, (256, 2)))
    replay(draws)
    loss = warp.prime(GEN, iters=3, batches=256, lr=1e-3)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = _flat(jparams)
    for k_, prm in warp.named_parameters():
        assert not np.array_equal(prm.detach().numpy(), _flat(tree)[k_]), k_
        np.testing.assert_allclose(prm.detach().numpy(), want[k_], rtol=1e-4, atol=1e-6,
                                   err_msg=k_)


def test_mipmap_pdf_matches_jax():
    jm = jwarps.MipMap(depth=4)
    tree = _tree(jm, seed=15)
    mm = load_jax_params(warps.MipMap(depth=4), tree, device="cpu")
    rng = np.random.default_rng(16)
    val = rng.uniform(-1.2, 1.2, size=(500, 2)).astype(np.float32)
    val[0], val[1] = (0.0, 0.0), (-1.0, 1.0)             # on the splits and corners
    w = rng.normal(size=500).astype(np.float32)
    want = np.asarray(jm.pdf(_params(tree), jnp.asarray(val)))
    jg = jax.grad(lambda pr: jnp.sum(jm.pdf(pr, jnp.asarray(val)) * w))(_params(tree))
    got = mm.pdf(torch.from_numpy(val))
    torch.sum(got * torch.from_numpy(w)).backward()
    _close(got, want, "MipMap pdf", rtol=1e-5)
    _close_grads(mm, jg, "MipMap pdf")


def test_mipmap_sample_matches_jax(replay):
    jm = jwarps.MipMap(depth=5)
    tree = _tree(jm, seed=17)
    mm = load_jax_params(warps.MipMap(depth=5), tree, device="cpu")
    key = jax.random.PRNGKey(18)
    juv, jpdf = jm.sample(_params(tree), key, (8, 40))
    k1, k2 = jax.random.split(key)
    tiny = float(np.finfo(np.float32).tiny)
    replay([uniform(k1, (8, 40, 32), minval=tiny), uniform(k2, (8, 40, 2))])
    uv, pdf = mm.sample(GEN, (8, 40))
    _close(uv, juv, "uv", rtol=1e-6)
    _close(pdf, jpdf, "pdf", rtol=1e-6)
    # the sample lies in the leaf whose weight is its pdf
    _close(mm.pdf(uv), pdf.detach().numpy(), "pdf at the sample", rtol=1e-6)


def test_legendre_matches_jax():
    x = np.linspace(-1, 1, 101).astype(np.float32)
    for order in (1, 2, 5):
        _close(warps.legendre(torch.from_numpy(x), order),
               jwarps.legendre(jnp.asarray(x), order), f"legendre {order}", rtol=1e-5)


def test_spherical_harmonics_basis_and_fit_match_jax():
    jsh, sh = jwarps.SphericalHarmonics(order=4), warps.SphericalHarmonics(order=4)
    rng = np.random.default_rng(19)
    d = rng.normal(size=(400, 3)).astype(np.float32)
    values = (np.sin(3 * d[:, 0]) + d[:, 2] ** 2).astype(np.float32)
    _close(sh.basis(torch.from_numpy(d)), jsh.basis(jnp.asarray(d)), "basis", rtol=1e-5)
    jfit = jsh.fit(jsh.init(), jnp.asarray(d), jnp.asarray(values))
    got = sh.fit(torch.from_numpy(d), torch.from_numpy(values))
    _close(got, jfit["coeffs"], "fit", rtol=1e-4, scale=1e-5)
    assert torch.equal(sh.coeffs.detach(), got)
    _close(sh(torch.from_numpy(d)), jsh(jfit, jnp.asarray(d)), "SH values", rtol=1e-4,
           scale=1e-5)


# ---- the samplers ---------------------------------------------------------------------------

@pytest.mark.parametrize("samples,seed", [(1, 3), (2, 0), (7, 1), (64, 12345),
                                          (121, 0x51633E2D), (1000, 2 ** 32 - 1)])
def test_permute_kensler_matches_jax(samples, seed):
    idx = np.arange(3 * max(samples, 2)).astype(np.int32)
    want = np.asarray(jsamplers.permute_kensler(jnp.asarray(idx), samples, seed))
    got = samplers.permute_kensler(torch.from_numpy(idx), samples, seed)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # in range; the fixed number of rounds makes no promise of a permutation
    assert ((0 <= got) & (got < max(samples, 1))).all()


@pytest.mark.parametrize("jitter", [True, False])
def test_orthogonal_sampler_matches_jax(jitter, replay):
    # seed 0: from seed 1 on, dim 1's permutation seed leaves 32 bits too
    js = jsamplers.OrthogonalSampler(20, jitter=jitter)
    s = samplers.OrthogonalSampler(20, jitter=jitter)
    assert s.resolution == js.resolution == 5 and s.sample_count == 25
    key, draws = jax.random.PRNGKey(0), []
    for _ in range(2 if jitter else 0):
        key, sub = jax.random.split(key)
        draws.append(uniform(sub, (25,)))
    want = np.asarray(js.next_2d(25))
    replay(draws)
    got = s.next_2d(25)
    _close(got, want, "next_2d", rtol=1e-6)
    # stratified: each row and each column of the 5 x 5 grid holds one sample
    cells = np.floor(got.numpy() * 5).astype(int)
    assert len({tuple(c) for c in cells}) == 25


def test_orthogonal_samplers_third_dimension_overflows_in_both_packages():
    """The permutation seed of dim 2, ``2 * 3 * 0x68BC21EB``, leaves 32 bits:
    the JAX package raises there, and so does the port."""
    js = jsamplers.OrthogonalSampler(16)
    s = samplers.OrthogonalSampler(16)
    for sampler in (js, s):
        sampler.next_1d(8)
        sampler.next_1d(8)
        with pytest.raises(OverflowError, match="5271479745"):
            sampler.next_1d(8)


def test_sampler_draws_through_the_draw_function(replay):
    replay([np.full((2, 3), 0.25, np.float32)])
    assert torch.equal(samplers.Sampler(seed=1).sample((2, 3)), torch.full((2, 3), 0.25))


# ---- GlobalNeuralBSDF and NeuralApprox ------------------------------------------------------

def _global_pair():
    jb = JGlobal()
    tree = _tree(jb, seed=20)
    tree["dist"] = _estimator_tree(dists=32, seed=21)
    return jb, tree, load_jax_params(GlobalNeuralBSDF(), tree, device="cpu")


def test_global_neural_bsdf_eval_and_pdf_matches_jax():
    jb, tree, tb = _global_pair()
    jit, it, wo, active = _interactions()
    w = np.random.default_rng(22).normal(size=(len(wo), 4)).astype(np.float32)

    def jfn(params):
        s, pdf, _ = jb.eval_and_pdf(params, jit, jnp.asarray(wo))
        return jnp.sum(s * w[:, :3]) + jnp.sum(pdf * w[:, 3]), (s, pdf)

    (_, (js, jpdf)), jg = jax.value_and_grad(jfn, has_aux=True)(_params(tree))
    s, pdf, _ = tb.eval_and_pdf(it, torch.from_numpy(wo))
    (torch.sum(s * torch.from_numpy(w[:, :3])) + torch.sum(pdf * torch.from_numpy(w[:, 3]))
     ).backward()
    _close(s, js, "spectrum", rtol=1e-5)
    _close(pdf, jpdf, "pdf", rtol=1e-5)
    _close_grads(tb, jg, "GlobalNeuralBSDF")


def test_global_neural_bsdf_sample_matches_jax(replay_normals):
    jb, tree, tb = _global_pair()
    jit, it, _, _ = _interactions()
    key = jax.random.PRNGKey(23)
    jbs, jspec = jb.sample(_params(tree), jit, key)
    replay_normals([jax.random.normal(key, (len(it.p), 32, 2))])
    bs, spec = tb.sample(it, GEN)
    _close(bs.wo, jbs.wo, "wo", rtol=1e-5)
    _close(bs.pdf, jbs.pdf, "pdf", rtol=1e-5)
    _close(spec, jspec, "spectrum", rtol=1e-5)


def test_neural_approx_render_matches_jax():
    """On the reduced NeRV scene (its learned occlusion is switched off
    inside): the values at the hits and the gradients to the surface and the
    integrator's net."""
    jscene, tree, scene = nerv_pair(max_steps=32)
    jint, integrator = JNeuralApprox(), NeuralApprox()
    kw = dict(num_layers=3, hidden_size=32, freqs=4, sigma=2.0)
    jint.mlp = jmlp.TwoStageMLP(in_1=3, in_2=3, intermediate=1, out=3, **kw)
    integrator.mlp = mlp.TwoStageMLP(in_1=3, in_2=3, intermediate=1, out=3, **kw)
    tree = dict(tree, integrator=_tree(jint.mlp, seed=24))
    load_jax_params(integrator.mlp, tree["integrator"], device="cpu")
    rays = _camera_rays()
    w = np.random.default_rng(25).normal(size=rays.shape[:-1] + (3,)).astype(np.float32)

    def jfn(params):
        v, a, _ = jint.sample(jscene, params, jnp.asarray(rays), key=None, training=False)
        return jnp.sum(v * w), (v, a)

    (_, (want, jhit)), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(_params(tree))
    got, hit, it = integrator.sample(scene, torch.from_numpy(rays))
    _compare(got.detach().numpy(), hit.numpy(), np.asarray(want), np.asarray(jhit),
             "NeuralApprox")
    assert integrator.dims() == 3 and (got[~hit] == 0).all()
    torch.sum(got * torch.from_numpy(w)).backward()
    l2 = {c: _rel_l2(scene, jg, c) for c in ("shape", "lights")}
    l2["integrator"] = _rel_l2(torch.nn.ModuleDict({"integrator": integrator.mlp}), jg,
                               "integrator")
    assert all(e <= 1e-4 for e in l2.values()), l2
    assert np.abs(_flat(jg)["shape.centers"]).max() > 0
