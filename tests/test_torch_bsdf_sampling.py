"""Port parity: the BSDF samplers and the rest of the BSDF set
(``Diffuse``, ``Conductor``, ``NeuralBSDF``, ``ComposeSpatialVarying``,
``Phong``, ``Plastic``, ``Bidirectional``, ``Compose``, ``SelectBSDF``), the
Gumbel pick, the draw function, ``Constant``, the delta lights' misses and
``mis_weight``; and the replay of the JAX package's uniforms that
``test_torch_path`` shares.

The port draws every uniform through ``ops.sampling.uniform``.  The tests
replace it with a replay of the uniforms the JAX function draws from its
key, in call order (the ``replay`` fixture), re-deriving the JAX key tree
here (``bsdf_draws``): a mixture splits K+1 keys, one a lobe and the last
for the Gumbel pick (``bsdfs.py:377-380``), Plastic and Bidirectional two.
Seeded numpy inputs and the JAX params (``load_jax_params``) go through both
packages; the neural lobes are 2 layers of 16.

Tolerances: values, pdfs, directions, ``Constant`` and ``mis_weight`` rtol
1e-5 and atol 1e-6 of the largest value (float32 in another order);
gradients rtol 1e-4 and atol 1e-5 of the largest; the Gumbel pick exactly;
Conductor's 0.94 threshold compared ray by ray as ``test_torch_colocate``
does (at most 1% of the flags differ, values where they agree).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_raytracing_tpu.bsdf.bsdfs as jbsdfs
import neural_raytracing_tpu.integrators as JI
from neural_raytracing_tpu.interaction import Interaction as JInteraction
from neural_raytracing_tpu.lights import Constant as JConstant
from neural_raytracing_tpu.lights import LightField as JLightField
from neural_raytracing_tpu.nn import SkipConnMLP as JMLP
import neural_raytracing_tpu_torch.integrators as I
from neural_raytracing_tpu_torch import bsdf as B
from neural_raytracing_tpu_torch.bsdf.bsdfs import gumbel_argmax
from neural_raytracing_tpu_torch.interaction import Interaction
from neural_raytracing_tpu_torch.lights import Constant, LightField, PointLights
from neural_raytracing_tpu_torch.nn import SkipConnMLP
from neural_raytracing_tpu_torch.ops import sampling
from neural_raytracing_tpu_torch.params import load_jax_params, state_dict_from_jax

torch.set_num_threads(1)
GEN = torch.Generator()          # handed to the samplers; the replay draws instead
LOBE = dict(in_size=3, out=3, num_layers=2, hidden_size=16, freqs=4)


# ---- the replay ------------------------------------------------------------------------

class Replay:
    """``sampling.uniform`` replaced by the JAX uniforms, in call order."""

    def __init__(self, arrays):
        self.arrays = [np.array(a, np.float32) for a in arrays]

    def __call__(self, generator, shape, device, minval=0.0):
        assert self.arrays, "the port drew more uniforms than the JAX function"
        a = self.arrays.pop(0)
        assert a.shape == tuple(shape), (a.shape, tuple(shape))
        return torch.from_numpy(a).to(device)


@pytest.fixture
def replay(monkeypatch):
    """``replay(arrays)`` pins the port's next draws; each must be used."""
    made = []

    def pin(arrays):
        made.append(Replay(arrays))
        monkeypatch.setattr(sampling, "uniform", made[-1])
        return made[-1]

    yield pin
    assert all(not r.arrays for r in made), "the port drew fewer uniforms than JAX"


def uniform(key, shape, minval=0.0):
    return np.asarray(jax.random.uniform(key, shape, minval=minval, maxval=1.0))


def bsdf_draws(jb, key, batch) -> list:
    """The uniforms the JAX ``jb.sample`` draws from ``key``, in order."""
    if isinstance(jb, (jbsdfs.Diffuse, jbsdfs.NeuralBSDF, jbsdfs.Phong)):
        return [uniform(key, batch + (2,))]
    if isinstance(jb, jbsdfs.Conductor):
        return []
    if isinstance(jb, jbsdfs.Plastic):
        k1, k2 = jax.random.split(key)
        return [uniform(k1, batch), uniform(k2, batch + (2,))]
    if isinstance(jb, jbsdfs.Bidirectional):
        k1, k2 = jax.random.split(key)
        return bsdf_draws(jb.front, k1, batch) + bsdf_draws(jb.back, k2, batch)
    n = len(jb.bsdfs)
    mixture = isinstance(jb, (jbsdfs.Compose, jbsdfs.ComposeSpatialVarying))
    keys = jax.random.split(key, n + 1 if mixture else n)
    out = [u for b, k in zip(jb.bsdfs, keys) for u in bsdf_draws(b, k, batch)]
    return out + ([uniform(keys[-1], batch + (n,), minval=1e-10)] if mixture else [])


def _close(got, want, what, rtol=1e-5, scale=1e-6):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    atol = scale * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _flat(tree):
    return {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree.map(np.asarray, tree)).items()}


def _close_grads(module, jgrads, what, rtol=1e-4, scale=1e-5):
    """Each leaf's gradient against JAX's (a leaf no gradient reaches: zero)."""
    named = dict(module.named_parameters())
    flat = _flat(jgrads)
    assert set(named) <= set(flat), set(named) - set(flat)
    for k, p in named.items():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        assert torch.isfinite(g).all(), k
        _close(g, flat[k], f"{what}: {k}", rtol=rtol, scale=scale)


def _rel_l2(module, jgrads, component):
    named = dict(module.named_parameters())
    flat = _flat(jgrads)
    keys = [k for k in named if k.startswith(component + ".")]
    got = np.concatenate([(named[k].grad if named[k].grad is not None
                           else torch.zeros_like(named[k])).numpy().ravel() for k in keys])
    want = np.concatenate([flat[k].ravel() for k in keys])
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# ---- the BSDFs -------------------------------------------------------------------------

def _selector(lib):
    if lib == "jax":
        return lambda p: (p[..., 0] > 0).astype(jnp.int32)
    return lambda p: (p[..., 0] > 0).long()


def _bsdf(lib, kind):
    """The BSDF ``kind`` from the JAX package ("jax") or the port."""
    m = jbsdfs if lib == "jax" else B
    mlp = (lambda **kw: JMLP(**kw)) if lib == "jax" else (lambda **kw: SkipConnMLP(**kw))
    neural = lambda: m.NeuralBSDF("softplus", mlp=mlp(**LOBE))
    return {
        "diffuse": lambda: m.Diffuse((0.6, 0.3, 0.2)),
        "conductor": lambda: m.Conductor(),
        "neural": neural,
        "spatial": lambda: m.ComposeSpatialVarying(
            [neural(), m.Diffuse(), m.Conductor()],
            sp_var_fn=mlp(in_size=3, out=3, num_layers=2, hidden_size=16, freqs=4,
                          init="xavier")),
        "phong": lambda: m.Phong(),
        "plastic": lambda: m.Plastic(),
        "bidirectional": lambda: m.Bidirectional(m.Phong(), m.Diffuse((0.2, 0.7, 0.4))),
        "shared": lambda: m.Bidirectional(m.Diffuse((0.2, 0.7, 0.4))),
        "compose": lambda: m.Compose([m.Diffuse((1.0, 0.0, 0.0)), m.Plastic(),
                                      m.Conductor()]),
        "select": lambda: m.SelectBSDF(_selector(lib), [m.Diffuse((1.0, 0.0, 0.0)),
                                                        m.Conductor()]),
    }[kind]()


KINDS = ["diffuse", "conductor", "neural", "spatial", "phong", "plastic",
         "bidirectional", "shared", "compose", "select"]


def _bsdf_pair(kind, seed=0):
    jb = _bsdf("jax", kind)
    tree = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(seed)))
    if kind == "phong":
        tree["shine"] = np.float32(2.0)          # an exponent of 1 + e^2
    return jb, tree, load_jax_params(_bsdf("torch", kind), tree, device="cpu")


def _interaction_inputs(n=256, seed=3):
    """p, normals, wi (a fifth below the horizon), wo (a sixth below), active."""
    rng = np.random.default_rng(seed)
    unit = lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True)
    normals = unit(rng.normal(size=(n, 3)))
    wi = rng.normal(size=(n, 3))
    wi[:, 2] = np.abs(wi[:, 2]) * np.where(rng.uniform(size=n) < 0.8, 1.0, -1.0)
    wo = rng.normal(size=(n, 3))
    wo[:, 2] = np.abs(wo[:, 2]) * np.where(rng.uniform(size=n) < 0.83, 1.0, -1.0)
    f = lambda a: a.astype(np.float32)
    return (f(rng.normal(size=(n, 3))), f(normals), f(unit(wi)), f(unit(wo)),
            rng.uniform(size=n) > 0.2)


def _interactions(n=256, seed=3):
    p, normals, wi, wo, active = _interaction_inputs(n, seed)
    jit = JInteraction(p=jnp.asarray(p), t=jnp.zeros(n)).with_normals(jnp.asarray(normals))
    jit = jit._replace(wi=jnp.asarray(wi))
    it = Interaction(p=torch.from_numpy(p), t=torch.zeros(n)).with_normals(
        torch.from_numpy(normals))
    it = it._replace(wi=torch.from_numpy(wi))
    return jit, it, wo, active


def _flags_agree(kind, got_pdf, want_pdf):
    """Conductor's threshold is a hard step: compare its flags ray by ray."""
    if kind != "conductor":
        return np.ones(len(want_pdf), bool)
    flags, jflags = got_pdf > 0, np.asarray(want_pdf) > 0
    assert (flags != jflags).mean() <= 0.01
    return flags == jflags


@pytest.mark.parametrize("kind", KINDS)
def test_bsdf_eval_and_pdf_matches_jax(kind):
    jb, tree, tb = _bsdf_pair(kind)
    jit, it, wo, active = _interactions()
    w = np.random.default_rng(4).normal(size=(len(wo), 4)).astype(np.float32)

    def jfn(params):
        s, p, _ = jb.eval_and_pdf(params, jit, jnp.asarray(wo), jnp.asarray(active))
        return jnp.sum(s * w[:, :3]) + jnp.sum(p * w[:, 3]), (s, p)

    (_, (jspec, jpdf)), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    spec, pdf, aux = tb.eval_and_pdf(it, torch.from_numpy(wo), torch.from_numpy(active))
    keep = _flags_agree(kind, pdf.detach().numpy(), jpdf)
    _close(spec[keep], np.asarray(jspec)[keep], "spectrum")
    _close(pdf[keep], np.asarray(jpdf)[keep], "pdf")
    wk = torch.from_numpy(w * keep[:, None])
    (torch.sum(spec * wk[:, :3]) + torch.sum(pdf * wk[:, 3])).backward()
    if kind != "conductor":
        _close_grads(tb, jg, kind)
    if kind == "spatial":
        assert aux["normalized_weights"].shape == (len(wo), 3)


@pytest.mark.parametrize("kind", KINDS)
def test_bsdf_sample_matches_jax_under_replayed_uniforms(kind, replay):
    jb, tree, tb = _bsdf_pair(kind)
    jit, it, _, active = _interactions()
    key = jax.random.PRNGKey(11)
    w = np.random.default_rng(5).normal(size=(len(active), 7)).astype(np.float32)

    def jfn(params):
        bs, s = jb.sample(params, jit, key, jnp.asarray(active))
        return (jnp.sum(bs.wo * w[:, :3]) + jnp.sum(bs.pdf * w[:, 3])
                + jnp.sum(s * w[:, 4:])), (bs, s)

    (_, (jbs, jspec)), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    replay(bsdf_draws(jb, key, (len(active),)))
    bs, spec = tb.sample(it, GEN, torch.from_numpy(active))
    _close(bs.wo, jbs.wo, "wo")
    _close(bs.pdf, jbs.pdf, "pdf")
    _close(spec, jspec, "spectrum")
    wt = torch.from_numpy(w)
    (torch.sum(bs.wo * wt[:, :3]) + torch.sum(bs.pdf * wt[:, 3])
     + torch.sum(spec * wt[:, 4:])).backward()
    _close_grads(tb, jg, kind)


def test_gumbel_argmax_picks_as_jax(replay):
    rng = np.random.default_rng(8)
    w = 1.0 / (1.0 + np.exp(-2.0 * rng.normal(size=(4096, 7))))
    w[:64, 3] = 0.0                                  # under the 1e-20 clamp
    w = w.astype(np.float32)
    key = jax.random.PRNGKey(2)
    want = np.asarray(jbsdfs._gumbel_argmax(key, jnp.asarray(w)))
    replay([uniform(key, w.shape, minval=1e-10)])
    got = gumbel_argmax(GEN, torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == 7 and not (got[:64] == 3).any()


def test_draw_function_scales_and_clamps_as_jax():
    u = sampling.uniform(torch.Generator().manual_seed(0), (4096, 3), "cpu", minval=1e-10)
    assert u.dtype == torch.float32 and u.shape == (4096, 3)
    assert (u >= 1e-10).all() and (u < 1.0).all()
    a = sampling.uniform(torch.Generator().manual_seed(5), (8,), "cpu")
    b = torch.rand(8, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)            # the generator's own stream
    with pytest.raises(ValueError, match="Generator"):
        sampling.uniform(None, (2,), "cpu")


def test_neural_bsdf_zero_and_new_leaves_load_strictly():
    _, it, wo, _ = _interactions(16)
    lobe = B.NeuralBSDF(mlp=SkipConnMLP(**LOBE)).zero()
    spec, pdf, _ = lobe.eval_and_pdf(it, torch.from_numpy(wo))
    assert not spec.any() and (pdf == 1).all()
    bs, s = lobe.sample(it, torch.Generator().manual_seed(0))
    assert not s.any() and (bs.wo[:, 2] > 0).all()
    for kind, leaves in (("phong", {"diffuse", "specular", "shine"}),
                         ("plastic", {"diffuse", "specular"}),
                         ("shared", {"front.reflectance", "back.reflectance"}),
                         ("compose", {"weights", "bsdfs.0.reflectance",
                                      "bsdfs.1.diffuse", "bsdfs.1.specular",
                                      "bsdfs.2.specular", "bsdfs.2.eta", "bsdfs.2.k"})):
        jb, tree, tb = _bsdf_pair(kind)
        assert set(dict(tb.named_parameters())) == leaves == set(_flat(tree))
        bad = dict(tree)
        bad.pop(sorted(tree)[0])
        with pytest.raises(RuntimeError):
            load_jax_params(_bsdf("torch", kind), bad, device="cpu")


def test_shared_bidirectional_parts_after_one_adamw_step():
    """JAX hands a shared Bidirectional's front and back one initial value as
    two leaves, each with its own gradient: they part after one step."""
    import optax
    jb, tree, tb = _bsdf_pair("shared")
    assert tb.front is not tb.back
    assert torch.equal(tb.front.reflectance, tb.back.reflectance)
    jit, it, wo, active = _interactions()
    w = np.random.default_rng(9).normal(size=(len(wo), 3)).astype(np.float32)
    opt = optax.adamw(1e-2)
    params = jax.tree.map(jnp.asarray, tree)
    g = jax.grad(lambda p: jnp.sum(jb.eval_and_pdf(p, jit, jnp.asarray(wo),
                                                   jnp.asarray(active))[0] * w))(params)
    upd, _ = opt.update(g, opt.init(params), params)
    jnew = optax.apply_updates(params, upd)
    torch_opt = torch.optim.AdamW(tb.parameters(), lr=1e-2, weight_decay=1e-4)
    spec, _, _ = tb.eval_and_pdf(it, torch.from_numpy(wo), torch.from_numpy(active))
    torch.sum(spec * torch.from_numpy(w)).backward()
    torch_opt.step()
    assert not np.allclose(jnew["front"]["reflectance"], jnew["back"]["reflectance"])
    assert not torch.equal(tb.front.reflectance, tb.back.reflectance)
    for side in ("front", "back"):
        _close(getattr(tb, side).reflectance, jnew[side]["reflectance"], side)
    # a reset gives the back the front's values again
    tb.reset_parameters(torch.Generator())
    assert torch.equal(tb.front.reflectance, tb.back.reflectance)


# ---- lights and mis_weight -------------------------------------------------------------

def _rays_from_inside(n=256, seed=12):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o *= (rng.uniform(0.0, 6.0, size=(n, 1)) / np.linalg.norm(o, axis=-1, keepdims=True))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d], -1).astype(np.float32)


def test_constant_light_matches_jax(replay):
    rng = np.random.default_rng(6)
    p = rng.normal(size=(3, 40, 3)).astype(np.float32)
    active = rng.uniform(size=(3, 40)) > 0.3
    jl, tl = JConstant(radius=5.0, intensity=0.5), Constant(radius=5.0, intensity=0.5)
    tree = {"intensity": np.float32(0.7)}
    load_jax_params(tl, tree, device="cpu")
    key = jax.random.PRNGKey(4)

    def jfn(params):
        ds, s = jl.sample_direction(params, JInteraction(p=jnp.asarray(p), t=p[..., 0]), key,
                                    jnp.asarray(active))
        return jnp.sum(s), (ds, s)

    (_, (jds, jspec)), jg = jax.value_and_grad(jfn, has_aux=True)(
        jax.tree.map(jnp.asarray, tree))
    replay([uniform(key, (3, 40, 2))])
    ds, spec = tl.sample_direction(Interaction(p=torch.from_numpy(p), t=None), GEN,
                                   torch.from_numpy(active))
    assert ds.delta is False and tl.delta is False
    for name in ("d", "pdf", "dist", "p", "n"):
        _close(getattr(ds, name), getattr(jds, name), name)
    _close(spec, jspec, "spectrum")
    spec.sum().backward()
    _close(tl.intensity.grad, jg["intensity"], "intensity gradient")
    rays = _rays_from_inside()
    for got, want in zip(tl.intersect(torch.from_numpy(rays)),
                         jl.intersect(tree, jnp.asarray(rays))):
        _close(got.float(), np.asarray(want, np.float32), "intersect")
    t, hit = tl.intersect(torch.from_numpy(rays))
    inside = np.linalg.norm(rays[:, :3], axis=-1) < 5.0
    assert hit[inside].all() and not hit.all() and (t[inside] < 10.0).all()
    for got, want in zip(tl.eval_pdf(torch.from_numpy(rays)), jl.eval_pdf(tree, rays)):
        _close(got, want, "eval_pdf")
    with pytest.raises(ValueError, match="generator"):
        tl.sample_direction(Interaction(p=torch.from_numpy(p), t=None))


@pytest.mark.parametrize("light", ["point", "field"])
def test_delta_lights_are_never_hit(light):
    rays = torch.from_numpy(_rays_from_inside(32))
    tl = PointLights() if light == "point" else LightField(mlp=SkipConnMLP(**LOBE))
    t, hit = tl.intersect(rays)
    emit, pdf = tl.eval_pdf(rays)
    assert tl.delta and not hit.any() and not t.any() and not emit.any() and not pdf.any()
    assert emit.shape == (32, 3) and pdf.shape == (32,)
    jl = JLightField(mlp=JMLP(**LOBE))
    assert not np.asarray(jl.intersect({}, jnp.asarray(rays.numpy()))[1]).any()


def test_mis_weight_matches_jax():
    rng = np.random.default_rng(7)
    a = rng.uniform(-0.5, 2.0, size=512).astype(np.float32)
    b = rng.uniform(-0.5, 2.0, size=512).astype(np.float32)
    a[:8], b[8:16] = 0.0, 0.0
    b[16:24] = 1e-4                                   # under the 1e-7 clamp of b^2
    jfn = lambda x, y: jnp.sum(JI.mis_weight(x, y) * jnp.arange(512.0))
    want = np.asarray(JI.mis_weight(jnp.asarray(a), jnp.asarray(b)))
    ja, jb_ = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    at, bt = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    got = I.mis_weight(at, bt)
    torch.sum(got * torch.arange(512.0)).backward()
    _close(got, want, "mis_weight")
    _close(at.grad, ja, "d/da", rtol=1e-4, scale=1e-5)
    _close(bt.grad, jb_, "d/db", rtol=1e-4, scale=1e-5)
