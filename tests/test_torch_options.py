"""Port parity: the options of the JAX package that the port takes as it
does — ``Conductor(activation=, threshold=)``,
``ComposeSpatialVarying(preprocess=)``, ``look_at_view_transform(eye=)``,
``train(step_fn=)``, ``random_on_sphere(dtype=)`` and the default
``past_light_exit`` of K4's plain version.

Seeded numpy inputs go through the JAX function and its port at small
widths.  Tolerances:
  * ``Conductor``: its cone ``local_reflect(wi) . wo > threshold`` is a hard
    step, so the flags are compared ray by ray and may differ only where the
    float64 product lies within 1e-6 of the threshold (a sum in another
    order); values and the gradients to ``specular`` and ``eta`` on the rays
    whose flags agree, rtol 1e-5 and 1e-5 of the largest (as
    ``test_torch_colocate``).  ``sample`` draws nothing: rtol 1e-5 and 1e-6
    of the largest.  The defaults equal the explicit ``("sigmoid", 0.94)``
    and the lobe's formula with ``torch.sigmoid`` and 0.94 bit for bit.
  * ``ComposeSpatialVarying.normalized_weights`` through a fused weight net
    (its plain version on CPU tensors; 4 layers x 16, 4 frequencies at sigma
    128, the reduced flagship's) under a non-identity ``preprocess``, at
    ``test_torch_mlp``'s tolerances: the weights and logits rtol 1e-4, atol
    1e-5; the gradient to the points rtol 1e-4, atol 1e-5 times max|B| (each
    derivative through the Fourier encoding multiplies by an entry of B, and
    float32 sums in another order cancel terms of that size).  The mixture's
    ``eval_and_pdf`` under it rtol 1e-5 and 1e-5 of the largest, where the
    conductor's flags agree.
  * ``look_at_view_transform(eye=)``: atol 1e-6 against JAX and against the
    dist/elev/azim form at the same centres.
  * ``train(step_fn=)``: 3 steps of the reduced flagship of
    ``test_torch_training`` (the JAX SDF's throughput keyless, as
    ``test_torch_train_step`` has it); the losses rtol 1e-5 against JAX's
    ``train(step_fn=make_train_step(...))`` and bit for bit against the
    port's own ``train`` without ``step_fn``.
  * ``random_on_sphere(dtype=float64)`` against JAX with x64 on, the JAX
    uniforms replayed into the port: the draws exactly, the directions atol
    1e-12, the types exactly.  In float16 the port is held to its own draw
    (unit directions within 4e-3, four float16 ulps at 1): XLA runs a
    float16 chain in float32 between the ops and torch rounds after each,
    which ``arccos`` near +-1 magnifies.
  * ``shadow_march_plain`` with its default flag: the not-blocked flags bit
    for bit against the JAX kernel in interpret mode with its default.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_raytracing_tpu.kernels.fused_march as jfm
import neural_raytracing_tpu.ops.warps as jwarps
import neural_raytracing_tpu.training as JT
from neural_raytracing_tpu.bsdf import ComposeSpatialVarying as JCompose
from neural_raytracing_tpu.bsdf import Conductor as JConductor
from neural_raytracing_tpu.bsdf import Diffuse as JDiffuse
from neural_raytracing_tpu.cameras import NeRFCamera as JNeRF
from neural_raytracing_tpu.cameras import look_at_view_transform as j_look_at
from neural_raytracing_tpu.integrators import Direct as JDirect
from neural_raytracing_tpu.interaction import Interaction as JInteraction
from neural_raytracing_tpu.kernels import FusedSkipConnMLP as JFused
from neural_raytracing_tpu.shapes import SDF as JSDF
import neural_raytracing_tpu_torch.training as T
from neural_raytracing_tpu_torch.bsdf import ComposeSpatialVarying, Conductor, Diffuse
from neural_raytracing_tpu_torch.cameras import NeRFCamera, look_at_view_transform
from neural_raytracing_tpu_torch.integrators import Direct
from neural_raytracing_tpu_torch.interaction import Interaction
from neural_raytracing_tpu_torch.kernels import FusedSkipConnMLP, shadow_march_plain
from neural_raytracing_tpu_torch.ops import sampling
from neural_raytracing_tpu_torch.ops.math import local_reflect
from neural_raytracing_tpu_torch.ops.warps import random_on_sphere
from neural_raytracing_tpu_torch.params import load_jax_params
from test_torch_colocate import BSDF_PARAMS, _close
from test_torch_occlusion import _shadow_rays, nerv_pair
from test_torch_params import NETS, scene_pair
from test_torch_training import C2W, FOCAL, LRS, SIZE, _gt

torch.set_num_threads(1)

# ---- Conductor(activation=, threshold=) --------------------------------------------------

def _conductor_case(threshold, n=768, seed=21):
    """wi with some rays below the horizon; wo at a cosine to
    local_reflect(wi) spread over [threshold - 0.2, 1] (some within 1e-7 of
    the threshold), random on the rest.  -> (p, wi, wo, active, dot in
    float64)."""
    rng = np.random.default_rng(seed)
    wi = rng.normal(size=(n, 3))
    wi[:, 2] = np.abs(wi[:, 2]) * np.where(rng.uniform(size=n) < 0.8, 1.0, -0.3)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    refl = wi * [-1.0, -1.0, 1.0]
    perp = np.cross(refl, rng.normal(size=(n, 3)))
    perp /= np.linalg.norm(perp, axis=-1, keepdims=True)
    c = rng.uniform(threshold - 0.2, 1.0, size=n)
    c[:16] = threshold + rng.uniform(-1e-7, 1e-7, size=16)
    wo = c[:, None] * refl + np.sqrt(1.0 - c * c)[:, None] * perp
    wo[-64:] = rng.normal(size=(64, 3))
    wo[-64:] /= np.linalg.norm(wo[-64:], axis=-1, keepdims=True)
    wi, wo = wi.astype(np.float32), wo.astype(np.float32)
    dot = np.sum(wi.astype(np.float64) * [-1.0, -1.0, 1.0] * wo, -1)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    return p, wi, wo, rng.uniform(size=n) > 0.2, dot


def _conductor_pair(activation, threshold):
    tree = BSDF_PARAMS["conductor"]
    jb = JConductor(activation=activation, threshold=threshold)
    tb = load_jax_params(Conductor(activation=activation, threshold=threshold), tree,
                         device="cpu")
    return jb, jax.tree.map(jnp.asarray, tree), tb


@pytest.mark.parametrize("threshold", [0.94, 0.9, 0.5])
@pytest.mark.parametrize("activation", ["sigmoid", "softplus", "identity"])
def test_conductor_eval_and_pdf_matches_jax(activation, threshold):
    p, wi, wo, active, dot = _conductor_case(threshold)
    jb, jtree, tb = _conductor_pair(activation, threshold)
    jit = JInteraction(p=jnp.asarray(p), t=jnp.zeros(len(p)), wi=jnp.asarray(wi))
    jspec, jpdf, _ = jb.eval_and_pdf(jtree, jit, jnp.asarray(wo), jnp.asarray(active))
    jspec, jpdf = np.asarray(jspec), np.asarray(jpdf)
    it = Interaction(p=torch.from_numpy(p), t=torch.zeros(len(p)), wi=torch.from_numpy(wi))
    spec, pdf, aux = tb.eval_and_pdf(it, torch.from_numpy(wo), torch.from_numpy(active))
    assert aux == {}
    flags, jflags = pdf.numpy() > 0, jpdf > 0
    assert 0.1 < jflags.mean() < 0.9                       # both sides of the threshold
    assert (np.abs(dot[flags != jflags] - threshold) < 1e-6).all()
    keep = flags == jflags
    _close(spec.detach().numpy()[keep], jspec[keep], "spectrum", scale=1e-5)
    _close(pdf.numpy()[keep], jpdf[keep], "pdf")
    # the gradients of a loss over the rays whose flags agree
    w = np.random.default_rng(6).normal(size=(len(p), 3)).astype(np.float32) * keep[:, None]
    torch.sum(spec * torch.from_numpy(w)).backward()

    def jfn(params):
        s, _, _ = jb.eval_and_pdf(params, jit, jnp.asarray(wo), jnp.asarray(active))
        return jnp.sum(s * w)

    jg = jax.grad(jfn)(jtree)
    for name in ("specular", "eta"):
        assert np.abs(jg[name]).max() > 0, name
        _close(getattr(tb, name).grad.numpy(), jg[name], name, scale=1e-5)


@pytest.mark.parametrize("threshold", [0.94, 0.9, 0.5])
@pytest.mark.parametrize("activation", ["sigmoid", "softplus", "identity"])
def test_conductor_sample_matches_jax(activation, threshold):
    """``sample`` reflects wi and reads ``specular`` raw, whatever the
    activation and threshold (as the JAX ``sample``)."""
    p, wi, _, active, _ = _conductor_case(threshold)
    jb, jtree, tb = _conductor_pair(activation, threshold)
    jit = JInteraction(p=jnp.asarray(p), t=jnp.zeros(len(p)), wi=jnp.asarray(wi))
    jbs, jspec = jb.sample(jtree, jit, jax.random.PRNGKey(0), jnp.asarray(active))
    it = Interaction(p=torch.from_numpy(p), t=torch.zeros(len(p)), wi=torch.from_numpy(wi))
    bs, spec = tb.sample(it, torch.Generator(), torch.from_numpy(active))
    _close(bs.wo.numpy(), jbs.wo, "wo")
    _close(bs.pdf.numpy(), jbs.pdf, "pdf")
    _close(spec.detach().numpy(), jspec, "spectrum")
    assert (np.asarray(jspec) < 0).any()                   # the raw specular (0.3, -0.5, 1.2)


def test_conductor_defaults_are_the_sigmoid_lobe_at_0_94():
    """``Conductor()`` is ``Conductor("sigmoid", 0.94)`` and the lobe's
    formula with ``torch.sigmoid`` and 0.94, bit for bit."""
    p, wi, wo, active, _ = _conductor_case(0.94)
    it = Interaction(p=torch.from_numpy(p), t=torch.zeros(len(p)), wi=torch.from_numpy(wi))
    tree = BSDF_PARAMS["conductor"]
    outs = []
    for b in (Conductor(), Conductor(activation="sigmoid", threshold=0.94)):
        b = load_jax_params(b, tree, device="cpu")
        spec, pdf, _ = b.eval_and_pdf(it, torch.from_numpy(wo), torch.from_numpy(active))
        outs.append((spec.detach(), pdf))
        assert b.threshold == 0.94
    from neural_raytracing_tpu_torch.ops.fresnel import fresnel_conductor
    b = load_jax_params(Conductor(), tree, device="cpu")
    with torch.no_grad():
        thresh = torch.sum(local_reflect(it.wi) * torch.from_numpy(wo), dim=-1) > 0.94
        fr = fresnel_conductor(it.wi[..., 2], torch.nn.functional.softplus(b.eta), 0.0)
        spec = torch.where(thresh[..., None], fr[..., None] * torch.sigmoid(b.specular), 0.0)
        spec = torch.where(torch.from_numpy(active)[..., None], spec, 0.0)
    for got, pdf in outs:
        assert torch.equal(got, spec) and torch.equal(pdf, torch.where(thresh, 1.0, 0.0))
    assert torch.equal(outs[0][0], outs[1][0]) and thresh.any() and (~thresh).any()


def test_conductor_takes_a_callable_activation():
    b = Conductor(activation=torch.tanh, threshold=0.5)
    assert b.act is torch.tanh and b.threshold == 0.5
    with pytest.raises(ValueError, match="unknown activation"):
        Conductor(activation="swish")


# ---- ComposeSpatialVarying(preprocess=) ---------------------------------------------------

WEIGHT_NET = dict(NETS["weight"], out=2)
AFFINE = np.asarray([[0.9, 0.2, -0.1], [0.0, 1.1, 0.3], [0.2, -0.4, 0.8]], np.float32)
PREPROCESS = {
    "affine": (lambda p: 0.5 * p @ jnp.asarray(AFFINE) + 0.1,
               lambda p: 0.5 * p @ torch.from_numpy(AFFINE) + 0.1),
    "sin": (lambda p: jnp.sin(3.0 * p), lambda p: torch.sin(3.0 * p)),
}


def _compose_pair(preprocess):
    jpre, pre = PREPROCESS[preprocess]
    jc = JCompose([JConductor(), JDiffuse()], sp_var_fn=JFused(**WEIGHT_NET), preprocess=jpre)
    tree = jax.tree.map(np.asarray, jc.init(jax.random.PRNGKey(3)))
    tc = load_jax_params(ComposeSpatialVarying(
        [Conductor(), Diffuse()], sp_var_fn=FusedSkipConnMLP(**WEIGHT_NET), preprocess=pre),
        tree, device="cpu")
    return jc, jax.tree.map(jnp.asarray, tree), tc


@pytest.mark.parametrize("preprocess", ["affine", "sin"])
def test_compose_preprocess_weights_and_point_gradients_match_jax(preprocess):
    jc, jtree, tc = _compose_pair(preprocess)
    p = np.random.default_rng(8).normal(size=(300, 3)).astype(np.float32) * 0.4
    w = np.random.default_rng(9).normal(size=(300, 2)).astype(np.float32)
    jk, jraw = jc.normalized_weights(jtree, jnp.asarray(p))
    jgrad = jax.grad(lambda x: jnp.sum(jc.normalized_weights(jtree, x)[0] * w))(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_()
    k, raw = tc.normalized_weights(pt)
    (g,) = torch.autograd.grad(torch.sum(k * torch.from_numpy(w)), pt)
    np.testing.assert_allclose(raw.detach().numpy(), jraw, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(k.detach().numpy(), jk, rtol=1e-4, atol=1e-5)
    assert np.abs(np.asarray(jgrad)).max() > 0
    scale = float(np.abs(jtree["sp_var_fn"]["B"]).max())
    np.testing.assert_allclose(g.numpy(), jgrad, rtol=1e-4, atol=1e-5 * scale)
    # the preprocess is read: the weights differ from the identity's
    plain = ComposeSpatialVarying([Conductor(), Diffuse()], sp_var_fn=tc.sp_var_fn)
    assert not torch.allclose(plain.normalized_weights(pt)[0], k)


def test_compose_preprocess_reaches_eval_and_pdf():
    """The mixture's spectrum and pdf read the preprocessed weights (the
    weights of ``normalized_weights``) in both packages."""
    jc, jtree, tc = _compose_pair("affine")
    p, wi, wo, active, _ = _conductor_case(0.5, n=256, seed=4)
    jit = JInteraction(p=jnp.asarray(p), t=jnp.zeros(len(p)), wi=jnp.asarray(wi))
    jspec, jpdf, jaux = jc.eval_and_pdf(jtree, jit, jnp.asarray(wo), jnp.asarray(active))
    it = Interaction(p=torch.from_numpy(p), t=torch.zeros(len(p)), wi=torch.from_numpy(wi))
    spec, pdf, aux = tc.eval_and_pdf(it, torch.from_numpy(wo), torch.from_numpy(active))
    _close(aux["normalized_weights"].detach().numpy(), jaux["normalized_weights"], "weights",
           scale=1e-5)
    dot = np.sum(wi.astype(np.float64) * [-1.0, -1.0, 1.0] * wo, -1)
    keep = np.abs(dot - 0.94) > 1e-6                       # the conductor's flags agree
    _close(spec.detach().numpy()[keep], np.asarray(jspec)[keep], "spectrum", scale=1e-5)
    _close(pdf.detach().numpy()[keep], np.asarray(jpdf)[keep], "pdf", scale=1e-5)


# ---- look_at_view_transform(eye=) ---------------------------------------------------------

EYES = np.asarray([[0.3, 1.2, 2.0], [-1.5, 0.4, 0.2], [0.1, -0.8, -1.7]], np.float32)


@pytest.mark.parametrize("at", [None, ((0.1, -0.2, 0.3),)])
@pytest.mark.parametrize("eye", ["one", "batch"])
def test_look_at_eye_matches_jax(eye, at):
    e = EYES[:1][0] if eye == "one" else EYES
    kw = {} if at is None else {"at": at}
    jr, jt = j_look_at(dist=7.0, elev=50.0, azim=10.0, eye=e, **kw)   # dist/elev/azim unread
    r, t = look_at_view_transform(dist=7.0, elev=50.0, azim=10.0, eye=e, device="cpu", **kw)
    assert r.shape == jr.shape == (len(np.atleast_2d(e)), 3, 3) and t.shape == jt.shape
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=1e-6)


def test_look_at_eye_equals_the_spherical_form():
    """An eye at the spherical position of (dist, elev, azim) about ``at``
    gives the spherical form's R and T."""
    from neural_raytracing_tpu_torch.cameras.cameras import camera_position_from_spherical_angles
    dist, elev, azim = [2.0, 3.5, 1.2], [10.0, -35.0, 80.0], [0.0, 120.0, -60.0]
    at = torch.tensor([[0.2, 0.1, -0.3]])
    eye = camera_position_from_spherical_angles(dist, elev, azim) + at
    r, t = look_at_view_transform(eye=eye, at=at)
    r0, t0 = look_at_view_transform(dist=dist, elev=elev, azim=azim, at=at)
    torch.testing.assert_close(r, r0, rtol=0, atol=1e-6)
    torch.testing.assert_close(t, t0, rtol=0, atol=1e-6)


# ---- train(step_fn=) ----------------------------------------------------------------------

CROP = 12


def _train_case():
    jscene, tree, scene = scene_pair(max_steps=16)
    for s in (jscene.shape, scene.shape):
        s.throughput_steps = 16
    js = jscene.shape
    js.throughput = lambda params, r_o, r_d, key=None: JSDF.throughput(
        js, params, r_o, r_d, key=None)
    img, mask = _gt()
    return jscene, tree, scene, img, mask


def _port_train(scene, img, mask, **kw):
    spec = T.make_optimizer(LRS)
    state = T.init_train_state(scene, spec, device="cpu")
    make_camera = lambda idxs: NeRFCamera(torch.from_numpy(C2W[np.asarray(idxs)]), FOCAL)
    if kw.pop("own_step", False):
        step = T.build_step_fn(scene, Direct(training=True), spec, size=SIZE, crop_size=CROP)
        calls = []

        def step_fn(*args):
            calls.append(len(args))
            return step(*args)

        kw["step_fn"] = step_fn
    state, losses = T.train(scene, Direct(training=True), spec, state, make_camera, img, mask,
                            None, size=SIZE, crop_size=CROP, iters=3, n_views=2,
                            log_every=0, log_fn=lambda *a: None, **kw)
    if "step_fn" in kw:
        assert calls == [6, 6, 6]
    return state, losses


@pytest.mark.parametrize("mesh", [False, True])
def test_train_with_a_step_fn_matches_jax(mesh):
    from neural_raytracing_tpu_torch.parallel import make_mesh
    jscene, tree, scene, img, mask = _train_case()
    jopt = JT.make_optimizer(LRS)
    jstep = JT.make_train_step(jscene, JDirect(training=True), jopt, donate=False,
                               size=SIZE, crop_size=CROP)
    jstate = JT.TrainState(jax.tree.map(jnp.asarray, tree), jopt.init(tree), jnp.int32(0))
    make_jcam = lambda idxs: JNeRF(cam_to_world=jnp.asarray(C2W[np.asarray(idxs)]),
                                   focal=FOCAL)
    _, want = JT.train(jscene, JDirect(training=True), jopt, jstate, make_jcam, img, mask,
                       jax.random.PRNGKey(0), size=SIZE, crop_size=CROP, iters=3, n_views=2,
                       log_every=0, log_fn=lambda *a: None, step_fn=jstep)
    kw = {"mesh": make_mesh(device="cpu")} if mesh else {}
    state, got = _port_train(scene, img, mask, own_step=True, **kw)
    assert state.step == 3 and len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _, _, plain, _, _ = _train_case()
    _, built = _port_train(plain, img, mask)
    assert got == built                                    # the same bits as the built step


def test_train_step_fn_with_device_data_raises():
    _, _, scene, img, mask = _train_case()
    spec = T.make_optimizer(LRS)
    state = T.init_train_state(scene, spec, device="cpu")
    with pytest.raises(ValueError, match="step_fn"):
        T.train(scene, Direct(training=True), spec, state, None, img, mask, size=SIZE,
                crop_size=CROP, iters=1, device_data={}, camera_builder=lambda c: c,
                step_fn=lambda *a: None)


# ---- random_on_sphere(dtype=) -------------------------------------------------------------

class _Uniforms:
    """``sampling.uniform`` replaced by one array, in the type asked for."""

    def __init__(self, array):
        self.array, self.dtypes = array, []

    def __call__(self, generator, shape, device, minval=0.0, batch_axis=None,
                 dtype=torch.float32):
        assert self.array.shape == tuple(shape) and minval == 0.0
        self.dtypes.append(dtype)
        return torch.from_numpy(np.array(self.array)).to(device)


def test_random_on_sphere_float64_matches_jax(monkeypatch):
    with jax.enable_x64(True):
        jd, juv = jwarps.random_on_sphere(jax.random.PRNGKey(5), 257, dtype=jnp.float64)
        jd, juv = np.asarray(jd), np.asarray(juv)
    assert jd.dtype == juv.dtype == np.float64
    fake = _Uniforms(juv)
    monkeypatch.setattr(sampling, "uniform", fake)
    d, uv = random_on_sphere(torch.Generator(), 257, "cpu", dtype=torch.float64)
    assert d.dtype == uv.dtype == torch.float64 and fake.dtypes == [torch.float64]
    np.testing.assert_array_equal(uv.numpy(), juv)
    np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_random_on_sphere_draws_in_its_dtype(dtype):
    """The draw is made in the type, not cast from a float32 draw (float64
    uniforms lie off the float32 grid), and the directions are unit
    vectors in that type; float32 stays the default."""
    d, uv = random_on_sphere(torch.Generator().manual_seed(0), 4096, "cpu", dtype=dtype)
    assert d.dtype == uv.dtype == dtype and ((uv >= 0) & (uv < 1)).all()
    if dtype == torch.float64:
        assert (uv.float().double() != uv).any()
    tol = 1e-12 if dtype == torch.float64 else 4e-3
    assert (d.double().norm(dim=-1) - 1.0).abs().max() <= tol
    d32, _ = random_on_sphere(torch.Generator().manual_seed(0), 8, "cpu")
    assert d32.dtype == torch.float32


# ---- K4's default past_light_exit ---------------------------------------------------------

@pytest.mark.parametrize("per_ray", [False, True])
def test_shadow_march_plain_default_matches_the_jax_kernel_default(per_ray):
    """Neither call names the flag: the plain loop's default is the JAX
    kernel's (no past-light exit), so a ray past its light marches on."""
    jscene, tree, scene = nerv_pair(max_steps=16, occlusion="hard")
    r_o, r_d, dist = _shadow_rays()
    max_t = dist if per_ray else 10.0
    want = np.asarray(jfm.fused_shadow_march(
        jscene.shape.module, tree["shape"], jnp.asarray(r_o), jnp.asarray(r_d),
        jnp.asarray(max_t), max_steps=16, epsilon=1e-3, block_rows=64, interpret=True))
    mt = torch.from_numpy(max_t) if per_ray else max_t
    args = (scene.shape.sdf, torch.from_numpy(r_o), torch.from_numpy(r_d), mt)
    got, evals = shadow_march_plain(*args, max_steps=16, epsilon=1e-3)
    np.testing.assert_array_equal(got.numpy(), want)
    off, _ = shadow_march_plain(*args, max_steps=16, epsilon=1e-3, past_light_exit=False)
    assert torch.equal(got, off) and 0.0 < (~got).float().mean() < 1.0
    assert (evals[got] == 16).all()                        # only a hit stops a ray
