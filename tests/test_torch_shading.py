"""Port parity: shading (NeuralBSDF, ComposeSpatialVarying, LightField,
sample_emitter) and Direct.sample on given rays, on the reduced flagship.

The shading tests feed both sides the same interaction (the JAX intersect
of fixed rays), so they test shading alone; Direct.sample then runs each
side end to end on the same rays.
Tolerance: rtol 1e-4, atol 1e-5 (MLP chains in float32); Direct.sample:
hit agreement >= 99% and atol 1e-4 where both hit (it sits after a march);
the training throughput logits rtol 1e-5 / atol 1e-3 (-1000 x an SDF value
held to 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_raytracing_tpu import scene as jscene_mod
from neural_raytracing_tpu.integrators import Direct as JDirect
from neural_raytracing_tpu_torch import sample_emitter
from neural_raytracing_tpu_torch.integrators import Direct
from neural_raytracing_tpu_torch.interaction import Interaction
from test_torch_params import scene_pair

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5


def _rays(n=128, seed=0):
    rng = np.random.default_rng(seed)
    r_o = np.zeros((n, 3), np.float32)
    r_o[:, 2] = 2.0
    r_d = np.asarray([0.0, 0.0, -1.0]) + rng.normal(scale=0.25, size=(n, 3))
    r_d = (r_d / np.linalg.norm(r_d, axis=-1, keepdims=True)).astype(np.float32)
    return np.concatenate([r_o, r_d], axis=-1)


@pytest.fixture(scope="module")
def shading_case():
    jscene, tree, scene = scene_pair()
    jit_, jhit = jscene.shape.intersect(tree["shape"], jnp.asarray(_rays()),
                                        primary=False)
    it = Interaction(**{f: torch.from_numpy(np.array(getattr(jit_, f)))
                        for f in ("p", "t", "n", "frame", "wi")})
    wo = np.random.default_rng(1).normal(size=(128, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    active = np.array(jhit)
    assert active.mean() > 0
    return jscene, tree, scene, jit_, it, wo, active


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_neural_bsdf_eval_and_pdf(shading_case):
    jscene, tree, scene, jit_, it, wo, _ = shading_case
    lobe, jlobe = scene.bsdf.bsdfs[3], jscene.bsdf.bsdfs[3]
    spec, pdf, _ = lobe.eval_and_pdf(it, torch.from_numpy(wo))
    jspec, jpdf, _ = jlobe.eval_and_pdf(tree["bsdf"]["bsdfs"][3], jit_, jnp.asarray(wo))
    _close(spec, jspec)
    _close(pdf, jpdf)


def test_compose_spatial_varying_eval_and_pdf(shading_case):
    jscene, tree, scene, jit_, it, wo, active = shading_case
    spec, pdf, aux = scene.bsdf.eval_and_pdf(it, torch.from_numpy(wo),
                                             torch.from_numpy(active))
    jspec, jpdf, jaux = jscene.bsdf.eval_and_pdf(tree["bsdf"], jit_, jnp.asarray(wo),
                                                 jnp.asarray(active))
    # the sigma=128 weight net sees Fourier arguments |p.B| of a few hundred,
    # whose float32 rounding (~6e-8 |p.B|) the net amplifies a few times
    arg = np.abs(it.p.numpy() @ tree["bsdf"]["sp_var_fn"]["B"]).max()
    atol = ATOL + 4e-7 * arg
    _close(spec, jspec, atol=atol)
    _close(pdf, jpdf, atol=atol)
    for k in ("normalized_weights", "nonnormalized_weights"):
        _close(aux[k], jaux[k], atol=atol)
    assert not spec.detach().numpy()[~active].any()


def test_light_field_and_sample_emitter(shading_case):
    jscene, tree, scene, jit_, it, _, active = shading_case
    ds, spec = sample_emitter(scene, it, None, torch.from_numpy(active))
    jds, jspec = jscene_mod.sample_emitter(jscene, tree, jit_, None, jnp.asarray(active))
    _close(ds.d, jds.d)
    _close(ds.pdf, jds.pdf)
    _close(spec, jspec)
    assert ds.dist is None and ds.delta
    # the [1e-6, 1] clamp of the direction components
    d = ds.d.detach().numpy()[active]
    assert d.min() >= 1e-6 and d.max() <= 1.0


@pytest.mark.parametrize("horizon_mask", [False, True])
def test_direct_sample_on_given_rays(horizon_mask):
    jscene, tree, scene = scene_pair()
    rays = _rays(seed=2).reshape(2, 8, 8, 1, 6)
    jvals, jactive, _ = JDirect(training=False, horizon_mask=horizon_mask).sample(
        jscene, tree, jnp.asarray(rays))
    with torch.no_grad():
        vals, active, it = Direct(training=False, horizon_mask=horizon_mask).sample(
            scene, torch.from_numpy(rays))
    active, jactive = active.numpy(), np.asarray(jactive)
    assert vals.shape == (2, 8, 8, 1, 3) and jactive.mean() > 0
    assert (active == jactive).mean() >= 0.99
    both = active & jactive
    np.testing.assert_allclose(vals.numpy()[both], np.asarray(jvals)[both],
                               rtol=0, atol=1e-4)
    assert it.normalized_weights.shape == (2, 8, 8, 1, 8)
    # training=True: primary intersections carry the silhouette throughput
    _, _, jit_ = JDirect(training=True).sample(jscene, tree, jnp.asarray(rays))
    with torch.no_grad():
        _, _, it = Direct(training=True).sample(scene, torch.from_numpy(rays))
    np.testing.assert_allclose(it.throughput.numpy(), np.asarray(jit_.throughput),
                               rtol=1e-5, atol=1e-3)
