"""Port parity: the training step as a whole.

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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_raytracing_tpu.training as JT
from neural_raytracing_tpu.cameras import NeRFCamera as JNeRF
from neural_raytracing_tpu.integrators import Direct as JDirect
from neural_raytracing_tpu.shapes import SDF as JSDF
import neural_raytracing_tpu_torch.training as T
from neural_raytracing_tpu_torch.cameras import NeRFCamera
from neural_raytracing_tpu_torch.integrators import Direct
from neural_raytracing_tpu_torch.render import _tile_positions
from test_torch_params import scene_pair
from test_torch_training import C2W, FOCAL, LRS, SIZE, _flat, _gt

torch.set_num_threads(1)
CROP, UV = 12, (0, 2)


def _jax_loss_and_grads(jscene, tree, exp, mask):
    """The JAX step's loss_fn (training/loop.py:83-111) without a key."""
    from neural_raytracing_tpu.integrators import NeRFIntegrator
    from neural_raytracing_tpu.ops.losses import masked_loss
    from neural_raytracing_tpu.render import _tile_positions
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
