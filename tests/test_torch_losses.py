"""Port parity: the training losses, SSIM and the eikonal term.

Seeded numpy crops go through the JAX functions and the port's.
Tolerances: values rtol 1e-5 / atol 1e-6 (float32 sums in another order);
gradients rtol 1e-4 / atol 1e-6 (the SSIM chain divides by small variances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_raytracing_tpu.ops.losses import masked_loss as jmasked_loss
from neural_raytracing_tpu.ops.math import eikonal_loss as jeikonal
from neural_raytracing_tpu.ops.math import mse2psnr as jmse2psnr
from neural_raytracing_tpu.ops.ssim import ms_ssim as jms_ssim
from neural_raytracing_tpu.ops.ssim import ssim as jssim
from neural_raytracing_tpu_torch.ops import (
    binary_cross_entropy, binary_cross_entropy_with_logits, eikonal_loss,
    masked_loss, ms_ssim, mse2psnr, ssim,
)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _crop(seed=0, n=2, s=16, all_miss=False):
    rng = np.random.default_rng(seed)
    got = rng.uniform(0, 1.2, (n, s, s, 3)).astype(np.float32)
    exp = rng.uniform(0, 1, (n, s, s, 3)).astype(np.float32)
    thr = rng.normal(scale=3.0, size=(n, s, s)).astype(np.float32)
    mask = (rng.uniform(size=(n, s, s)) > 0.4).astype(np.float32)
    if all_miss:
        thr = -np.abs(thr) - 0.1
    return got, exp, thr, mask


def test_eikonal_and_psnr():
    g = np.random.default_rng(1).normal(size=(64, 3)).astype(np.float32)
    g[:4] = 0.0    # saturated points: the clamp inside the sqrt keeps them finite
    np.testing.assert_allclose(eikonal_loss(_t(g)).item(), float(jeikonal(jnp.asarray(g))),
                               rtol=1e-5)
    gt = _t(g).requires_grad_()
    (d,) = torch.autograd.grad(eikonal_loss(gt), gt)
    jd = jax.grad(jeikonal)(jnp.asarray(g))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-6)
    assert torch.isfinite(d).all()
    np.testing.assert_allclose(mse2psnr(0.01).item(), float(jmse2psnr(0.01)), rtol=1e-6)


@pytest.mark.parametrize("size", [16, 23])
def test_ssim_matches_jax(size):
    rng = np.random.default_rng(size)
    x = rng.uniform(size=(2, 3, size, size)).astype(np.float32)
    y = np.clip(x + rng.normal(scale=0.1, size=x.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(ssim(_t(x), _t(y)).item(), float(jssim(x, y)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ssim(_t(x), _t(y), size_average=False).numpy(),
                               np.asarray(jssim(x, y, size_average=False)),
                               rtol=1e-5, atol=1e-6)


def test_ms_ssim_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(1, 3, 181, 177)).astype(np.float32)    # odd sides pad
    y = np.clip(x + rng.normal(scale=0.05, size=x.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(ms_ssim(_t(x), _t(y)).item(), float(jms_ssim(x, y)),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="too small"):
        ms_ssim(_t(x[..., :64, :64]), _t(y[..., :64, :64]))


def test_bce_forms():
    rng = np.random.default_rng(4)
    logits = rng.normal(scale=5, size=100).astype(np.float32)
    t = (rng.uniform(size=100) > 0.5).astype(np.float32)
    want = torch.nn.functional.binary_cross_entropy_with_logits(
        _t(logits), _t(t), reduction="none")
    torch.testing.assert_close(binary_cross_entropy_with_logits(_t(logits), _t(t)),
                               want, rtol=1e-5, atol=1e-6)
    p = torch.sigmoid(_t(logits))
    torch.testing.assert_close(binary_cross_entropy(p, _t(t)),
                               torch.nn.functional.binary_cross_entropy(
                                   p, _t(t), reduction="none"), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("with_ssim,tone_mapping,all_miss", [
    (True, False, False), (False, False, False), (True, True, False),
    (True, False, True)])
def test_masked_loss_and_gradients(with_ssim, tone_mapping, all_miss):
    got, exp, thr, mask = _crop(seed=5, all_miss=all_miss)
    kw = dict(mask_weight=15.0, tone_mapping=tone_mapping, with_ssim=with_ssim)

    def jloss(g, t):
        return jmasked_loss(g, jnp.asarray(exp), t, jnp.asarray(mask), **kw)

    jval, (jg, jt) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(got),
                                                               jnp.asarray(thr))
    g, t = _t(got).requires_grad_(), _t(thr).requires_grad_()
    val = masked_loss(g, _t(exp), t, _t(mask), **kw)
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jt), rtol=1e-4, atol=1e-6)
    if all_miss:
        # no active pixel: the color terms are 0 and only the BCE remains
        assert not g.grad.any()
