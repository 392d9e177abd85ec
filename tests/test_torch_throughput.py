"""Port parity: the silhouette min-scan and the training intersection.

n = 8 spheres, a non-zero 2 x 16 softplus shift (the surface of
``test_torch_sdf``), rays from z = 2 towards the origin, 16-32 steps.
References: JAX ``SDF.throughput`` on its jnp scan (``fused_loops="off"``)
and the Pallas min-scan kernel in interpret mode.
Tolerances: argmin indices equal; best positions atol 1e-6; the throughput
value rtol 1e-5 / atol 1e-6 (atol 1e-3 on the logits -1000 * value);
parameter gradients rtol 1e-4 / atol 1e-5 (float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_raytracing_tpu.kernels import fused_march as jfm
from neural_raytracing_tpu.shapes import SDF as JSDF
from neural_raytracing_tpu_torch.kernels import min_scan_plain
from neural_raytracing_tpu_torch.params import state_dict_from_jax
from neural_raytracing_tpu_torch.shapes import SDF
from test_torch_sdf import _surface

torch.set_num_threads(1)


def _grid_rays(n=2, w=6, h=5, seed=7):
    """[n, w, h, 1, 3] origins and directions."""
    rng = np.random.default_rng(seed)
    r_o = np.zeros((n, w, h, 1, 3), np.float32)
    r_o[..., 2] = 2.0
    r_o[..., :2] = rng.uniform(-0.05, 0.05, (n, w, h, 1, 2))
    r_d = np.asarray([0.0, 0.0, -1.0]) + rng.normal(scale=0.25, size=(n, w, h, 1, 3))
    r_d = (r_d / np.linalg.norm(r_d, axis=-1, keepdims=True)).astype(np.float32)
    return r_o, r_d


def _grads_close(jgrads, mod_params):
    want = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree.map(np.asarray, jgrads)).items()}
    got = {k: p.grad for k, p in mod_params}
    assert set(want) <= set(got) | {"shift.B"}
    for k, w in want.items():
        if k == "shift.B":
            continue
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("steps", [16, 32])
def test_min_scan_indices_match_pallas_interpret(steps):
    jmod, tree, mod = _surface()
    r_o, r_d = (a.reshape(-1, 3) for a in _grid_rays())
    step = 2.2 / steps
    jidx = jfm.fused_min_scan(jmod, tree, jnp.asarray(r_o), jnp.asarray(r_d), step,
                              steps=steps, block_rows=64, interpret=True)
    idx = min_scan_plain(mod, torch.from_numpy(r_o), torch.from_numpy(r_d), step,
                         steps=steps)
    assert idx.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert len(np.unique(idx.numpy())) > 1


@pytest.mark.parametrize("steps", [16, 32])
def test_throughput_value_position_and_gradients(steps):
    jmod, tree, mod = _surface()
    r_o, r_d = _grid_rays()
    jsdf = JSDF(jmod, throughput_steps=steps, fused_loops="off")
    sdf = SDF(mod, throughput_steps=steps)

    def jloss(params):
        sd, pos = jsdf.throughput(params, jnp.asarray(r_o), jnp.asarray(r_d))
        return jnp.sum(jnp.square(sd)), (sd, pos)

    (jval, (jsd, jpos)), jgrads = jax.value_and_grad(jloss, has_aux=True)(tree)
    sd, pos = sdf.throughput(torch.from_numpy(r_o), torch.from_numpy(r_d))
    assert not pos.requires_grad
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sd.detach().numpy(), np.asarray(jsd), rtol=1e-5, atol=1e-6)
    sd.square().sum().backward()
    _grads_close(jgrads, sdf.named_parameters())


def test_half_res_throughput():
    jmod, tree, mod = _surface()
    r_o, r_d = _grid_rays(w=6, h=5)     # odd H: the upsampled grid is cropped
    jsdf = JSDF(jmod, throughput_steps=16, fused_loops="off")
    sdf = SDF(mod, throughput_steps=16)
    want = jsdf.half_res_throughput(tree, jnp.asarray(r_o), jnp.asarray(r_d))
    got = sdf.half_res_throughput(torch.from_numpy(r_o), torch.from_numpy(r_d))
    assert got.shape == want.shape == r_o.shape[:-1]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert torch.equal(got[:, 0, 0], got[:, 1, 1])


@pytest.mark.parametrize("mode", ["full", "half_res"])
def test_primary_intersect_carries_the_throughput(mode):
    jmod, tree, mod = _surface()
    r_o, r_d = _grid_rays()
    rays = np.concatenate([r_o, r_d], axis=-1)
    kw = dict(max_steps=32, throughput_steps=16, throughput_mode=mode)
    jit_, jhit = JSDF(jmod, fused_loops="off", **kw).intersect(
        tree, jnp.asarray(rays), primary=True)
    it, hit = SDF(mod, **kw).intersect(torch.from_numpy(rays), primary=True)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_allclose(it.throughput.detach().numpy(),
                               np.asarray(jit_.throughput), rtol=1e-5, atol=1e-3)
    assert it.throughput.requires_grad and it.raw_normals.requires_grad


def test_throughput_jitter_comes_from_the_generator():
    _, _, mod = _surface()
    r_o, r_d = (torch.from_numpy(a.reshape(-1, 3)) for a in _grid_rays())
    sdf = SDF(mod, throughput_steps=16)
    runs = [sdf.throughput(r_o, r_d, torch.Generator().manual_seed(s))[1]
            for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    # the jittered scan reaches at most dist + 2 / steps along each ray
    t = ((runs[0] - r_o) * r_d).sum(-1)
    assert (t <= 2.2 + 2.0 / 16 + 1e-5).all()
    with pytest.raises(ValueError, match="CUDA"):
        SDF(mod, fused_loops="force").throughput(r_o, r_d)
