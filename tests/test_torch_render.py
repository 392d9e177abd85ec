"""Port parity: the slice as a whole.

``pathtrace`` with ``Direct(training=False)`` on the reduced flagship scene,
JAX params carried across: size 16, chunk 8 (so the tile order and the
position layout matter), key None, background 0.  The validation render
(64 steps, unbounded) and the eval render (256 steps, march_bound 1.2), each
through both ``scan_tiles`` paths.
Tolerance: mask agreement >= 99%, max |difference| <= 1e-4 where both masks
agree, and a hit fraction > 0.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_raytracing_tpu as J
from neural_raytracing_tpu.cameras import NeRFCamera as JNeRF
from neural_raytracing_tpu.integrators import Direct as JDirect
import neural_raytracing_tpu_torch as T
from neural_raytracing_tpu_torch.cameras import NeRFCamera, nerf_c2w
from neural_raytracing_tpu_torch.integrators import Direct
from test_torch_params import scene_pair

torch.set_num_threads(1)
SIZE, CHUNK = 16, 8
FOCAL = 0.5 * SIZE / np.tan(0.5 * 0.6911)
C2W = np.stack([nerf_c2w(30, 45, 2.0), nerf_c2w(10, 160, 2.2)])[:, :3]


@functools.lru_cache(maxsize=None)
def _case(max_steps, bound):
    jscene, tree, scene = scene_pair(max_steps=max_steps, march_bound=bound)
    want, _ = J.pathtrace(jscene, tree, JNeRF(cam_to_world=jnp.asarray(C2W), focal=FOCAL),
                          JDirect(training=False), size=SIZE, chunk_size=CHUNK,
                          bundle_size=1, background=0.0, key=None)
    return scene, np.asarray(want)


def _render(scene, scan_tiles, key=None):
    return T.pathtrace(scene, NeRFCamera(torch.from_numpy(C2W), FOCAL),
                       Direct(training=False), size=SIZE, chunk_size=CHUNK,
                       bundle_size=1, background=0.0, key=key,
                       scan_tiles=scan_tiles, device="cpu")


@pytest.mark.parametrize("scan_tiles", [True, False])
@pytest.mark.parametrize("max_steps,bound", [(64, None), (256, 1.2)])
def test_pathtrace_matches_jax(max_steps, bound, scan_tiles):
    scene, want = _case(max_steps, bound)
    got, it = _render(scene, scan_tiles)
    assert got.shape == want.shape == (2, SIZE, SIZE, 3)
    assert (it is None) == scan_tiles
    got = got.numpy()
    mask, jmask = np.abs(got).sum(-1) > 0, np.abs(want).sum(-1) > 0
    assert 0 < jmask.mean() < 1
    assert (mask == jmask).mean() >= 0.99
    agree = mask == jmask
    np.testing.assert_allclose(got[agree], want[agree], atol=1e-4, rtol=0)


def test_pathtrace_jitter_is_seeded_per_tile():
    scene, _ = _case(64, None)
    a, _ = _render(scene, True, key=3)
    b, _ = _render(scene, True, key=3)
    c, _ = _render(scene, True, key=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()
