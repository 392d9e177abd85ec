"""Port parity: cameras and tile positions against the JAX package.

Rays from the same poses and pixel positions, with_noise=False.
Tolerance: atol 1e-5 (float32 transforms of unit directions and origins
of size ~3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_raytracing_tpu import render as jrender
from neural_raytracing_tpu.cameras import FoVPerspectiveCamera as JFoV
from neural_raytracing_tpu.cameras import NeRFCamera as JNeRF
from neural_raytracing_tpu.cameras import look_at_view_transform as jlook_at
from neural_raytracing_tpu.cameras import nerf_c2w as jnerf_c2w
from neural_raytracing_tpu_torch import render
from neural_raytracing_tpu_torch.cameras import (
    FoVPerspectiveCamera, NeRFCamera, look_at_view_transform, nerf_c2w,
)

torch.set_num_threads(1)
ATOL = 1e-5


def _positions(x0=8.0, y0=0.0, chunk=8):
    want = np.asarray(jrender._tile_positions(jnp.float32(x0), jnp.float32(y0), chunk))
    got = render._tile_positions(x0, y0, chunk, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    return got, want


def test_tile_positions_layout():
    got, _ = _positions()
    # positions[..., 0] is the second image axis, [..., 1] the first
    assert got[2, 5, 0] == 0.0 + 5 and got[2, 5, 1] == 8.0 + 2


@pytest.mark.parametrize("bundle", [1, 2])
def test_nerf_camera_rays(bundle):
    c2w = np.stack([nerf_c2w(30, 45, 2.0), nerf_c2w(-10, 200, 3.0)])[:, :3]
    np.testing.assert_array_equal(c2w[0], jnerf_c2w(30, 45, 2.0)[:3])
    focal = 0.5 * 16 / np.tan(0.5 * 0.6911)
    pos, jpos = _positions()
    got = NeRFCamera(torch.from_numpy(c2w), focal).sample_positions(
        pos, bundle_size=bundle, size=16)
    want = JNeRF(cam_to_world=jnp.asarray(c2w), focal=focal).sample_positions(
        jnp.asarray(jpos), bundle_size=bundle, size=16)
    assert got.shape == (2, 8, 8, bundle, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_look_at_and_fov_camera_rays():
    r, t = look_at_view_transform(dist=2.7, elev=[10.0, 80.0], azim=[20.0, -30.0])
    jr, jt = jlook_at(dist=2.7, elev=jnp.asarray([10.0, 80.0]),
                      azim=jnp.asarray([20.0, -30.0]))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=ATOL, rtol=0)
    pos, jpos = _positions()
    got = FoVPerspectiveCamera(R=r, T=t).sample_positions(pos, bundle_size=2, size=16)
    want = JFoV(R=jr, T=jt).sample_positions(jnp.asarray(jpos), bundle_size=2, size=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    # the quirk: directions are the normalised far-plane world POINTS
    center = FoVPerspectiveCamera(R=r, T=t).camera_center()
    np.testing.assert_allclose(got[..., :3].numpy(),
                               np.broadcast_to(center.numpy()[:, None, None, None],
                                               got[..., :3].shape), atol=ATOL)


def test_jitter_is_seeded_and_bounded():
    c2w = torch.from_numpy(nerf_c2w(30, 45, 2.0)[None, :3])
    cam = NeRFCamera(c2w, 20.0)
    pos, _ = _positions()

    def rays(seed):
        g = torch.Generator().manual_seed(seed)
        return cam.sample_positions(pos, generator=g, bundle_size=4, size=16,
                                    with_noise=0.5)

    assert torch.equal(rays(0), rays(0)) and not torch.equal(rays(0), rays(1))
    plain = cam.sample_positions(pos, bundle_size=4, size=16)
    # half a pixel of jitter at focal 20 turns a ray by at most ~0.018 rad
    assert 0 < (rays(0) - plain).abs().max() < 0.02
