"""K2's schedule on the CPU: ``march_slots_plain``, the plain model of the
persistent slot kernel's control flow (slots refilled from a queue, a
ray's own evaluation count, its state reset when it enters a slot, the live
slots compacted once the queue is dry), and the kernel's launch plan.

  * Against ``march_plain`` bit for bit, on an SDF of correctly rounded
    operations only (so a row's value does not depend on the batch it is
    evaluated in, as PyTorch's CPU matmuls and transcendentals do), at 300
    rays with slots 8/32/128, bounded and unbounded, omega 1.0 and 1.4,
    max_steps 0/1/64, with rays that never start (empty intervals, and
    t_start >= max_t).
  * Against the JAX ``fused_march`` Pallas kernel in interpret mode on the
    8-sphere surface of ``test_torch_sdf`` (params carried across by
    ``load_jax_params``), to that file's tolerances: hit agreement >= 99%
    and |depth difference| <= 1e-4 where both hit (float32 sums in another
    order).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_raytracing_tpu.kernels.fused_march import fused_march as jax_fused_march
from neural_raytracing_tpu_torch.kernels import march_plain, march_plan, march_slots_plain
from neural_raytracing_tpu_torch.shapes import march_interval
from test_torch_sdf import _check_march, _rays, _surface

torch.set_num_threads(1)
EPS = 1e-3


def _exact_sdf(seed=0, n=6):
    """Spheres and a bilinear shift from +, -, *, sqrt and min alone."""
    g = torch.Generator().manual_seed(seed)
    c = torch.rand(n, 3, generator=g) - 0.5
    r = 0.15 + 0.2 * torch.rand(n, generator=g)

    def sdf(p):
        best = None
        for i in range(n):
            dx, dy, dz = p[..., 0] - c[i, 0], p[..., 1] - c[i, 1], p[..., 2] - c[i, 2]
            v = torch.sqrt(dx * dx + dy * dy + dz * dz) - r[i]
            best = v if best is None else torch.minimum(best, v)
        return best + 0.03 * (p[..., 0] * p[..., 1] + p[..., 2])
    return sdf


def _slot_rays(n=300, seed=1):
    g = torch.Generator().manual_seed(seed)
    r_o = torch.zeros(n, 3)
    r_o[:, 2] = 2.0
    r_o[:, :2] = 0.2 * torch.rand(n, 2, generator=g) - 0.1
    r_d = torch.nn.functional.normalize(
        torch.tensor([0.0, 0.0, -1.0]) + 0.4 * torch.randn(n, 3, generator=g), dim=-1)
    return r_o, r_d


@pytest.mark.parametrize("max_steps", [0, 1, 64])
@pytest.mark.parametrize("omega", [1.0, 1.4])
@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("slots", [8, 32, 128])
def test_slot_model_matches_march_plain_bit_for_bit(slots, bounded, omega, max_steps):
    sdf = _exact_sdf()
    r_o, r_d = _slot_rays()
    if bounded:
        t0, t1 = march_interval(r_o, r_d, 1.2, 10.0)
        t0 = t0.clone()
        t0[::7] = t1[::7] + 0.5                   # rays that never start
        assert bool((t0 >= t1).any() & (t0 < t1).any())
    else:
        t0, t1 = None, 10.0
    want = march_plain(sdf, r_o, r_d, t1, t0, max_steps=max_steps, epsilon=EPS, omega=omega)
    got = march_slots_plain(sdf, r_o, r_d, t1, t0, slots=slots, max_steps=max_steps,
                            epsilon=EPS, omega=omega)
    for a, b in zip(got[:3], want):
        assert torch.equal(a, b)
    schedule = got[3]
    if max_steps == 0:
        assert schedule == []
        return
    assert (max_steps == 1 or want[1].any()) and int(want[2].max()) <= max_steps
    # every step covered its live slots, in the fewest rows of slots, slots / 2, ... 32
    assert sum(live for live, _ in schedule) == int(want[2].sum())
    for live, rows in schedule:
        assert live <= rows <= slots and (rows == slots or (rows >= 32 and live <= rows))
        assert rows == slots or live > rows // 2 or rows == 32
    assert len(schedule) >= int(want[2].max())


def test_slot_model_tail_shrinks_the_rows():
    sdf = _exact_sdf()
    r_o, r_d = _slot_rays(n=600)
    got = march_slots_plain(sdf, r_o, r_d, 10.0, slots=128, max_steps=64, epsilon=EPS)
    rows = [r for _, r in got[3]]
    assert rows[0] == 128 and {128, 64, 32} <= set(rows)
    assert rows == sorted(rows, reverse=True)     # once the queue is dry they only shrink


@pytest.mark.parametrize("omega", [1.0, 1.4])
@pytest.mark.parametrize("bound", [None, 1.2])
@pytest.mark.parametrize("slots", [32, 128])
def test_slot_model_matches_jax_kernel_interpret(slots, bound, omega):
    jmod, tree, mod = _surface()
    rays = _rays(n=200, seed=3)
    r_o, r_d = torch.from_numpy(rays[:, :3]), torch.from_numpy(rays[:, 3:])
    if bound is None:
        t0, t1, jt0, jt1 = None, 10.0, None, 10.0
    else:
        t0, t1 = march_interval(r_o, r_d, bound, 10.0)
        jt0, jt1 = jnp.asarray(t0.numpy()), jnp.asarray(t1.numpy())
    jd, jh = jax_fused_march(jmod, tree, jnp.asarray(rays[:, :3]), jnp.asarray(rays[:, 3:]),
                             jt1, max_steps=64, epsilon=EPS, omega=omega, interpret=True,
                             t_start=jt0, block_rows=64)
    d, h, _, _ = march_slots_plain(mod, r_o, r_d, t1, t0, slots=slots, max_steps=64,
                                   epsilon=EPS, omega=omega)
    _check_march(h.numpy(), d.numpy(), np.asarray(jh), np.asarray(jd))


# rays -> blocks on a card of 132 SMs: one a SM, at most one a ray (an eval
# tile, a training step and the table shape spread over every SM).
@pytest.mark.parametrize("n,want", [(16_384, 132), (38_400, 132), (65_536, 132),
                                    (200, 132), (5, 5), (0, 0)])
def test_march_plan(monkeypatch, n, want):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=132))
    assert march_plan(n, torch.device("cuda", 0)) == want
