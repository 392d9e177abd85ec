"""K4's schedule on the CPU: ``shadow_slots_plain``, the plain model of the
persistent slot kernel of the shadow march (slots refilled from a queue, a
ray's own evaluation count, the live slots compacted once the queue is
dry, a zero-direction ray decided by its one evaluation), K4's launch plan,
and its width checks.

  * Against ``shadow_march_plain`` bit for bit, on an SDF of correctly
    rounded operations only (so a row's value does not depend on the batch
    it is evaluated in), at 300 rays with zero-direction rays among them,
    slots 32/64/128, compacted down to 8 rows (K4) or 32 (K4-bf16), scalar
    and per-ray max_t, the past-light exit on and off, max_steps 0/1/64; and
    under a permutation of the rays.
  * The zero-direction rule in both of its branches: a ray whose origin is
    inside the surface is blocked unless 1e2 eps + sd reaches max_t, one
    outside is not blocked, each after one evaluation.
  * Against the JAX ``fused_shadow_march`` Pallas kernel in interpret mode
    on the 8-sphere surface of ``test_torch_sdf`` (params carried across by
    ``load_jax_params``): not-blocked agreement >= 99% (float32 sums in
    another order).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_raytracing_tpu.kernels.fused_march import (
    fused_shadow_march as jax_fused_shadow_march,
)
from neural_raytracing_tpu_torch.kernels import (
    fused_shadow_march, shadow_march_plain, shadow_plan, shadow_slots_plain,
)
from neural_raytracing_tpu_torch.nn import SkipConnMLP
from neural_raytracing_tpu_torch.shapes import SphereSDF
from test_torch_sdf import _surface

torch.set_num_threads(1)
EPS = 1e-3
LIGHT = np.asarray([0.4, 1.6, 0.9])


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


def _light_rays(n=300, seed=5, radius=0.6):
    """Seeded numpy shadow rays from points on a shell towards LIGHT; every
    7th ray has a zero direction.  -> (r_o, r_d, distance to the light)."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3))
    p = radius * p / np.linalg.norm(p, axis=-1, keepdims=True)
    to_light = LIGHT - p
    dist = np.linalg.norm(to_light, axis=-1)
    r_d = to_light / dist[:, None]
    r_d[::7] = 0.0
    return (torch.from_numpy(p.astype(np.float32)), torch.from_numpy(r_d.astype(np.float32)),
            torch.from_numpy(dist.astype(np.float32)))


@pytest.mark.parametrize("max_steps", [0, 1, 64])
@pytest.mark.parametrize("past_light_exit", [True, False])
@pytest.mark.parametrize("per_ray", [False, True])
@pytest.mark.parametrize("slots", [32, 64, 128])
@pytest.mark.parametrize("min_rows", [8, 32])        # K4's schedule, K4-bf16's
def test_shadow_slot_model_matches_plain_bit_for_bit(min_rows, slots, per_ray,
                                                      past_light_exit, max_steps):
    sdf = _exact_sdf()
    r_o, r_d, dist = _light_rays()
    max_t = dist.clone() if per_ray else 10.0
    if per_ray:
        max_t[::11] = 0.5 * EPS                      # lights nearer than the start depth
    kw = dict(max_steps=max_steps, epsilon=EPS, past_light_exit=past_light_exit)
    want, evals = shadow_march_plain(sdf, r_o, r_d, max_t, **kw)
    got, got_evals, schedule = shadow_slots_plain(sdf, r_o, r_d, max_t, slots=slots,
                                                  min_rows=min_rows, **kw)
    assert torch.equal(got, want)
    if max_steps == 0:
        assert schedule == [] and got.all()
        return
    if max_steps == 64:
        assert 0.0 < (~want).float().mean() < 1.0   # some blocked, some not
    moving = r_d.abs().sum(-1) > 0
    # a moving ray takes the plain loop's evaluations, a zero-direction one at most one
    assert torch.equal(got_evals[moving], evals[moving])
    assert (got_evals[~moving] <= 1).all()
    assert sum(live for live, _ in schedule) == int(got_evals.sum())
    for live, rows in schedule:
        assert live <= rows <= slots and (rows == slots or rows >= min_rows)
        assert rows == slots or live > rows // 2 or rows == min_rows
    assert len(schedule) >= int(got_evals.max())
    if max_steps == 64 and slots > min_rows:
        assert min(rows for _, rows in schedule) == min_rows   # the tail reaches it


@pytest.mark.parametrize("past_light_exit", [True, False])
def test_shadow_slot_model_flags_do_not_change_under_a_permutation(past_light_exit):
    sdf = _exact_sdf(seed=1)
    r_o, r_d, dist = _light_rays(n=400, seed=6)
    perm = torch.randperm(400, generator=torch.Generator().manual_seed(2))
    kw = dict(slots=64, max_steps=64, epsilon=EPS, past_light_exit=past_light_exit)
    nb, evals, _ = shadow_slots_plain(sdf, r_o, r_d, dist, **kw)
    pnb, pevals, _ = shadow_slots_plain(sdf, r_o[perm], r_d[perm], dist[perm], **kw)
    assert torch.equal(pnb, nb[perm]) and torch.equal(pevals, evals[perm])
    assert 0.0 < (~nb).float().mean() < 1.0


@pytest.mark.parametrize("past_light_exit", [True, False])
def test_zero_direction_rule_both_branches(past_light_exit):
    """A zero-direction ray never moves: sd(o) < eps hits, blocked unless
    1e2 eps + sd(o) reaches max_t; otherwise it is not blocked.  The slot
    model decides each with one evaluation, as the plain loop's flags."""
    sdf = _exact_sdf(seed=3)
    g = torch.Generator().manual_seed(4)
    pts = 1.2 * torch.rand(4000, 3, generator=g) - 0.6
    sd = sdf(pts)
    inside, outside = pts[sd < -0.05][:40], pts[sd > 0.05][:40]
    assert inside.shape[0] == 40 and outside.shape[0] == 40
    # points just outside the surface, 0 < sd < eps, by bisection on each segment
    lo, hi = inside[:10].clone(), outside[:10].clone()
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        above = (sdf(mid) >= 0.5 * EPS)[:, None]
        lo, hi = torch.where(above, lo, mid), torch.where(above, mid, hi)
    near = hi
    sd_near = sdf(near)
    assert ((sd_near > 0) & (sd_near < EPS)).all()
    r_o = torch.cat([inside, near, near, outside])
    r_d = torch.zeros_like(r_o)
    # the second group's light is where its hit step's advance ends, the
    # third's just beyond
    max_t = torch.cat([torch.full((40,), 10.0), 1e2 * EPS + sd_near,
                       torch.nextafter(1e2 * EPS + sd_near, torch.tensor(10.0)),
                       torch.full((40,), 10.0)])
    kw = dict(max_steps=64, epsilon=EPS, past_light_exit=past_light_exit)
    want, evals = shadow_march_plain(sdf, r_o, r_d, max_t, **kw)
    got, got_evals, _ = shadow_slots_plain(sdf, r_o, r_d, max_t, slots=32, **kw)
    assert torch.equal(got, want)
    assert not got[:40].any() and got[40:50].all() and not got[50:60].any()
    assert got[60:].all()
    assert (got_evals == 1).all() and (evals[:60] == 1).all()
    if not past_light_exit:
        assert (evals[60:] == 64).all()           # the plain loop marches a free one on


@pytest.mark.parametrize("past_light_exit", [True, False])
@pytest.mark.parametrize("slots", [32, 128])
def test_shadow_slot_model_matches_jax_kernel_interpret(slots, past_light_exit):
    jmod, tree, mod = _surface()
    r_o, r_d, dist = _light_rays(n=200, seed=7, radius=0.7)
    r_d[::7] = torch.nn.functional.normalize(torch.tensor(LIGHT, dtype=torch.float32)
                                             - r_o[::7], dim=-1)   # no zero directions
    jnb = jax_fused_shadow_march(jmod, tree, jnp.asarray(r_o.numpy()), jnp.asarray(r_d.numpy()),
                                 jnp.asarray(dist.numpy()), max_steps=64, epsilon=EPS,
                                 block_rows=64, interpret=True,
                                 past_light_exit=past_light_exit)
    nb, _, _ = shadow_slots_plain(mod, r_o, r_d, dist, slots=slots, max_steps=64,
                                  epsilon=EPS, past_light_exit=past_light_exit)
    jnb = np.asarray(jnb)
    assert 0.0 < (~jnb).mean() < 1.0
    assert (nb.numpy() == jnb).mean() >= 0.99


@pytest.mark.parametrize("hidden,n_spheres,limit", [(300, 8, "hidden_size = 256"),
                                                    (64, 1100, "spheres = 1024")])
def test_fused_shadow_march_checks_widths_before_devices(hidden, n_spheres, limit):
    module = SphereSDF(n=n_spheres, mlp=SkipConnMLP(in_size=3, out=1, num_layers=2,
                                                    hidden_size=hidden, freqs=2))
    x = torch.rand(8, 3)
    with pytest.raises(ValueError, match=f"fused_shadow_march takes at most {limit}"):
        fused_shadow_march(module, x, x, 1.0, max_steps=4, epsilon=EPS, past_light_exit=True)


# (rays, the kernel's slots) -> (blocks, slots) on a card of 132 SMs: at most
# 64 slots a block where one fill of the kernel's would hold every ray (an
# eval chunk, a training call), else all of them
@pytest.mark.parametrize("n,kernel_slots,want", [
    (10_000, 128, (132, 64)), (12_288, 128, (132, 64)), (16_896, 128, (132, 64)),
    (16_897, 128, (132, 128)), (40_000, 128, (132, 128)), (5, 128, (5, 64)),
    (0, 128, (0, 64)), (8_448, 64, (132, 64)), (40_000, 64, (132, 64))])
def test_shadow_plan(monkeypatch, n, kernel_slots, want):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=132))
    assert shadow_plan(n, torch.device("cuda", 0), kernel_slots) == want
