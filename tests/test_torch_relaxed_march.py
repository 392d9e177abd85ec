"""Port parity: the over-relaxed sphere trace (K2 with omega > 1, its plain
version ``march_plain(omega=)``) against the JAX package.

Two kinds of case, each in the unbounded mode (scalar ``max_t``) and the
bounded one (per-ray ``[t_start, max_t]``):
  * the random surface of ``test_torch_sdf`` (8 spheres, a non-zero 2 x 16
    shift), 256 rays, omega 1.4 and 1.9, against the JAX jnp loop
    (``SDF(fused_loops="off", omega=)``) and the JAX Pallas kernel in
    interpret mode (``fused_loops="force"``);
  * an exact SDF (one sphere of radius 0.5, the exact smooth-min, a zero
    shift; omega 1.5, so the head-on steps below are exact in float32) and
    rays built so that each rule of the relaxed loop decides the outcome:
    the failure when the new and previous bounding spheres no longer overlap,
    the failure deeper than eps inside, the step back by (1 - omega) * step,
    the reset of the ray's omega to 1, and no hit on a failed step.  A copy
    of the loop with that one rule changed gives another result, so the case
    pins the rule.
Tolerances: random surface, hit agreement >= 99% and |depth difference|
<= 1e-4 where both hit (float32 sums in another order, as
``test_torch_sdf``); the rule cases, equal hit flags and depths within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_raytracing_tpu.shapes import SDF as JSDF
from neural_raytracing_tpu_torch.kernels import march_plain
from neural_raytracing_tpu_torch.shapes import SDF
from test_torch_occlusion import _one_sphere
from test_torch_sdf import _check_march, _rays, _surface

torch.set_num_threads(1)
EPS = 2.0 ** -10


# ---- a random surface ------------------------------------------------------------

@pytest.mark.parametrize("bound", [None, 1.2])
@pytest.mark.parametrize("omega", [1.4, 1.9])
def test_relaxed_march_matches_jax(omega, bound):
    jmod, tree, mod = _surface()
    rays = _rays()
    kw = dict(max_steps=64, march_bound=bound, omega=omega)
    jit_, jhit = JSDF(jmod, fused_loops="off", **kw).intersect(
        tree, jnp.asarray(rays), primary=False)
    it, hit = SDF(mod, **kw).intersect(torch.from_numpy(rays), primary=False)
    _check_march(hit, it.t.detach(), jhit, jit_.t)
    # the relaxed march needs fewer evaluations than the plain one
    r_o, r_d = torch.from_numpy(rays[:, :3]), torch.from_numpy(rays[:, 3:])
    evals = {om: march_plain(mod, r_o, r_d, 10.0, max_steps=64, epsilon=1e-3,
                             omega=om)[2].float().mean() for om in (1.0, omega)}
    assert evals[omega] < evals[1.0]


@pytest.mark.parametrize("bound", [None, 1.2])
def test_relaxed_march_against_pallas_interpret(bound):
    jmod, tree, mod = _surface()
    rays = _rays(n=128, seed=3)
    kw = dict(max_steps=64, march_bound=bound, omega=1.4)
    jit_, jhit = JSDF(jmod, fused_loops="force", **kw).intersect(
        tree, jnp.asarray(rays), primary=False)
    it, hit = SDF(mod, **kw).intersect(torch.from_numpy(rays), primary=False)
    _check_march(hit, it.t.detach(), jhit, jit_.t)


def test_omega_is_read_at_every_march():
    _, _, mod = _surface()
    rays = torch.from_numpy(_rays(n=64))
    sdf = SDF(mod, max_steps=64)
    plain = sdf._march(rays[:, :3], rays[:, 3:], 10.0)
    sdf.omega = 1.4                   # as scripts/render.py sets it
    relaxed = sdf._march(rays[:, :3], rays[:, 3:], 10.0)
    want = march_plain(mod, rays[:, :3], rays[:, 3:], 10.0, max_steps=64,
                       epsilon=1e-3, omega=1.4)
    assert torch.equal(relaxed[0], want[0]) and not torch.equal(relaxed[0], plain[0])
    assert sdf.replace(max_steps=8).omega == 1.4
    for bad in (0.9, 2.0):
        with pytest.raises(ValueError, match="omega"):
            SDF(mod, omega=bad)
    sdf.omega = 2.5
    with pytest.raises(ValueError, match="omega"):
        sdf._march(rays[:, :3], rays[:, 3:], 10.0)


# ---- the rules, on an exact SDF --------------------------------------------------

def _relaxed_loop(sdf, r_o, r_d, max_t, steps, omega, overlap=True, inside=True,
                  retreat=True, reset=True, hit_needs_no_fail=True):
    """The relaxed loop with one rule switchable, to show that each case
    below tells the rules apart."""
    batch = r_o.shape[:-1]
    depths, prev, slen = torch.zeros(batch), torch.zeros(batch), torch.zeros(batch)
    om = torch.full(batch, omega)
    remaining, hit = torch.ones(batch, dtype=torch.bool), torch.zeros(batch, dtype=torch.bool)
    for _ in range(steps):
        remaining = remaining & (depths < max_t)
        sd = sdf(r_o + r_d * depths[..., None])
        cond = torch.zeros(batch, dtype=torch.bool)
        if overlap:
            cond = cond | (sd.abs() + prev.abs() <= slen)
        if inside:
            cond = cond | (sd < -EPS)
        fail = remaining & (om > 1.0) & cond
        hits = remaining & (sd <= EPS) & (~fail if hit_needs_no_fail else True)
        new = torch.where(fail, (1.0 - om) * slen if retreat else 0.0, om * sd)
        if reset:
            om = torch.where(fail, 1.0, om)
        hit = hit | hits
        remaining = remaining & ~hits
        depths = torch.where(remaining, depths + new, depths)
        slen = torch.where(remaining, new, slen)
        prev = torch.where(remaining, sd, prev)
    return depths, hit


# (ray origin, steps, the rule's mutations): every ray looks down -z
RULE_CASES = {
    # head-on from z = 2: the first relaxed step (2.25) lands 0.25 inside;
    # it fails, steps back to 1.125 and hits at 1.5 on the 4th evaluation
    "step_back_and_reset": ((0.0, 0.0, 2.0), 4, [dict(hit_needs_no_fail=False),
                                                 dict(retreat=False),
                                                 dict(reset=False)]),
    # a ray at x = 0.45 hits the sphere, but the first relaxed step jumps
    # across it to a point outside (sd 0.055 > 0): only the overlap test
    # catches it
    "overlap": ((0.45, 0.0, 2.0), 32, [dict(overlap=False)]),
    # the march starts inside (sd -0.3): the first step fails and cannot hit
    "inside": ((0.0, 0.0, 0.2), 1, [dict(inside=False)]),
}


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("name", sorted(RULE_CASES))
def test_relaxed_march_rules(name, bounded):
    origin, steps, mutants = RULE_CASES[name]
    r_o, r_d = torch.tensor([origin]), torch.tensor([[0.0, 0.0, -1.0]])
    module = _one_sphere("torch")
    with torch.no_grad():
        want_d, want_h = _relaxed_loop(module, r_o, r_d, 10.0, steps, 1.5)
        for mutant in mutants:
            d, h = _relaxed_loop(module, r_o, r_d, 10.0, steps, 1.5, **mutant)
            assert h.item() != want_h.item() or abs(d.item() - want_d.item()) > 0.1, mutant
    assert want_h.item() == (name != "inside")
    t_start = torch.zeros(1) if bounded else None
    max_t = torch.full((1,), 10.0) if bounded else 10.0
    depth, hit, _ = march_plain(module, r_o, r_d, max_t, t_start, max_steps=steps,
                                epsilon=EPS, omega=1.5)
    assert torch.equal(hit, want_h)
    np.testing.assert_allclose(depth.numpy(), want_d.numpy(), atol=1e-6, rtol=0)
    jmodule, params = _one_sphere("jax")
    jt0 = jnp.zeros(1) if bounded else None
    jmax = jnp.full((1,), 10.0) if bounded else 10.0
    for loops in ("off", "force"):     # the jnp loop, the Pallas kernel (interpret)
        jsdf = JSDF(jmodule, epsilon=EPS, max_steps=steps, fused_loops=loops, omega=1.5)
        jd, jh = jsdf._march(params, jnp.asarray(r_o.numpy()), jnp.asarray(r_d.numpy()),
                             jmax, t_start=jt0)
        assert bool(jh[0]) == want_h.item(), loops
        np.testing.assert_allclose(np.asarray(jd), want_d.numpy(), atol=1e-6, rtol=0,
                                   err_msg=loops)
