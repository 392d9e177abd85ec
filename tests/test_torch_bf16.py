"""Port parity: the bf16-operand variants of K1 and of the march kernels
K2/K3/K4, and the mixed-precision configuration that runs them.

The JAX package offers two operand dtypes: ``SkipConnMLP(compute_dtype=)``
(K1, ``_build_kernel``) and ``SDF(march_dtype=)`` (K2-K4, ``_make_sdf_eval``).
The two round in different places: K1's skip layers read ``act(enc)`` of the
float32 encoding, rounded; the march kernels' read ``act`` of the ROUNDED
encoding.  The plain ``SkipConnMLP`` with bf16 is a third function: it
computes the Fourier encoding in bf16 (``B`` cast, ``x @ B`` and sin/cos
rounded) and runs in float32 from there (JAX promotes bf16 @ f32 to f32),
and the fused net's default backward recomputes through it.
Seeded numpy parameters go through both packages through the parameter
bridge; the JAX kernels run in interpret mode.

Tolerances.  The product of two bf16 values is exact in float32, so a plain
version built as "round the operands, float32 matmul" computes the TPU
kernel's function up to float32 summation order: outputs are held at float32
tolerances (rtol 1e-4, atol 1e-5), not bf16's 4e-3.  A summation-order
difference can tip a bf16 rounding to the neighbouring value and move that
operand by one bf16 step, which moves its row's outputs; so the value checks
allow 5% of the rows (points) outside that tolerance, and the mean error must
stay below a tenth of the mean bf16 - float32 difference.  The marches: hit agreement >=
99% and |depth difference| <= 1e-4 where both hit (as ``test_torch_sdf``),
index agreement >= 99% for the min-scan, not-blocked agreement >= 99% for
the shadow march; the plain SkipConnMLP's forward and weight gradients
(both sides float32 after the bf16 encoding) rtol 1e-4 / atol 1e-5 of the
largest value, except the input's
gradient, which comes back through the bf16 encoding on both sides (two bf16
steps, 2^-7, of its largest value); the slice's render as
``test_torch_render`` on 99% of its pixels, and the training step's loss
rtol 1e-4 and gradients within 1e-3 of each leaf's max|JAX gradient|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_raytracing_tpu as J
import neural_raytracing_tpu.training as JT
from neural_raytracing_tpu.bsdf import ComposeSpatialVarying as JCompose
from neural_raytracing_tpu.bsdf import NeuralBSDF as JNeuralBSDF
from neural_raytracing_tpu.cameras import NeRFCamera as JNeRF
from neural_raytracing_tpu.integrators import Direct as JDirect
from neural_raytracing_tpu.kernels import FusedSkipConnMLP as JFused
from neural_raytracing_tpu.kernels import fused_march as jfm
from neural_raytracing_tpu.kernels.fused_mlp import _pallas_forward
from neural_raytracing_tpu.lights import LightField as JLightField
from neural_raytracing_tpu.nn import SkipConnMLP as JMLP
from neural_raytracing_tpu.shapes import SDF as JSDF
from neural_raytracing_tpu.shapes import SphereSDF as JSphereSDF
import neural_raytracing_tpu_torch as T
import neural_raytracing_tpu_torch.training as TT
from neural_raytracing_tpu_torch.bsdf import ComposeSpatialVarying, NeuralBSDF
from neural_raytracing_tpu_torch.cameras import NeRFCamera
from neural_raytracing_tpu_torch.integrators import Direct
from neural_raytracing_tpu_torch.kernels import (
    FusedSkipConnMLP, march_plain, min_scan_plain, mlp_forward_bf16_operands,
    shadow_march_plain, sphere_sdf_eval_plain,
)
from neural_raytracing_tpu_torch.lights import LightField
from neural_raytracing_tpu_torch.nn import SkipConnMLP
from neural_raytracing_tpu_torch.ops.encoding import fourier_encode
from neural_raytracing_tpu_torch.params import load_jax_params
from neural_raytracing_tpu_torch.shapes import SDF, SphereSDF
from test_torch_params import NETS, scene_params
from test_torch_training import C2W, FOCAL, LRS, SIZE, _flat, _gt

torch.set_num_threads(1)
BF16 = torch.bfloat16
RTOL, ATOL = 1e-4, 1e-5
NET = dict(in_size=3, out=3, num_layers=4, hidden_size=32, freqs=8)
SHIFT = dict(in_size=3, out=1, num_layers=3, hidden_size=32, freqs=8,
             activation="softplus", init="uniform")


def _assert_bf16_close(got, want, f32_ref):
    """``got`` against ``want`` (two implementations of one bf16-operand
    function, rows of outputs): 95% of the rows at float32 tolerance, and a
    mean error below a tenth of the mean |bf16 - float32| difference, which
    must put at least half of the rows outside that tolerance."""
    got, want, f32_ref = (np.asarray(a, np.float32).reshape(len(a), -1)
                          for a in (got, want, f32_ref))
    err = np.abs(got - want)
    ok = (err <= RTOL * np.abs(want) + ATOL).all(axis=-1)
    assert ok.mean() >= 0.95, (ok.mean(), err.max())
    # the variant is measurably not float32: most rows leave its tolerance
    off = (np.abs(want - f32_ref) > RTOL * np.abs(want) + ATOL).any(axis=-1)
    assert off.mean() >= 0.5, off.mean()
    gap = np.abs(want - f32_ref).mean()
    assert err.mean() <= 0.1 * gap, (err.mean(), gap)


def _net_pair(cfg, seed=0, jcls=JMLP, cls=SkipConnMLP, jkw=None, **kw):
    """(JAX net with bf16 operands, its params, port net with them)."""
    jmlp = jcls(**cfg, compute_dtype=jnp.bfloat16, **(jkw or {}))
    tree = jax.tree.map(np.asarray, jmlp.init(jax.random.PRNGKey(seed)))
    mlp = load_jax_params(cls(**cfg, compute_dtype=BF16, **kw), tree, device="cpu")
    return jmlp, tree, mlp


def _x(n=96, seed=1):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (n, 3)).astype(np.float32)


def _plain(mlp, x, **kw):
    with torch.no_grad():
        return mlp_forward_bf16_operands(mlp, torch.from_numpy(x), mlp.B,
                                         mlp.flat_weights(), **kw).numpy()


# ---- (a) K1-bf16's plain version against the Pallas kernel --------------------------

@pytest.mark.parametrize("activation", ["softplus", "leaky_relu"])
def test_k1_bf16_plain_matches_pallas_interpret(activation):
    cfg = dict(NET, activation=activation)
    jmlp, tree, mlp = _net_pair(cfg)
    x = _x()
    want = _pallas_forward(jmlp, tree, jnp.asarray(x), block_rows=64, interpret=True)
    f32 = _pallas_forward(JMLP(**cfg), tree, jnp.asarray(x), block_rows=64,
                          interpret=True)
    _assert_bf16_close(_plain(mlp, x), want, f32)


# ---- (b) the march's SDF and the three loops against the Pallas kernels --------------

def _surface(stable_min=False, seed=0):
    """16 spheres and a non-zero 3 x 32 softplus shift (out layer x 0.3)."""
    jmod = JSphereSDF(n=16, mlp=JMLP(**SHIFT), stable_min=stable_min)
    tree = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(seed)))
    tree["shift"]["out"] = {k: 0.3 * v for k, v in tree["shift"]["out"].items()}
    tree["radii"] = 0.3 + 0.5 * tree["radii"]
    mod = load_jax_params(SphereSDF(n=16, mlp=SkipConnMLP(**SHIFT),
                                    stable_min=stable_min), tree, device="cpu")
    return jmod, tree, mod


def _jax_sdf_eval(jmod, tree, p, dtype):
    """The JAX kernels' SDF (``_make_sdf_eval``) on arrays, outside a kernel."""
    refs = (jfm._sphere_weight_arrays(tree)
            + jfm._mlp_weight_arrays(tree["shift"], dtype))
    ev = jfm._make_sdf_eval(jmod.shift, jmod.k, refs, dtype,
                            stable_min=jmod.stable_min)
    return np.asarray(ev(jnp.asarray(p)))[:, 0]


@pytest.mark.parametrize("stable_min", [False, True])
def test_march_sdf_eval_matches_jax(stable_min):
    jmod, tree, mod = _surface(stable_min)
    p = np.random.default_rng(2).uniform(-1.0, 1.0, (256, 3)).astype(np.float32)
    want = _jax_sdf_eval(jmod, tree, p, jnp.bfloat16)
    f32 = _jax_sdf_eval(jmod, tree, p, jnp.float32)
    got = sphere_sdf_eval_plain(mod, torch.from_numpy(p), BF16).numpy()
    _assert_bf16_close(got, want, f32)
    # float32 operands: the SphereSDF itself
    np.testing.assert_allclose(sphere_sdf_eval_plain(mod, torch.from_numpy(p)).numpy(),
                               f32, rtol=1e-5, atol=1e-6)


def _rays(n=96, seed=1):
    rng = np.random.default_rng(seed)
    r_o = np.zeros((n, 3), np.float32)
    r_o[:, 2] = 2.0
    r_o[:, :2] = rng.uniform(-0.1, 0.1, (n, 2))
    r_d = np.asarray([0.0, 0.0, -1.0]) + rng.normal(scale=0.3, size=(n, 3))
    r_d = (r_d / np.linalg.norm(r_d, axis=-1, keepdims=True)).astype(np.float32)
    return r_o, r_d


def _bf16_sdf(mod):
    return lambda p: sphere_sdf_eval_plain(mod, p, BF16)


@pytest.mark.parametrize("mode", ["unbounded", "bounded", "relaxed"])
def test_march_bf16_matches_pallas_interpret(mode):
    jmod, tree, mod = _surface()
    r_o, r_d = _rays()
    omega = 1.4 if mode == "relaxed" else 1.0
    if mode == "bounded":
        from neural_raytracing_tpu_torch.shapes import march_interval
        t0, t1 = march_interval(torch.from_numpy(r_o), torch.from_numpy(r_d), 1.2, 10.0)
        jt0, jt1 = jnp.asarray(t0.numpy()), jnp.asarray(t1.numpy())
    else:
        t0, t1, jt0, jt1 = None, 10.0, None, 10.0
    kw = dict(max_steps=12, epsilon=1e-3, omega=omega)
    want_d, want_h = jfm.fused_march(jmod, tree, jnp.asarray(r_o), jnp.asarray(r_d), jt1,
                                     block_rows=32, compute_dtype=jnp.bfloat16,
                                     interpret=True, t_start=jt0, **kw)
    got_d, got_h, _ = march_plain(_bf16_sdf(mod), torch.from_numpy(r_o),
                                  torch.from_numpy(r_d), t1, t0, **kw)
    want_h, got_h = np.asarray(want_h), got_h.numpy()
    assert 0 < want_h.mean() < 1
    assert (got_h == want_h).mean() >= 0.99
    both = got_h & want_h
    np.testing.assert_allclose(got_d.numpy()[both], np.asarray(want_d)[both],
                               atol=1e-4, rtol=0)
    # the bf16 march ends elsewhere than the float32 one
    f32_d, _, _ = march_plain(mod, torch.from_numpy(r_o), torch.from_numpy(r_d), t1, t0, **kw)
    assert np.abs(f32_d.numpy() - got_d.numpy()).max() > 1e-6


@pytest.mark.parametrize("half_res", [False, True])
def test_min_scan_bf16_matches_pallas_interpret(half_res):
    jmod, tree, mod = _surface()
    r_o, r_d = _rays(n=96, seed=5)
    if half_res:     # the half-res scan runs on every other ray of the crop grid
        r_o, r_d = r_o[::2], r_d[::2]
    step = np.float32(2.2 / 12)
    want = np.asarray(jfm.fused_min_scan(jmod, tree, jnp.asarray(r_o), jnp.asarray(r_d),
                                         step, steps=12, block_rows=32,
                                         compute_dtype=jnp.bfloat16, interpret=True))
    got = min_scan_plain(_bf16_sdf(mod), torch.from_numpy(r_o), torch.from_numpy(r_d),
                         float(step), steps=12).numpy()
    assert len(np.unique(want)) > 1
    assert (got == want).mean() >= 0.99


def _shadow_rays(n=96, seed=4):
    """Rays from a shell of radius 1.2 through points near the centre, each
    ending past the far side at twice the distance to that point."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 1.2 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    to = rng.uniform(-0.4, 0.4, (n, 3)) - o
    dist = np.linalg.norm(to, axis=-1)
    return (o.astype(np.float32), (to / dist[:, None]).astype(np.float32),
            (2.0 * dist).astype(np.float32))


@pytest.mark.parametrize("past_light_exit", [True, False])
def test_shadow_march_bf16_matches_pallas_interpret(past_light_exit):
    jmod, tree, mod = _surface()
    r_o, r_d, dist = _shadow_rays()
    want = np.asarray(jfm.fused_shadow_march(
        jmod, tree, jnp.asarray(r_o), jnp.asarray(r_d), jnp.asarray(dist), max_steps=12,
        epsilon=1e-3, block_rows=32, compute_dtype=jnp.bfloat16, interpret=True,
        past_light_exit=past_light_exit))
    got, evals = shadow_march_plain(_bf16_sdf(mod), torch.from_numpy(r_o),
                                    torch.from_numpy(r_d), torch.from_numpy(dist),
                                    max_steps=12, epsilon=1e-3,
                                    past_light_exit=past_light_exit)
    assert 0 < (~want).mean() < 1
    assert (got.numpy() == want).mean() >= 0.99
    assert evals.sum() > 0


# ---- (c) the two roundings are told apart ---------------------------------------------

def test_k1_and_march_roundings_differ():
    """On one softplus net the K1 rounding (act of the float32 encoding) and
    the march rounding (act of the rounded encoding) give outputs further
    apart than the tolerance of (a) and (b), and each JAX kernel is nearer its
    own plain version: a swapped order cannot pass those tests."""
    jmod, tree, mod = _surface()
    x = _x(n=256, seed=3)
    k1 = _plain(mod.shift, x)[:, 0]
    march = _plain(mod.shift, x, act_of_rounded_enc=True)[:, 0]
    assert (np.abs(k1 - march) > RTOL * np.abs(k1) + ATOL).mean() > 0.05
    jk1 = np.asarray(_pallas_forward(JMLP(**SHIFT, compute_dtype=jnp.bfloat16),
                                     tree["shift"], jnp.asarray(x), block_rows=64,
                                     interpret=True))[:, 0]
    assert np.abs(k1 - jk1).mean() < 0.1 * np.abs(march - jk1).mean()
    spheres = sphere_sdf_eval_plain(mod, torch.from_numpy(x), BF16).numpy() - march
    jsdf = _jax_sdf_eval(jmod, tree, x, jnp.bfloat16)
    assert (np.abs(march + spheres - jsdf).mean()
            < 0.1 * np.abs(k1 + spheres - jsdf).mean())


# ---- (d) the plain SkipConnMLP with bf16: a bf16 encoding, float32 after ----------------

def _assert_input_grad_close(gx, jgx):
    """The input's gradient runs through the bf16 encoding's backward on both
    sides (a bf16 product over the frequencies, summed in another order): two
    bf16 steps (2^-7) of its largest value."""
    jgx = np.asarray(jgx)
    np.testing.assert_allclose(gx.numpy(), jgx, rtol=0, atol=2 ** -7 * np.abs(jgx).max())


@pytest.mark.parametrize("activation", ["softplus", "leaky_relu"])
def test_plain_mlp_bf16_forward_and_gradients(activation):
    cfg = dict(NET, activation=activation)
    jmlp, tree, mlp = _net_pair(cfg)
    rng = np.random.default_rng(6)
    x = _x(seed=7)
    g = rng.normal(size=(x.shape[0], cfg["out"])).astype(np.float32)
    want = np.asarray(jmlp(tree, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    out = mlp(xt)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    # the encoding is bf16 (B cast, x @ B and sin/cos rounded): not the f32 net
    assert not np.allclose(want, np.asarray(JMLP(**cfg)(tree, jnp.asarray(x))),
                           rtol=0, atol=1e-6)

    def jloss(params, xx):
        return jnp.sum(jmlp(params, xx) * g)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(tree, jnp.asarray(x))
    gx, *gw = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                  [xt, mlp.init.w, mlp.layers[0].w, mlp.out.b])
    # the input's gradient comes back through the bf16 encoding, in both
    np.testing.assert_array_equal(gx.numpy(), gx.to(BF16).float().numpy())
    _assert_input_grad_close(gx, jgx)
    for a, b in zip(gw, (jgp["init"]["w"], jgp["layers"][0]["w"], jgp["out"]["b"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL * np.abs(b).max())
    with pytest.raises(ValueError, match="compute dtype"):
        SkipConnMLP(**cfg, compute_dtype=torch.float16)


# ---- (e) FusedSkipConnMLP(compute_dtype=bf16) on the CPU --------------------------------

def test_fused_mlp_bf16_on_cpu_matches_jax_force():
    """The CPU path in "auto" is the kernel's autograd.Function with K1-bf16's
    plain version; the backward recomputes through the bf16-encoding function
    (the module's plain forward), as the JAX ``_bwd`` does under
    ``mode="force"``."""
    cfg = dict(NET, activation="softplus")
    jmlp, tree, mlp = _net_pair(cfg, jcls=JFused, cls=FusedSkipConnMLP,
                                jkw=dict(mode="force", block_rows=64))
    rng = np.random.default_rng(8)
    x = _x(seed=9)
    g = rng.normal(size=(x.shape[0], cfg["out"])).astype(np.float32)
    f32 = np.asarray(JMLP(**cfg)(tree, jnp.asarray(x)))
    want = np.asarray(jmlp(tree, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    out = mlp(xt)
    _assert_bf16_close(out.detach().numpy(), want, f32)
    # the kernel's function, not the module's bf16-encoding one
    np.testing.assert_array_equal(out.detach().numpy(), _plain(mlp, x))

    jgp, jgx = jax.grad(lambda p, xx: jnp.sum(jmlp(p, xx) * g), argnums=(0, 1))(
        tree, jnp.asarray(x))
    gx, gw0, gw1 = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                       [xt, mlp.init.w, mlp.layers[1].w])
    _assert_input_grad_close(gx, jgx)
    for a, b in ((gw0, jgp["init"]["w"]), (gw1, jgp["layers"][1]["w"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL * np.abs(b).max())
    # the same gradients as autograd through the module's own plain forward
    xx = torch.from_numpy(x).requires_grad_()
    (want_gx,) = torch.autograd.grad((SkipConnMLP.forward(mlp, xx)
                                      * torch.from_numpy(g)).sum(), xx)
    torch.testing.assert_close(gx, want_gx, rtol=1e-6, atol=1e-7)
    # "off" is the module's plain forward
    mlp.mode = "off"
    np.testing.assert_allclose(mlp(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(JMLP(**cfg, compute_dtype=jnp.bfloat16)(
                                   tree, jnp.asarray(x))), rtol=RTOL, atol=ATOL)


# ---- (e2) a bf16 net with a latent: the latent is rounded to bf16 ----------------------

def _unrounded_latent_forward(mlp, x, latent):
    """The plain bf16 forward with the latent left in float32: not the JAX
    function, the counterexample the latent test must reject."""
    enc = torch.cat([fourier_encode(x.to(BF16), mlp.B).float(), latent], dim=-1)
    ws, act = mlp.flat_weights(), mlp.activation
    h = enc @ ws[0] + ws[1]
    for i in range(mlp.num_layers):
        if mlp.is_skip_layer(i):
            h = torch.cat([h, enc], dim=-1)
        h = act(h) @ ws[2 + 2 * i] + ws[3 + 2 * i]
    return act(h) @ ws[-2] + ws[-1]


@pytest.mark.parametrize("cls", [SkipConnMLP, FusedSkipConnMLP])
def test_plain_mlp_bf16_rounds_the_latent(cls):
    """``SkipConnMLP(compute_dtype=bf16, latent_size=8)`` and a
    ``FusedSkipConnMLP`` called with a latent (the plain path) against the
    JAX ``SkipConnMLP.__call__`` under ``jax.grad``: the latent is rounded to
    bf16, and its gradient comes back through that cast rounded to bf16 on
    both sides, held as the input's gradient (two bf16 steps of its largest
    value: float32 sums in another order, cancelling, then rounded)."""
    cfg = dict(NET, activation="softplus", latent_size=8)
    jmlp, tree, mlp = _net_pair(cfg, cls=cls)
    rng = np.random.default_rng(10)
    x = _x(seed=11)
    # a latent of scale 8: its bf16 rounding moves the outputs past the tolerance
    lat = 8.0 * rng.normal(size=(x.shape[0], 8)).astype(np.float32)
    g = rng.normal(size=(x.shape[0], cfg["out"])).astype(np.float32)
    want = np.asarray(jmlp(tree, jnp.asarray(x), jnp.asarray(lat)))
    jgp, jgx, jgl = jax.grad(lambda p, xx, ll: jnp.sum(jmlp(p, xx, ll) * g),
                             argnums=(0, 1, 2))(tree, jnp.asarray(x), jnp.asarray(lat))
    xt, lt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(lat).requires_grad_()
    out = mlp(xt, lt)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    gx, gl, *gw = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                      [xt, lt, *mlp.flat_weights()])
    _assert_input_grad_close(gx, jgx)
    np.testing.assert_array_equal(gl.numpy(), gl.to(BF16).float().numpy())
    _assert_input_grad_close(gl, jgl)
    jgw = [jgp["init"]["w"], jgp["init"]["b"]]
    for layer in jgp["layers"]:
        jgw += [layer["w"], layer["b"]]
    jgw += [jgp["out"]["w"], jgp["out"]["b"]]
    for a, b in zip(gw, jgw, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL * np.abs(b).max())
    # guard: a float32 latent gives another function, outside the tolerance
    with torch.no_grad():
        unrounded = _unrounded_latent_forward(mlp, torch.from_numpy(x),
                                              torch.from_numpy(lat)).numpy()
    assert not np.allclose(unrounded, want, rtol=RTOL, atol=ATOL)


# ---- (f) the slice: the mixed-precision flagship ---------------------------------------

def bf16_scene(lib, max_steps=64, march_bound=None):
    """The reduced flagship of ``test_torch_params`` in the mixed-precision
    configuration: bf16 shading nets, a bf16 march, a float32 shift net.
    The JAX side runs its kernels in interpret mode."""
    if lib == "jax":
        cd, kw, loops = jnp.bfloat16, dict(mode="force", block_rows=64), "force"
        mlp, scene, sdf, sphere = JFused, J.Scene, JSDF, JSphereSDF
        compose, lobe, light = JCompose, JNeuralBSDF, JLightField
    else:
        cd, kw, loops = BF16, {}, "auto"
        mlp, scene, sdf, sphere = FusedSkipConnMLP, T.Scene, SDF, SphereSDF
        compose, lobe, light = ComposeSpatialVarying, NeuralBSDF, LightField
    return scene(
        shape=sdf(sphere(n=8, mlp=mlp(**NETS["shift"], **kw)), max_steps=max_steps,
                  march_bound=march_bound, fused_loops=loops, march_dtype=cd),
        bsdf=compose([lobe(activation="softplus",
                           mlp=mlp(**NETS["lobe"], compute_dtype=cd, **kw))
                      for _ in range(8)],
                     sp_var_fn=mlp(**NETS["weight"], compute_dtype=cd, **kw)),
        lights=light(mlp=mlp(**NETS["light"], compute_dtype=cd, **kw)))


def bf16_pair(**kw):
    jscene = bf16_scene("jax", **kw)
    tree = scene_params(jscene)
    return jscene, tree, load_jax_params(bf16_scene("torch", **kw), tree, device="cpu")


RENDER_SIZE, CHUNK = 16, 8
RENDER_FOCAL = 0.5 * RENDER_SIZE / np.tan(0.5 * 0.6911)


@functools.lru_cache(maxsize=None)
def _render_case():
    from neural_raytracing_tpu_torch.cameras import nerf_c2w
    c2w = np.stack([nerf_c2w(30, 45, 2.0), nerf_c2w(10, 160, 2.2)])[:, :3]
    jscene, tree, scene = bf16_pair(max_steps=64, march_bound=1.2)
    want, _ = J.pathtrace(jscene, tree, JNeRF(cam_to_world=jnp.asarray(c2w),
                                              focal=RENDER_FOCAL),
                          JDirect(training=False), size=RENDER_SIZE, chunk_size=CHUNK,
                          bundle_size=1, background=0.0, key=None)
    return c2w, scene, np.asarray(want)


def test_bf16_flagship_render_matches_jax():
    c2w, scene, want = _render_case()
    got, _ = T.pathtrace(scene, NeRFCamera(torch.from_numpy(c2w), RENDER_FOCAL),
                         Direct(training=False), size=RENDER_SIZE, chunk_size=CHUNK,
                         bundle_size=1, background=0.0, key=None, device="cpu")
    got = got.numpy()
    mask, jmask = np.abs(got).sum(-1) > 0, np.abs(want).sum(-1) > 0
    assert 0 < jmask.mean() < 1
    assert (mask == jmask).mean() >= 0.99
    agree = mask == jmask
    close = np.abs(got[agree] - want[agree]) <= 1e-4
    assert close.mean() >= 0.99, np.abs(got[agree] - want[agree]).max()
    # the same scene in float32 renders another image
    nets = [m for m in scene.modules()
            if isinstance(m, FusedSkipConnMLP) and m.compute_dtype == BF16]
    assert len(nets) == 10
    for m in nets:
        m.compute_dtype = torch.float32
    try:
        f32, _ = T.pathtrace(scene.replace(shape=scene.shape.replace(march_dtype=None)),
                             NeRFCamera(torch.from_numpy(c2w), RENDER_FOCAL),
                             Direct(training=False), size=RENDER_SIZE, chunk_size=CHUNK,
                             bundle_size=1, background=0.0, key=None, device="cpu")
    finally:
        for m in nets:
            m.compute_dtype = BF16
    assert np.abs(f32.numpy() - got).max() > 1e-4


def test_bf16_flagship_training_step_matches_jax():
    jscene, tree, scene = bf16_pair(max_steps=16)
    for s in (jscene.shape, scene.shape):
        s.throughput_steps = 16
    js = jscene.shape
    js.throughput = lambda params, r_o, r_d, key=None: JSDF.throughput(
        js, params, r_o, r_d, key=None)
    img, mask = _gt()
    crop, uv = 12, (0, 2)
    exp = img[:, uv[0]:uv[0] + crop, uv[1]:uv[1] + crop]
    msk = mask[:, uv[0]:uv[0] + crop, uv[1]:uv[1] + crop]
    camera = JNeRF(cam_to_world=jnp.asarray(C2W), focal=FOCAL)

    def loss_fn(params):
        from neural_raytracing_tpu.integrators import NeRFIntegrator
        from neural_raytracing_tpu.ops.losses import masked_loss
        from neural_raytracing_tpu.render import _tile_positions
        rays = camera.sample_positions(_tile_positions(*map(float, uv), crop), size=SIZE)
        values, _, it = NeRFIntegrator(JDirect(training=True)).sample(
            jscene, params, rays, training=True)
        got = jnp.mean(values, axis=-2)
        loss = masked_loss(got[..., :3], jnp.asarray(exp), jnp.mean(it.throughput, -1),
                           jnp.asarray(msk), mask_weight=15.0)
        return loss + JT.default_extra_loss(it, got, jnp.asarray(exp), jnp.asarray(msk))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(tree)
    spec = TT.make_optimizer(LRS)
    step = TT.build_step_fn(scene, Direct(training=True), spec, size=SIZE, crop_size=crop)
    _, aux = step(TT.TrainState(scene, spec.init(scene), 0),
                  NeRFCamera(torch.from_numpy(C2W), FOCAL), uv, torch.from_numpy(exp),
                  torch.from_numpy(msk))
    np.testing.assert_allclose(aux["loss"].item(), float(jloss), rtol=1e-4)
    want_g = _flat(jgrads)
    for k, p in scene.named_parameters():
        wg = want_g[k]
        np.testing.assert_allclose(p.grad.numpy(), wg, rtol=0,
                                   atol=1e-3 * np.abs(wg).max() + 1e-12, err_msg=k)
