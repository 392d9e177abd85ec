"""Port parity: the convolutional blocks and the GAN experiment's steps.

``Discriminator`` and ``Embedder`` against ``neural_raytracing_tpu.nn.conv``
with the JAX init's params carried across, on seeded NCHW images: the
outputs (atol 1e-5) and the gradients of a seeded weighting of them to
every parameter and to the images (within 1e-4 of the leaf's max|JAX
gradient|).  Then one critic step and one generator step of
``workloads.exp_gan`` against the steps of ``scripts/exp_gan.py`` (its
``d_step``/``g_step`` loss functions, optax's Adam with ``b1=0.5``), from
the port's seeded weights carried into the JAX trees, with the JAX draws
(the far end's jitter and the sigma noise of ``PlainNeRF``) replayed into
``ops.sampling``: the losses rtol
1e-5, the gradients within 1e-4 of the leaf's max, the Adam updates within
1e-3 of the learning rate where the JAX gradient is above 1e-3 of the
leaf's max (Adam's first step is ~lr * sign(g)).  The critic is narrowed to
8 features and the generator's march to 8 steps (the workload's are 64 and
24); the views are 64x64, the critic's native size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import neural_raytracing_tpu as J
from neural_raytracing_tpu.nn import Discriminator as JDisc
from neural_raytracing_tpu.nn import Embedder as JEmbed
from neural_raytracing_tpu_torch.nn import Discriminator, Embedder
from neural_raytracing_tpu_torch.params import load_jax_params, state_dict_from_jax

torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {k: v.numpy() for k, v in state_dict_from_jax(_np(tree)).items()}


def _check_grads(module, jgrads, rel=1e-4):
    want = _flat(jgrads)
    for k, p in module.named_parameters():
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(p.grad.numpy(), want[k], rtol=0,
                                   atol=rel * scale + 1e-12, err_msg=k)


@pytest.mark.parametrize("kind,shape", [("disc", (2, 3, 64, 64)), ("embed", (3, 3, 20, 28))])
def test_conv_blocks_match_jax(kind, shape):
    jmod, mod = ((JDisc(num_features=16), Discriminator(num_features=16)) if kind == "disc"
                 else (JEmbed(latent_size=8, num_features=8), Embedder(latent_size=8,
                                                                       num_features=8)))
    params = jax.jit(jmod.init)(jax.random.PRNGKey(3))
    load_jax_params(mod, _np(params), device="cpu")
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jax.jit(jmod.__call__)(params, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = mod(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)
    weight = rng.normal(size=want.shape).astype(np.float32)
    jg, jgx = jax.jit(jax.grad(lambda p, xx: jnp.sum(jmod(p, xx) * weight), argnums=(0, 1)))(
        params, jnp.asarray(x))
    (got * torch.from_numpy(weight)).sum().backward()
    _check_grads(mod, jg)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(jgx)).max())


def test_conv_blocks_init_like_jax():
    """The port's init draws He-normal convolutions (std sqrt(2 / fan_in))
    and a zero head bias, with the JAX tree's names and shapes."""
    for jmod, mod in ((JDisc(num_features=16), Discriminator(num_features=16)),
                      (JEmbed(num_features=8), Embedder(num_features=8))):
        want = _flat(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                  jax.eval_shape(jmod.init, jax.random.PRNGKey(0))))
        mod.init(torch.Generator().manual_seed(0), device="cpu")
        got = {k: v.numpy() for k, v in mod.state_dict().items()}
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
        for k, w in got.items():
            if w.ndim == 4:
                std = np.sqrt(2.0 / np.prod(w.shape[1:]))
                assert abs(w.std() / std - 1.0) < 0.2, k
        assert not got.get("head.b", np.zeros(1)).any()


# ---- the GAN experiment's steps ---------------------------------------------------------

SIZE, N, LATENT, STEPS, NF = 64, 2, 8, 8, 8
G_LR, D_LR = 1e-4, 2e-4


@pytest.fixture(scope="module")
def jax_gan():
    """The JAX side of the steps (built once for both tests)."""
    return _jax_setup()


def _jax_setup():
    from neural_raytracing_tpu.cameras import FoVPerspectiveCamera, look_at_view_transform
    from neural_raytracing_tpu.integrators import NeRFReproduce
    from neural_raytracing_tpu.render import pathtrace_sample
    from neural_raytracing_tpu.shapes import PlainNeRF
    import neural_raytracing_tpu_torch as T
    from neural_raytracing_tpu_torch.shapes import PlainNeRF as TPlainNeRF
    from test_torch_params import jax_tree_from_port
    scene = J.Scene(shape=PlainNeRF(latent_size=LATENT, steps=STEPS))
    disc = JDisc(num_features=NF)
    # seeded weights of the port carried into the JAX trees
    g_params = jax.tree.map(jnp.asarray, jax_tree_from_port(scene, T.Scene(
        shape=TPlainNeRF(latent_size=LATENT)).init(torch.Generator().manual_seed(1), "cpu")))
    d_params = jax.tree.map(jnp.asarray, jax_tree_from_port(disc, Discriminator(
        num_features=NF).init(torch.Generator().manual_seed(2), device="cpu")))
    rng = np.random.default_rng(0)
    elev, azim = rng.uniform(0, 30, N), rng.uniform(-180, 180, N)
    r, t = look_at_view_transform(dist=2.0, elev=elev, azim=azim)
    cam = FoVPerspectiveCamera(R=r, T=t)
    latents = jax.random.normal(jax.random.PRNGKey(4), (N, LATENT))
    real = rng.uniform(size=(N, SIZE, SIZE, 3)).astype(np.float32)

    def render_fake(gp, key):                     # scripts/exp_gan.py:69-77
        p = dict(gp)
        p["shape"] = dict(p["shape"], latent=latents)
        values, _, _ = pathtrace_sample(scene, NeRFReproduce(), p, cam,
                                        (jnp.float32(0.0), jnp.float32(0.0)), key,
                                        crop_size=SIZE, bundle_size=1, size=SIZE)
        return jnp.mean(values, axis=-2)

    return dict(scene=scene, disc=disc, g_params=g_params, d_params=d_params, elev=elev,
                azim=azim, latents=np.asarray(latents), real=real, render_fake=render_fake)


def _jax_draws(key, n_draw_shape):
    """The draws of one ``render_fake(..., key)``: pathtrace_sample splits
    the key (camera, integrator), PlainNeRF splits the integrator's (the
    far end's U(0, 1), the sigma noise's N(0, 1))."""
    _, ikey = jax.random.split(key)
    tkey, nkey = jax.random.split(ikey)
    return ([np.asarray(jax.random.uniform(tkey, ()))],
            [np.asarray(jax.random.normal(nkey, n_draw_shape))])


def _replay(monkeypatch, uniforms, normals):
    """``ops.sampling.uniform``/``normal`` give the JAX draws in call order."""
    from neural_raytracing_tpu_torch.ops import sampling
    queues = {"uniform": list(uniforms), "normal": list(normals)}

    def fake(kind):
        def draw(generator, shape, device, *rest, batch_axis=None):
            value = queues[kind].pop(0)
            assert tuple(value.shape) == tuple(shape), (kind, value.shape, shape)
            return torch.from_numpy(np.array(value, np.float32)).to(device)
        return draw

    monkeypatch.setattr(sampling, "uniform", fake("uniform"))
    monkeypatch.setattr(sampling, "normal", fake("normal"))
    return queues


def _port_setup(js):
    import neural_raytracing_tpu_torch as T
    from neural_raytracing_tpu_torch.cameras import FoVPerspectiveCamera, look_at_view_transform
    from neural_raytracing_tpu_torch.shapes import PlainNeRF
    scene = T.Scene(shape=PlainNeRF(latent_size=LATENT, steps=STEPS))
    load_jax_params(scene, _np(js["g_params"]), device="cpu")
    disc = Discriminator(num_features=NF)
    load_jax_params(disc, _np(js["d_params"]), device="cpu")
    r, t = look_at_view_transform(dist=2.0, elev=js["elev"], azim=js["azim"])
    return scene, disc, FoVPerspectiveCamera(R=r, T=t)


def _check_step(module, jgrads, old, new_tree, lr):
    _check_grads(module, jgrads)
    want_g, want_p = _flat(jgrads), _flat(new_tree)
    for k, p in module.named_parameters():
        scale = np.abs(want_g[k]).max()
        sure = np.abs(want_g[k]) > 1e-3 * scale
        upd, wupd = p.detach().numpy() - old[k], want_p[k] - old[k]
        np.testing.assert_allclose(upd[sure], wupd[sure], rtol=0, atol=1e-3 * lr, err_msg=k)
        assert np.all(np.abs(upd) <= 1.01 * lr), k


@pytest.mark.parametrize("which", ["d_step", "g_step"])
def test_exp_gan_steps_match_jax(monkeypatch, jax_gan, which):
    from neural_raytracing_tpu_torch.workloads import exp_gan
    js = jax_gan
    disc, render_fake = js["disc"], js["render_fake"]
    key = jax.random.PRNGKey(9)
    to_nchw = lambda a: jnp.transpose(a, (0, 3, 1, 2))
    if which == "d_step":                         # scripts/exp_gan.py:79-88
        def loss_fn(dp):
            fake = render_fake(js["g_params"], key)
            return (jnp.mean(jax.nn.softplus(disc(dp, to_nchw(fake))))
                    + jnp.mean(jax.nn.softplus(-disc(dp, to_nchw(jnp.asarray(js["real"]))))))
        params, lr = js["d_params"], D_LR
    else:                                         # scripts/exp_gan.py:90-97
        def loss_fn(gp):
            fake = render_fake(gp, key)
            return jnp.mean(jax.nn.softplus(-disc(js["d_params"], to_nchw(fake))))
        params, lr = js["g_params"], G_LR
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    opt = optax.adam(lr, b1=0.5)
    new = jax.jit(lambda g, p: optax.apply_updates(p, opt.update(g, opt.init(p))[0]))(
        grads, params)

    scene, tdisc, cam = _port_setup(js)
    queues = _replay(monkeypatch, *_jax_draws(key, (STEPS, N, SIZE, SIZE, 1)))
    latents = torch.from_numpy(np.array(js["latents"]))
    if which == "d_step":
        module = tdisc
        old = {k: p.detach().numpy().copy() for k, p in module.named_parameters()}
        d_opt = torch.optim.Adam(tdisc.parameters(), lr=D_LR, betas=(0.5, 0.999))
        got = exp_gan.d_step(scene, tdisc, d_opt, latents, cam, torch.from_numpy(js["real"]),
                             torch.Generator(), SIZE)
    else:
        module = scene
        old = {k: p.detach().numpy().copy() for k, p in module.named_parameters()}
        g_opt = torch.optim.Adam(scene.parameters(), lr=G_LR, betas=(0.5, 0.999))
        got = exp_gan.g_step(scene, tdisc, g_opt, latents, cam, torch.Generator(), SIZE)
        assert all(p.grad is None for p in tdisc.parameters())
    assert not queues["uniform"] and not queues["normal"]
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    _check_step(module, grads, old, new, lr)
    assert scene.shape.latent is None


def test_train_gan_runs_on_the_cpu():
    """``train_gan`` on in-memory real images: finite losses, and the
    generator's weights move."""
    from neural_raytracing_tpu_torch.workloads import exp_gan
    reals = np.random.default_rng(0).uniform(size=(3, SIZE, SIZE, 3)).astype(np.float32)
    logs = []
    out = exp_gan.train_gan(reals, size=SIZE, n_views=1, iters=2, latent=LATENT,
                            device="cpu", log_every=1, log_fn=logs.append)
    assert len(out["d_losses"]) == 2 and len(logs) == 2
    assert np.all(np.isfinite(out["d_losses"] + out["g_losses"]))
    fresh, _ = exp_gan.build(LATENT, torch.Generator().manual_seed(0), "cpu")
    moved = [not torch.equal(a, b) for a, b in zip(fresh.parameters(),
                                                    out["scene"].parameters())]
    assert any(moved)
