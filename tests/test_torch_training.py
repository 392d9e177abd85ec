"""Port parity: the optimizer, the view sampler and crops, the checkpoint
codec; then ``train`` and ``evaluate`` on the CPU (the step as a whole is
``test_torch_train_step``).

``train`` runs the reduced flagship of ``test_torch_params`` on 4 views of
an analytic sphere (16x16, crops 12x12).
Tolerances: AdamW updates rtol 1e-5 / atol 1e-7 against optax (the same
formula in another order); the clip and the norm rtol 1e-6; ``evaluate``'s
metrics rtol 1e-4 against the JAX ``evaluate`` on the same params.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import neural_raytracing_tpu.training as JT
from neural_raytracing_tpu.cameras import NeRFCamera as JNeRF
from neural_raytracing_tpu.integrators import Direct as JDirect
import neural_raytracing_tpu_torch.training as T
from neural_raytracing_tpu_torch.cameras import NeRFCamera, nerf_c2w
from neural_raytracing_tpu_torch.integrators import Direct
from neural_raytracing_tpu_torch.params import state_dict_from_jax
from neural_raytracing_tpu_torch.training import flax_msgpack
from test_torch_params import build_scene, scene_pair

torch.set_num_threads(1)
SIZE, CROP = 16, 12
FOCAL = 0.5 * SIZE / np.tan(0.5 * 0.6911)
C2W = np.stack([nerf_c2w(30, 45, 1.0), nerf_c2w(10, 160, 1.0)])[:, :3].astype(np.float32)
LRS = {"shape": 8e-5, "bsdf": 8e-4, "lights": 8e-5}
ARTIFACTS = "scripts/models_seed_dir/nerv_mesh_gear_mirror200b"


def _flat(tree):
    return {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree.map(np.asarray, tree)).items()}


# ---- optimizer ---------------------------------------------------------------

def _random_grads(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)


@pytest.mark.parametrize("clip_norm", [None, 10.0])
def test_adamw_per_component_matches_optax(clip_norm):
    jscene, tree, scene = scene_pair()
    jopt = JT.make_optimizer(LRS, clip_norm=clip_norm)
    jstate = jopt.init(tree)
    params = jax.tree.map(jnp.asarray, tree)
    spec = T.make_optimizer(LRS, clip_norm=clip_norm)
    opt = spec.init(scene)
    assert {g["name"]: g["lr"] for g in opt.param_groups} == LRS
    assert all(g["weight_decay"] == 0.0 for g in opt.param_groups)
    named = dict(scene.named_parameters())
    for step in range(2):
        grads = _random_grads(tree, step)
        grads = jax.tree.map(lambda g: g * 3.0, grads)    # global norm >> 10
        for sub in ("shape", "bsdf", "lights"):            # frozen bases
            grads[sub] = jax.tree_util.tree_map_with_path(
                lambda p, g: g * 0 if p[-1] == jax.tree_util.DictKey("B") else g,
                grads[sub])
        updates, jstate = jopt.update(grads, jstate, params)
        params = optax.apply_updates(params, updates)
        flat = _flat(grads)
        for k, p in named.items():
            p.grad = torch.from_numpy(flat[k].copy())
        if clip_norm is not None:
            T.clip_grads(list(named.values()), clip_norm)
        opt.step()
    want = _flat(params)
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for k, b in scene.named_buffers():
        np.testing.assert_array_equal(b.numpy(), want[k])


@pytest.mark.parametrize("scale", [0.01, 100.0])
def test_global_norm_clip_formula(scale):
    rng = np.random.default_rng(5)
    gs = [rng.normal(size=s).astype(np.float32) * scale for s in [(4, 3), (7,), (2, 2, 2)]]
    want_norm = optax.global_norm(gs)
    want, _ = optax.clip_by_global_norm(1.0).update(gs, None)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    for p, g in zip(params, gs):
        p.grad = torch.from_numpy(g.copy())
    np.testing.assert_allclose(T.global_norm([p.grad for p in params]).item(),
                               float(want_norm), rtol=1e-6)
    T.clip_grads(params, 1.0)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=0)


# ---- views, crops, checkpoints -------------------------------------------------

def test_loss_sampler_and_crops_match():
    a, b = JT.LossSampler(7), T.LossSampler(7)
    for i in range(5):
        ia, ib = a.sample(n=3), b.sample(n=3)
        np.testing.assert_array_equal(ia, ib)
        a.update_idxs(ia, 10.0 * i)
        b.update_idxs(ib, 10.0 * i)
    np.testing.assert_array_equal(a.losses, b.losses)
    mask = np.zeros((32, 32), np.float32)
    mask[10:14, 20:25] = 1
    for fn_j, fn_t, args in ((JT.rand_uv, T.rand_uv, (32, 32, 8)),
                             (JT.rand_uv_mask, T.rand_uv_mask, (mask, 8)),
                             (JT.rand_uv_mask, T.rand_uv_mask, (0 * mask, 8))):
        rj, rt = np.random.default_rng(3), np.random.default_rng(3)
        assert [fn_j(rj, *args) for _ in range(6)] == [fn_t(rt, *args) for _ in range(6)]


@pytest.mark.parametrize("comp", ["shape", "bsdf", "lights", "occ"])
def test_codec_reads_the_jax_artifacts(comp):
    data = open(f"{ARTIFACTS}/{comp}.msgpack", "rb").read()
    got = flax_msgpack.restore(data)
    want = serialization.msgpack_restore(data)
    lw = jax.tree_util.tree_leaves_with_path(want)
    lg = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in lw] == [p for p, _ in lg] and len(lw) > 0
    for (_, a), (_, b) in zip(lw, lg):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert flax_msgpack.serialize(got) == data


def test_port_artifacts_restore_in_flax(tmp_path):
    jscene, tree, scene = scene_pair()
    T.save_scene(str(tmp_path), scene, step=7, meta={"cell": "test"})
    assert json.load(open(tmp_path / "meta.json")) == {"step": 7, "cell": "test"}
    for comp in ("shape", "bsdf", "lights"):
        data = (tmp_path / f"{comp}.msgpack").read_bytes()
        restored = serialization.from_bytes(tree[comp], data)
        for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(tree[comp]),
                                    jax.tree_util.tree_leaves_with_path(restored)):
            assert pa == pb
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not (tmp_path / "occ.msgpack").exists()
    # and the port reads them back into a fresh scene
    fresh = build_scene("torch").init(torch.Generator().manual_seed(9), device="cpu")
    T.load_scene(str(tmp_path), fresh)
    for k, v in scene.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_train_state_round_trip(tmp_path):
    _, _, scene = scene_pair()
    opt = T.make_optimizer(LRS).init(scene)
    for p in scene.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    T.save_train_state(str(tmp_path / "state.pt"), scene, opt, 5)
    _, _, other = scene_pair()
    other_opt = T.make_optimizer(LRS).init(other)
    assert T.load_train_state(str(tmp_path / "state.pt"), other, other_opt) == 5
    for k, v in scene.state_dict().items():
        assert torch.equal(other.state_dict()[k], v)
    assert other_opt.state_dict()["state"][0]["step"] == 1


# ---- train and evaluate ---------------------------------------------------------

def _gt(seed=0):
    """Analytic GT: a diffuse-looking sphere of radius 0.25 over 2 views."""
    cam = NeRFCamera(torch.from_numpy(C2W), FOCAL)
    from neural_raytracing_tpu_torch.render import _tile_positions
    rays = cam.sample_positions(_tile_positions(0.0, 0.0, SIZE, "cpu"), size=SIZE)
    r_o, r_d = rays[..., 0, :3].numpy(), rays[..., 0, 3:].numpy()
    b = np.sum(r_o * r_d, -1)
    disc = b * b - (np.sum(r_o * r_o, -1) - 0.25 ** 2)
    mask = (disc > 0).astype(np.float32)
    t = -b - np.sqrt(np.maximum(disc, 0))
    n = r_o + t[..., None] * r_d
    shade = np.clip(n @ np.asarray([0.3, 0.8, 0.5]) / 0.25, 0, 1)
    rng = np.random.default_rng(seed)
    img = mask[..., None] * (0.2 + 0.6 * shade[..., None] * rng.uniform(0.5, 1, 3))
    return img.astype(np.float32), mask



def _train_setup():
    img, mask = _gt()
    imgs = np.concatenate([img, img[::-1]])
    masks = np.concatenate([mask, mask[::-1]])
    c2ws = np.concatenate([C2W, C2W[::-1]])
    _, _, scene = scene_pair(max_steps=16)
    scene.shape.throughput_steps = 16
    make_camera = lambda idxs: NeRFCamera(torch.from_numpy(c2ws[np.asarray(idxs)]), FOCAL)
    return scene, imgs, masks, make_camera


def test_train_and_evaluate_on_the_cpu(tmp_path):
    scene, imgs, masks, make_camera = _train_setup()
    spec = T.make_optimizer(LRS, clip_norm=10.0)
    state = T.init_train_state(scene, spec, device="cpu")
    before = {k: v.clone() for k, v in scene.state_dict().items()}
    metrics, valid, saved, logs = [], [], [], []
    state, losses = T.train(
        scene, Direct(training=True), spec, state, make_camera, imgs, masks,
        torch.Generator().manual_seed(0), size=SIZE, crop_size=CROP, iters=3,
        n_views=2, log_every=1, log_fn=logs.append, metrics=metrics,
        uv_select=T.rand_uv_mask, valid_freq=2,
        valid_fn=lambda st, i: valid.append(i), ckpt_freq=2,
        save_fn=lambda st, i: T.save_scene(str(tmp_path / f"s{i}"), st.scene, i))
    assert state.step == 3 and len(losses) == 3 and np.isfinite(losses).all()
    assert [m["step"] for m in metrics] == [0, 1, 2] and len(logs) == 3
    assert valid == [0, 2] and (tmp_path / "s2" / "shape.msgpack").exists()
    assert any(not torch.equal(before[k], v) for k, v in scene.state_dict().items())
    out = T.evaluate(scene, lambda i: make_camera([i]), imgs[:2], Direct(training=False),
                     size=SIZE, chunk_size=8, log_fn=lambda s: None, with_ms_ssim=False)
    assert set(out) == {"l1", "l2", "psnr", "ssim"}
    assert all(np.isfinite(v) for v in out.values())


def test_evaluate_matches_the_jax_protocol(monkeypatch):
    import functools
    import neural_raytracing_tpu as J
    from neural_raytracing_tpu.training import eval as jeval
    # no jitter on either side: compare the metrics, not the noise
    monkeypatch.setattr(jeval, "pathtrace", functools.partial(J.pathtrace, with_noise=False))
    jscene, tree, scene = scene_pair(max_steps=16)
    img, mask = _gt()
    kw = dict(size=SIZE, chunk_size=8, masks=mask, tone_map=True, log_fn=lambda s: None)
    got = T.evaluate(scene, lambda i: NeRFCamera(torch.from_numpy(C2W[i:i + 1]), FOCAL),
                     img, Direct(training=False), key=None, **kw)
    want = JT.evaluate(jscene, tree, lambda i: JNeRF(cam_to_world=jnp.asarray(C2W[i:i + 1]),
                                                     focal=FOCAL),
                       img, JDirect(training=False), **kw)
    for k in ("l1", "l2", "psnr", "ssim"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("policy", ["raise", "skip"])
def test_nan_policy(policy):
    scene, imgs, masks, make_camera = _train_setup()
    spec = T.make_optimizer(LRS)
    state = T.init_train_state(scene, spec, device="cpu")
    before = {k: v.clone() for k, v in scene.state_dict().items()}
    kw = dict(size=SIZE, crop_size=CROP, iters=2, n_views=2, log_every=0,
              log_fn=lambda s: None, nan_policy=policy,
              extra_loss=lambda it, got, exp, mask: float("nan"))
    if policy == "raise":
        with pytest.raises(FloatingPointError):
            T.train(scene, Direct(training=True), spec, state, make_camera, imgs,
                    masks, **kw)
        return
    state, losses = T.train(scene, Direct(training=True), spec, state, make_camera,
                            imgs, masks, **kw)
    assert state.step == 0 and losses == []
    assert not state.optimizer.state     # AdamW never stepped
    for k, v in scene.state_dict().items():
        assert torch.equal(before[k], v), k


@pytest.mark.parametrize("option", ["mesh", "device_data"])
def test_unported_train_options_raise(option):
    """mesh= trains data-parallel (tests/test_torch_parallel.py) but takes no
    device_data=, a single-device path (as scripts/nerf_synthetic.py
    asserts); device_data= is ported (tests/test_torch_device_data.py), and
    without its camera_builder it raises."""
    from neural_raytracing_tpu_torch.parallel import make_mesh
    scene, imgs, masks, make_camera = _train_setup()
    spec = T.make_optimizer(LRS)
    state = T.init_train_state(scene, spec, device="cpu")
    if option == "mesh":
        kw, match = dict(mesh=make_mesh(device="cpu"), device_data={}), "single-device"
    else:
        kw, match = dict(device_data=object()), "camera_builder"
    with pytest.raises(ValueError, match=match):
        T.train(scene, Direct(training=True), spec, state, make_camera, imgs, masks,
                size=SIZE, crop_size=CROP, iters=1, **kw)
