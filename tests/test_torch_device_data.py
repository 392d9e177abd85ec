"""Port parity: the on-device data path (``device_dataset``,
``make_device_data_step``, ``train(device_data=)``).

``device_dataset``'s tables against the JAX package's exactly; the device
step at draws pinned to what the JAX device step draws from its key (the
draws are read back by repeating its ``jax.random`` calls, and handed to the
port's step through its ``draw`` hook): its crop, mask and camera equal the
host step's at the same views and corner, its loss the host step's bit for
bit, and loss and gradients the JAX device step's; 1,000 draws in range and
centred on mask pixels; three steps of ``train(device_data=)`` on the CPU
for the flagship (NeRFCamera), DTU (the packed pose and intrinsic) and NeRV
(per-view lights, AdamW's moments broadcast to them); a custom
``uv_select`` raises.

The reduced flagship of ``test_torch_params`` (8 spheres, nets 16 wide,
``max_steps`` and ``throughput_steps`` 16) on 4 views of the analytic
sphere of ``test_torch_training`` at 16x16, crops 12x12.  As in
``test_torch_train_step`` the JAX SDF's ``throughput`` is swapped for a
keyless one, and the port's step runs without a generator.
The JAX step's gradients are read back from its state: it is built with
``grad_capture``, whose update is zero and whose state is the gradient.
Tolerances: the loss rtol 1e-5 against JAX; each component's gradient
(shape, bsdf, lights) within 8e-5 relative L2 of JAX's.  The device step
equals the host step bit for bit, so its distance from JAX is the host
step's (float32 sums in another order through the march, the min-scan and
the eikonal double backward).  The readings it was set from (shape, bsdf,
lights): seed 0 1.6e-7, 2.6e-6, 1.4e-6; seed 3 2.3e-7, 5.7e-5, 3.9e-5
(one lobe's first bias differs by 1.7e-4 of its largest gradient, over
``test_torch_train_step``'s per-leaf 1e-4 at its own crop);
``test_torch_dtu_workload``'s DTU step 1.2e-7, 1.3e-6, 1.7e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_raytracing_tpu.training as JT
from neural_raytracing_tpu.cameras import DTUCamera as JDTUCamera
from neural_raytracing_tpu.cameras import NeRFCamera as JNeRF
from neural_raytracing_tpu.integrators import Direct as JDirect
from neural_raytracing_tpu.shapes import SDF as JSDF
import neural_raytracing_tpu_torch.training as T
from neural_raytracing_tpu_torch.cameras import DTUCamera, NeRFCamera
from neural_raytracing_tpu_torch.integrators import Direct
from neural_raytracing_tpu_torch.render import _tile_positions
from neural_raytracing_tpu_torch.training.loop import draw_crop, gather_crop
from neural_raytracing_tpu_torch.workloads import make_dtu_dataset
from test_torch_occlusion import nerv_pair
from test_torch_params import scene_pair
from test_torch_training import C2W, FOCAL, LRS, SIZE, _flat, _gt

torch.set_num_threads(1)
CROP, N_VIEWS = 12, 2


def _split():
    """4 views of the analytic sphere and their cameras."""
    img, mask = _gt()
    imgs = np.concatenate([img, img[:, ::-1]])
    masks = np.concatenate([mask, mask[:, ::-1]])
    c2ws = np.concatenate([C2W, C2W[::-1]])
    return imgs, masks, c2ws


def _masks_with_an_empty_view():
    rng = np.random.default_rng(2)
    masks = (rng.uniform(size=(4, 16, 16)) > 0.7).astype(np.float32)
    masks[2] = 0.0
    return masks


@pytest.mark.parametrize("max_mask_px", [None, 5])
def test_device_dataset_matches_jax(max_mask_px):
    rng = np.random.default_rng(1)
    imgs = rng.uniform(size=(4, 16, 16, 4)).astype(np.float32)
    masks = _masks_with_an_empty_view()
    locs = rng.normal(size=(4, 3)).astype(np.float32)
    packed = rng.normal(size=(4, 2, 4, 4)).astype(np.float32)    # DTU's pose + intrinsic
    got = T.device_dataset(imgs, masks, packed, CROP, light_locs=locs,
                           max_mask_px=max_mask_px, device="cpu")
    want = JT.device_dataset(imgs, masks, packed, CROP, light_locs=locs,
                             max_mask_px=max_mask_px)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        assert got[k].device.type == "cpu"
    assert got["images"].shape == (4, 16, 16, 3) and got["mask_counts"][2] == 1
    assert "light_locs" not in T.device_dataset(imgs, masks, packed, CROP, device="cpu")


def test_draws_stay_in_range_and_centre_on_mask_pixels():
    imgs = np.zeros((4, 16, 16, 3), np.float32)
    masks = _masks_with_an_empty_view()
    data = T.device_dataset(imgs, masks, np.zeros((4, 3, 4), np.float32), CROP,
                            device="cpu")
    half, top = CROP // 2, 16 - CROP
    corners = [{(int(np.clip(y - half, 0, top)), int(np.clip(x - half, 0, top)))
                for y, x in zip(*np.nonzero(m > 0.5))} or {(0, 0)} for m in masks]
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(1000):
        idxs, u, w = draw_crop(data, gen, n_views=3, size=16, crop_size=CROP)
        assert idxs.shape == (3,) and 0 <= idxs.min() and idxs.max() < 4
        assert (int(u), int(w)) in corners[int(idxs[0])]
        seen.add(int(idxs[0]))
    assert seen == {0, 1, 2, 3}
    for _ in range(200):
        idxs, u, w = draw_crop(data, gen, n_views=3, size=16, crop_size=CROP,
                               mask_crops=False)
        assert 0 <= int(u) <= top and 0 <= int(w) <= top


# ---- the device step at pinned draws --------------------------------------------------

def _jax_draws(jdata, key, n_views, size, crop):
    """What the JAX device step draws from ``key`` (training/loop.py:224-233)."""
    kv, ku, _ = jax.random.split(key, 3)
    idxs = jax.random.randint(kv, (n_views,), 0, jdata["images"].shape[0])
    j = jax.random.randint(ku, (), 0, jdata["mask_counts"][idxs[0]])
    yx = jdata["mask_px"][idxs[0], j]
    half = crop // 2
    return (np.array(idxs), int(jnp.clip(yx[0] - half, 0, size - crop)),
            int(jnp.clip(yx[1] - half, 0, size - crop)))


def _keyless(jscene):
    js = jscene.shape
    js.throughput = lambda params, r_o, r_d, key=None: JSDF.throughput(
        js, params, r_o, r_d, key=None)


def grad_capture():
    """An optax transformation whose update is zero and whose state is the
    gradient it was handed: a JAX step built with it leaves its gradients in
    ``state.opt_state``."""
    import optax
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


@functools.lru_cache(maxsize=None)
def _jax_step():
    """The JAX device step (built once, so both seeds share one compile),
    its data and the initial state."""
    jscene, tree, _ = scene_pair(max_steps=16)
    jscene.shape.throughput_steps = 16
    _keyless(jscene)
    imgs, masks, c2ws = _split()
    jdata = JT.device_dataset(imgs, masks, c2ws, CROP)
    jopt = grad_capture()
    jdstep = JT.make_device_data_step(jscene, JDirect(training=True), jopt,
                                      lambda c: JNeRF(cam_to_world=c, focal=FOCAL),
                                      n_views=N_VIEWS, size=SIZE, crop_size=CROP,
                                      donate=False)
    return tree, jdata, jdstep, JT.TrainState(tree, jopt.init(tree), jnp.int32(0))


@functools.lru_cache(maxsize=None)
def _jax_case(seed):
    """The JAX device step from ``PRNGKey(seed)``: its draws, loss and
    gradients."""
    tree, jdata, jdstep, state = _jax_step()
    key = jax.random.PRNGKey(seed)
    jstate, jaux = jdstep(state, jdata, key)
    return (tree, _jax_draws(jdata, key, N_VIEWS, SIZE, CROP), float(jaux["loss"]),
            _flat(jstate.opt_state))


def _rel_l2(scene, want, component):
    names = [k for k, _ in scene.named_parameters() if k.startswith(component + ".")]
    got = np.concatenate([scene.get_parameter(k).grad.numpy().ravel() for k in names])
    ref = np.concatenate([want[k].ravel() for k in names])
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("seed", [0, 3])
def test_device_step_matches_the_host_step_and_jax_at_pinned_draws(seed):
    tree, (idxs, u, w), jloss, jgrads = _jax_case(seed)
    imgs, masks, c2ws = _split()
    data = T.device_dataset(imgs, masks, c2ws, CROP, device="cpu")
    builder = lambda c: NeRFCamera(c, FOCAL)
    seen = {}

    def builder_seen(c):
        seen["camera"] = builder(c)
        return seen["camera"]

    pinned = lambda data, generator: (torch.as_tensor(idxs), torch.tensor(u), torch.tensor(w))
    # the crop, mask and camera the device step builds are the host step's
    got_exp, got_mask = gather_crop(data, *pinned(data, None), CROP)
    assert torch.equal(got_exp, torch.from_numpy(imgs[idxs, u:u + CROP, w:w + CROP, :3]))
    assert torch.equal(got_mask, torch.from_numpy(masks[idxs, u:u + CROP, w:w + CROP]))
    results = {}
    for path in ("device", "host"):
        _, _, scene = scene_pair(max_steps=16)
        scene.shape.throughput_steps = 16
        spec = T.make_optimizer(LRS)
        state = T.TrainState(scene, spec.init(scene), 0)
        if path == "device":
            dstep = T.make_device_data_step(scene, Direct(training=True), spec, builder_seen,
                                            n_views=N_VIEWS, size=SIZE, crop_size=CROP,
                                            draw=pinned)
            state, aux = dstep(state, data, None)
        else:
            step = T.build_step_fn(scene, Direct(training=True), spec, size=SIZE,
                                   crop_size=CROP)
            state, aux = step(state, NeRFCamera(torch.from_numpy(c2ws[idxs]), FOCAL), (u, w),
                              torch.from_numpy(imgs[idxs, u:u + CROP, w:w + CROP, :3]),
                              torch.from_numpy(masks[idxs, u:u + CROP, w:w + CROP]))
        assert state.step == 1
        results[path] = (aux["loss"].item(), scene)
    assert torch.equal(seen["camera"].cam_to_world, torch.from_numpy(c2ws[idxs]))
    (dloss, dscene), (hloss, hscene) = results["device"], results["host"]
    assert dloss == hloss
    for (k, p), q in zip(dscene.named_parameters(), hscene.parameters()):
        assert torch.equal(p.grad, q.grad), k
        assert torch.equal(p, q), k
    np.testing.assert_allclose(dloss, jloss, rtol=1e-5)
    for c in ("shape", "bsdf", "lights"):
        assert _rel_l2(dscene, jgrads, c) <= 8e-5, c


# ---- train(device_data=) on the CPU ----------------------------------------------------

def _dtu_data():
    """A DTU split from the generator's cameras at 16x16 (its source size
    matched) over 4 views of random ground truth with square masks."""
    _, cams = make_dtu_dataset.scan_cameras(4, SIZE)
    rng = np.random.default_rng(4)
    imgs = rng.uniform(size=(4, SIZE, SIZE, 3)).astype(np.float32)
    masks = np.zeros((4, SIZE, SIZE), np.float32)
    masks[:, 4:12, 3:11] = 1.0
    return T.dtu_dataset(cams, imgs, masks, SIZE, src_size=(SIZE, SIZE))


@pytest.mark.parametrize("workload", ["flagship", "dtu", "nerv"])
def test_train_with_device_data_on_the_cpu(workload):
    kw = {}
    if workload == "nerv":
        _, _, scene = nerv_pair()
        imgs, masks, c2ws = _split()
        locs = np.asarray([[0.5, 1.0, 1.0], [1.0, 0.5, 1.0], [-0.5, 1.0, 0.8],
                           [0.0, 1.5, 0.0]], np.float32)
        data = T.device_dataset(imgs, masks, c2ws, CROP, light_locs=locs, device="cpu")
        builder = lambda c: NeRFCamera(c, FOCAL)
        kw = dict(tone_mapping=True)
    elif workload == "dtu":
        _, _, scene = scene_pair(max_steps=16)
        d = _dtu_data()
        imgs, masks = d.images, d.masks
        packed = np.stack([d.poses, d.intrinsics], axis=1)
        data = T.device_dataset(imgs, masks, packed, CROP, device="cpu")
        builder = lambda c: DTUCamera(c[:, 0], c[:, 1], d.src_size)
        # the packed pair builds the camera the host path builds
        cam = builder(data["c2ws"][torch.tensor([2, 0])])
        jcam = JDTUCamera(pose=jnp.asarray(d.poses[[2, 0]]),
                          intrinsic=jnp.asarray(d.intrinsics[[2, 0]]),
                          src_size=jnp.asarray(d.src_size, jnp.float32))
        pos = _tile_positions(1, 2, CROP, "cpu")
        np.testing.assert_allclose(cam.sample_positions(pos, size=SIZE).numpy(),
                                   np.asarray(jcam.sample_positions(
                                       jnp.asarray(pos.numpy()), size=SIZE)), atol=1e-6)
        kw = dict(mask_weight=10.0)
    else:
        _, _, scene = scene_pair(max_steps=16)
        imgs, masks, c2ws = _split()
        data = T.device_dataset(imgs, masks, c2ws, CROP, device="cpu")
        builder = lambda c: NeRFCamera(c, FOCAL)
    scene.shape.throughput_steps = 16
    spec = T.make_optimizer(dict(LRS, occ=8e-5))
    state = T.init_train_state(scene, spec, device="cpu")
    before = {k: v.clone() for k, v in scene.state_dict().items()}
    metrics = []
    state, losses = T.train(
        scene, Direct(training=True), spec, state, None, None, None,
        torch.Generator().manual_seed(1), size=SIZE, crop_size=CROP, iters=3,
        n_views=3, log_every=0, metrics=metrics, uv_select=T.rand_uv_mask,
        device_data=data, camera_builder=builder, **kw)
    assert state.step == 3 and len(losses) == 3 and np.isfinite(losses).all()
    assert [m["step"] for m in metrics] == [0, 1, 2]
    changed = [k for k, v in scene.state_dict().items() if not torch.equal(before[k], v)]
    assert any(k.startswith("shape.") for k in changed)
    if workload == "nerv":
        # the last step's three views' lights (one AdamW step from the
        # data's), and AdamW's moments in step
        loc = scene.lights.location.detach().numpy()
        assert loc.shape == (3, 3)
        for row in loc:
            assert np.abs(locs - row).max(-1).min() <= 2 * LRS["lights"]
        st = state.optimizer.state[scene.lights.location]
        assert st["exp_avg"].shape == st["exp_avg_sq"].shape == (3, 3)


def test_device_data_rejects_a_custom_uv_select():
    _, _, scene = scene_pair(max_steps=16)
    imgs, masks, c2ws = _split()
    data = T.device_dataset(imgs, masks, c2ws, CROP, device="cpu")
    spec = T.make_optimizer(LRS)
    state = T.init_train_state(scene, spec, device="cpu")
    with pytest.raises(ValueError, match="uv_select"):
        T.train(scene, Direct(training=True), spec, state, None, None, None, size=SIZE,
                crop_size=CROP, iters=1, uv_select=lambda rng, m, s: (0, 0),
                device_data=data, camera_builder=lambda c: NeRFCamera(c, FOCAL))
