"""Training step and host loop.

Counterpart of ``neural_raytracing_tpu/training/loop.py``: the loss sampler
picks views, a crop is drawn, ``NeRFIntegrator(integrator)`` renders the
crop with primary (throughput-carrying) intersections, ``masked_loss`` plus
the eikonal term is minimised by AdamW.

The JAX step is one jitted pure function; here the step updates the
scene's parameters and the optimizer in place, eagerly or, on the card, as
one CUDA graph replayed each step (``step_graph.GraphedStep``).
``TrainState`` carries the scene, the ``torch.optim.AdamW`` and the
applied-step count.
The loop resolves each step's loss one step behind, so the host queues the
next step before it waits for the card.

The on-device data path (``device_dataset``, ``make_device_data_step``,
``train(device_data=)``) keeps the training split on the scene's device and
draws the views, the crop and the camera batch there, so a step makes no
host-to-device copy and no wait for the card of its own.

``train(mesh=)`` trains data-parallel over the ranks of a
``parallel.Mesh``: one process a device (``parallel/mesh.py``).
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import profiling
from ..integrators import NeRFIntegrator
from ..ops.losses import masked_loss
from ..ops.math import eikonal_loss
from ..render import pathtrace_sample
from .loss_sampler import LossSampler
from .optim import broadcast_state, clip_grads, global_norm
from .step_graph import GraphedStep


class TrainState(NamedTuple):
    scene: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int


def init_train_state(scene, optimizer_config, generator=None,
                     device="cuda") -> TrainState:
    """Draw the scene's parameters from ``generator`` (if given), move it to
    ``device`` and build its optimizer."""
    if generator is not None:
        scene.init(generator, device=device)
    else:
        scene.to(device)
    return TrainState(scene, optimizer_config.init(scene), 0)


def default_extra_loss(it, got, exp, mask):
    """Eikonal regularizer on the raw SDF gradients."""
    if it.raw_normals is None:
        return 0.0
    return eikonal_loss(it.raw_normals)


def build_step_fn(scene, integrator, optimizer_config, *, size: int,
                  crop_size: int, bundle_size: int = 1,
                  mask_weight: float = 15.0, tone_mapping: bool = False,
                  with_ssim: bool = True, with_noise=False,
                  extra_loss: Callable = default_extra_loss,
                  space_reg: Optional[Callable] = None,
                  n_real_views: Optional[int] = None,
                  skip_nan_updates: bool = False, mesh=None):
    """The step ``(state, camera, uv, exp, mask, generator) -> (state, aux)``.

    ``exp``/``mask`` are the ``[N, S, S, 3]`` / ``[N, S, S]`` ground-truth crop
    on the scene's device, ``uv`` the crop offset, ``camera`` a camera batch;
    ``generator`` (optional) draws the camera jitter and the throughput
    jitter.  ``aux`` holds the loss and the rendered crop, not synchronised.
    With ``skip_nan_updates`` a step whose loss or gradient norm is not
    finite keeps the parameters and the optimizer state and does not advance
    the count; that check waits for the card.
    ``space_reg(scene, generator) -> scalar`` (optional) is added to the
    loss: a regularizer at fresh random points each step (the JAX
    ``space_reg(params, key)``).
    ``n_real_views``: the view axis may be padded (``parallel.pad_batch``);
    the loss, ``extra_loss`` included, runs on the first ``n_real_views``
    views only, so padded views contribute no gradient.
    ``mesh`` (a ``parallel.Mesh``; ``parallel.make_parallel_train_step``
    sets it, with ``n_real_views``): every rank passes the whole batch,
    renders its shard of the padded view axis, gathers the rendered views
    and computes the loss on all of them; the parameter gradients are
    all-reduced by their mean before clipping, the finite check and AdamW.
    The step's spans are ``nrt.step.zero_grad``, ``nrt.step.render``,
    ``nrt.step.loss``, ``nrt.step.backward`` and ``nrt.step.optimizer``.
    Without a mesh and without ``skip_nan_updates`` the step is a
    ``step_graph.GraphedStep``: on a CUDA scene it is captured in a CUDA
    graph at its second call and replayed from the third on (its spans are
    then ``nrt.step.graph``); everywhere else it runs eagerly.
    """
    from ..parallel.mesh import gather_views, padded_size, reduce_grads, shard_batch
    train_integrator = NeRFIntegrator(integrator)
    clip_norm = optimizer_config.clip_norm
    if mesh is not None and n_real_views is None:
        raise ValueError("a mesh step needs n_real_views, the views of its batch")

    def render(scene_, camera, uv, generator):
        kw = dict(crop_size=crop_size, bundle_size=bundle_size, size=size,
                  with_noise=with_noise)
        if mesh is None:
            return pathtrace_sample(scene_, train_integrator, camera, uv, generator, **kw)
        padded = padded_size(n_real_views, mesh.size)
        n_local = padded // mesh.size
        out = pathtrace_sample(scene_, train_integrator, shard_batch(camera, mesh, n_real_views),
                               uv, generator, shard=(mesh.rank, n_local, padded), **kw)
        return gather_views(out, mesh, n_local)

    def step(state: TrainState, camera, uv, exp, mask, generator=None):
        scene_, opt = state.scene, state.optimizer
        params = [p for group in opt.param_groups for p in group["params"]]
        with profiling.annotate("nrt.step.zero_grad"):
            # zeros, not None: AdamW then updates every parameter each step, as
            # optax does, also one that no gradient reaches (Conductor's k) or
            # whose gradient a shape change dropped
            opt.zero_grad(set_to_none=False)
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        with profiling.annotate("nrt.step.render"):
            values, _, it = render(scene_, camera, uv, generator)
        with profiling.annotate("nrt.step.loss"):
            got = values.mean(dim=-2)                       # over the bundle
            throughput = it.throughput.mean(dim=-1)
            if n_real_views is not None:
                n_padded = got.shape[0]
                got, throughput, it = (got[:n_real_views], throughput[:n_real_views],
                                       _views(it, n_padded, n_real_views))
                exp, mask = exp[:n_real_views], mask[:n_real_views]
            loss = masked_loss(got[..., :3], exp, throughput, mask,
                               mask_weight=mask_weight, tone_mapping=tone_mapping,
                               with_ssim=with_ssim)
            loss = loss + extra_loss(it, got, exp, mask)
            if space_reg is not None:
                loss = loss + space_reg(scene_, generator)
        with profiling.annotate("nrt.step.backward"):
            loss.backward()
        with profiling.annotate("nrt.step.optimizer"):
            if mesh is not None:
                reduce_grads(params, mesh)
            if clip_norm is not None:
                clip_grads(params, clip_norm)
            if skip_nan_updates:
                good = bool(torch.isfinite(loss) & torch.isfinite(
                    global_norm([p.grad for p in params])))
                if not good:
                    return state, {"loss": loss.detach(), "got": got.detach()}
            broadcast_state(opt)
            with warnings.catch_warnings():
                # on the card ``AdamWConfig.init`` makes AdamW capturable,
                # for the step's CUDA graph: an eager step means to step it
                # uncaptured
                warnings.filterwarnings("ignore", "This instance was constructed with "
                                        "capturable=True")
                opt.step()
        return (TrainState(scene_, opt, state.step + 1),
                {"loss": loss.detach(), "got": got.detach()})

    if mesh is None and not skip_nan_updates:
        return GraphedStep(step, clip_norm)
    return step


def _views(tree, n_padded: int, n: int):
    """The first ``n`` views of the leaves of a NamedTuple whose leading
    axis is ``n_padded``."""
    return type(tree)(*(v[:n] if isinstance(v, torch.Tensor) and v.dim() >= 1
                        and v.shape[0] == n_padded else v for v in tree))


def make_train_step(scene, integrator, optimizer_config, donate: bool = True, **kwargs):
    """The single-device training step (``build_step_fn``).  The JAX
    package jits the step and may donate the train state's buffers; the
    port's step updates the scene and the optimizer in place, so
    ``donate`` is accepted and changes nothing."""
    del donate
    return build_step_fn(scene, integrator, optimizer_config, **kwargs)


def device_dataset(images, masks, cam_to_worlds, crop_size: int,
                   light_locs=None, max_mask_px: Optional[int] = None,
                   device="cuda") -> dict:
    """A training split packed for the on-device data path (see
    ``make_device_data_step``): a dict of tensors on ``device``.

    ``mask_px`` ``[V, cap, 2]`` holds each view's mask pixels ``(y, x)``
    (``np.nonzero(mask > 0.5)``, at most ``max_mask_px`` of them, evenly
    spaced over the list), zero-padded to the longest; ``mask_counts`` ``[V]``
    how many are real (1 for an empty mask, whose crop is then the corner).
    ``c2ws`` is whatever the camera builder reads per view (``[V, 3, 4]``
    poses, or DTU's packed ``[V, 2, 4, 4]`` pose and intrinsic);
    ``light_locs`` (optional) ``[V, 3]`` per-view point lights.  The crop
    size is the caller's, kept for the JAX signature.
    """
    del crop_size
    host_masks = np.asarray(masks)
    coords = [np.nonzero(m > 0.5) for m in host_masks]
    cap = max(len(ys) for ys, _ in coords)
    cap = max(1, cap if max_mask_px is None else min(cap, max_mask_px))
    px = np.zeros((len(coords), cap, 2), np.int64)
    counts = np.ones(len(coords), np.int64)
    for i, (ys, xs) in enumerate(coords):
        n = min(len(ys), cap)
        if n:
            sel = np.linspace(0, len(ys) - 1, n).astype(np.int64)
            px[i, :n, 0] = ys[sel]
            px[i, :n, 1] = xs[sel]
            counts[i] = n
    as_f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
    data = {
        "images": as_f32(np.asarray(images)[..., :3]),
        "masks": as_f32(host_masks),
        "c2ws": as_f32(cam_to_worlds),
        "mask_px": torch.as_tensor(px, device=device),
        "mask_counts": torch.as_tensor(counts, device=device),
    }
    if light_locs is not None:
        data["light_locs"] = as_f32(light_locs)
    return data


def draw_crop(data: dict, generator: Optional[torch.Generator], *, n_views: int,
              size: int, crop_size: int, mask_crops: bool = True):
    """The device step's draws -> ``(idxs [n_views], u, w)``, all on the
    data's device: ``n_views`` uniform view indices, then the crop corner,
    centred on a uniform mask pixel of the first view and clipped to ``[0,
    size - crop_size]`` (``rand_uv_mask``), or uniform.  The draws wait for
    nothing: the mask pixel's index is ``floor(U * count)`` with ``U`` a
    float64 uniform, since ``torch.randint`` takes its bound as a Python
    int."""
    device = data["images"].device
    gen_device = generator.device if generator is not None else device

    def rand_int(high: int, shape):
        return torch.randint(0, high, shape, generator=generator,
                             device=gen_device).to(device)

    idxs = rand_int(data["images"].shape[0], (n_views,))
    top = size - crop_size
    if not mask_crops:
        uw = rand_int(top + 1, (2,))
        return idxs, uw[0], uw[1]
    # a 0-d tensor as an index would be read on the host: index by [1]-shaped
    # tensors, then take the 0-d corner by a Python int
    first = idxs[:1]
    count = data["mask_counts"][first]
    unit = torch.rand((1,), generator=generator, dtype=torch.float64,
                      device=gen_device).to(device)
    j = torch.minimum(torch.floor(unit * count).long(), count - 1)
    yx = data["mask_px"][first, j]                                # [1, 2]
    half = crop_size // 2
    return idxs, (yx[0, 0] - half).clamp(0, top), (yx[0, 1] - half).clamp(0, top)


def gather_crop(data: dict, idxs: torch.Tensor, u: torch.Tensor, w: torch.Tensor,
                crop_size: int):
    """The ``[N, S, S, 3]`` image and ``[N, S, S]`` mask crops of views
    ``idxs`` at corner ``(u, w)``, by index arithmetic on the device."""
    offs = torch.arange(crop_size, device=idxs.device)
    rows = (u + offs)[None, :, None]
    cols = (w + offs)[None, None, :]
    views = idxs[:, None, None]
    return data["images"][views, rows, cols], data["masks"][views, rows, cols]


def make_device_data_step(scene, integrator, optimizer_config,
                          camera_builder: Callable, *, n_views: int, size: int,
                          crop_size: int, mask_crops: bool = True,
                          with_light_locs: bool = False,
                          draw: Optional[Callable] = None, **kwargs):
    """The step ``dstep(state, data, generator) -> (state, aux)`` whose view
    selection, crop draw, ground-truth gather and camera construction run
    on the data's device.

    ``data`` comes from ``device_dataset``; ``camera_builder(c2w_batch) ->
    camera`` builds the views' camera from ``data["c2ws"][idxs]`` (e.g.
    ``lambda c: NeRFCamera(c, focal)``).  With ``with_light_locs`` the
    scene's point lights move to ``data["light_locs"][idxs]`` first
    (AdamW's moments follow through the step's ``broadcast_state``).  Views
    are uniform (the host path's loss-proportional sampler needs the loss
    on the host); crops are mask-centred on the first view or uniform
    (``draw_crop``).  ``draw(data, generator) -> (idxs, u, w)`` replaces
    those draws (tests pin them with it).  ``generator`` draws them and the
    step's jitter.  The rest of ``kwargs`` go to ``build_step_fn``.
    """
    step = build_step_fn(scene, integrator, optimizer_config, size=size,
                         crop_size=crop_size, **kwargs)
    if draw is None:
        def draw(data, generator):
            return draw_crop(data, generator, n_views=n_views, size=size,
                             crop_size=crop_size, mask_crops=mask_crops)

    def dstep(state: TrainState, data: dict, generator=None):
        idxs, u, w = draw(data, generator)
        exp, mask = gather_crop(data, idxs, u, w, crop_size)
        camera = camera_builder(data["c2ws"][idxs])
        if with_light_locs:
            state.scene.lights.set_location(data["light_locs"][idxs])
        return step(state, camera, (u, w), exp, mask, generator)

    return dstep


def rand_uv(rng: np.random.Generator, w: int, h: int, size: int):
    return (int(rng.integers(0, w - size + 1)),
            int(rng.integers(0, h - size + 1)))


def rand_uv_mask(rng: np.random.Generator, mask: np.ndarray, size: int):
    """Crop corner centred on a random non-zero mask pixel; a uniform crop
    when the mask is empty."""
    h, w = mask.shape[:2]
    half = size // 2
    ys, xs = np.nonzero(np.asarray(mask) > 0.5)
    if len(ys) == 0:
        return rand_uv(rng, h, w, size)
    i = int(rng.integers(0, len(ys)))
    u = int(np.clip(ys[i] - half, 0, h - size))
    v = int(np.clip(xs[i] - half, 0, w - size))
    return u, v


def train(scene, integrator, optimizer_config, state: TrainState,
          make_camera: Callable, exp_imgs: np.ndarray, exp_masks: np.ndarray,
          generator: Optional[torch.Generator] = None, *, size: int,
          crop_size: int, iters: int, n_views: int = 3, bundle_size: int = 1,
          mask_weight: float = 15.0, tone_mapping: bool = False,
          with_ssim: bool = True, extra_loss: Callable = default_extra_loss,
          space_reg: Optional[Callable] = None,
          light_update: Optional[Callable] = None,
          save_fn: Optional[Callable] = None, ckpt_freq: int = 0,
          valid_freq: int = 0, valid_fn: Optional[Callable] = None,
          log_every: int = 100, log_fn: Callable = print,
          metrics: Optional[list] = None, mesh=None, seed: int = 0,
          step_fn: Optional[Callable] = None,
          uv_select: Optional[Callable] = None, nan_policy: str = "raise",
          device_data: Optional[dict] = None,
          camera_builder: Optional[Callable] = None):
    """The training loop.

    ``make_camera(idxs) -> camera`` builds the view batch; ``exp_imgs
    [V, H, W, 3]`` and ``exp_masks [V, H, W]`` (numpy) go to the scene's
    device once; ``generator`` draws the step jitter;
    ``light_update(scene, camera, idxs)`` runs before each step and moves
    the lights in place (NeRV's per-frame point lights; the JAX
    ``light_update(params, camera, idxs) -> params``);
    ``space_reg(scene, generator) -> scalar`` is added to each step's loss
    (the JAX ``space_reg(params, key)``); ``valid_fn(state,
    step)`` runs every ``valid_freq`` steps and ``save_fn(state, step)``
    every ``ckpt_freq``; per-step scalars are appended to ``metrics``.
    ``nan_policy``: "raise" aborts on a non-finite loss; "skip" drops the
    update and goes on, aborting after 200 consecutive bad steps.

    ``device_data`` (from ``device_dataset``) takes the on-device data path
    (``make_device_data_step``): ``camera_builder(c2w_batch) -> camera``
    replaces ``make_camera``, views are uniform, crops mask-centred with
    ``uv_select=rand_uv_mask`` or uniform with None (any other raises
    ``ValueError``), and the lights follow ``device_data["light_locs"]``
    where it is present instead of ``light_update``; ``exp_imgs`` and
    ``exp_masks`` are not read.
    ``mesh`` (a ``parallel.Mesh``) trains data-parallel
    (``parallel.make_parallel_train_step``): rank 0's scene is broadcast
    first, every rank draws the same views, crops and jitter (the same
    ``seed`` and an identically seeded ``generator``) and computes the same
    loss, and only rank 0 logs, validates and saves.  A mesh takes neither
    ``device_data`` (a single-device path, as in the JAX script) nor
    ``light_update`` (per-view lights are not sharded); both raise
    ``ValueError``.
    ``step_fn(state, camera, (u, v), exp, mask, generator) -> (state, aux)``,
    ``build_step_fn``'s signature, replaces the step built here (under a
    mesh too, where the state is still replicated first).  It does not go
    with ``device_data``, whose step takes the dataset and not a batch: the
    two together raise ``ValueError`` (where the JAX loop ignores
    ``step_fn``).
    Its spans are ``nrt.train.upload`` (the split's copy to the device,
    counted as ``train.upload_bytes``) and ``nrt.train.step`` (one
    iteration), which holds ``nrt.train.draw`` (the views, crop, camera and
    ground-truth slice) and ``nrt.train.resolve`` (the previous step's loss
    read on the host: its copy was queued after that step, so the wait
    leaves the step just queued running on the card).
    Returns (state, losses).
    """
    if nan_policy not in ("raise", "skip"):
        raise ValueError(f"nan_policy must be 'raise' or 'skip', got {nan_policy!r}")
    if mesh is not None:
        if device_data is not None:
            raise ValueError("device_data is a single-device path: it takes no mesh")
        if light_update is not None:
            raise ValueError("light_update moves per-view lights, which a mesh "
                             "does not shard")
        if mesh.rank != 0:
            log_fn = lambda *a, **k: None
            save_fn = valid_fn = None
    skip_nan = nan_policy == "skip"
    step_kw = dict(bundle_size=bundle_size, mask_weight=mask_weight,
                   tone_mapping=tone_mapping, with_ssim=with_ssim,
                   extra_loss=extra_loss, space_reg=space_reg,
                   skip_nan_updates=skip_nan)
    if device_data is not None:
        if step_fn is not None:
            raise ValueError("step_fn takes a host batch; device_data builds its own "
                             "on-device step: pass one of them")
        if camera_builder is None:
            raise ValueError("device_data needs a camera_builder")
        if uv_select is not None and uv_select is not rand_uv_mask:
            # the device path draws only rand_uv_mask's crops (or uniform
            # ones); another sampler would silently differ from the host path
            raise ValueError("device_data supports uv_select in (None, rand_uv_mask) "
                             "only; use the host path for custom crop samplers")
        dstep = make_device_data_step(
            scene, integrator, optimizer_config, camera_builder, n_views=n_views,
            size=size, crop_size=crop_size, mask_crops=uv_select is not None,
            with_light_locs="light_locs" in device_data, **step_kw)
    elif mesh is not None:
        from ..parallel import make_parallel_train_step, replicate
        if step_fn is None:
            step_fn = make_parallel_train_step(scene, integrator, optimizer_config, mesh,
                                               n_views=n_views, size=size,
                                               crop_size=crop_size, **step_kw)
        replicate(state.scene, mesh)
    elif step_fn is None:
        step_fn = build_step_fn(scene, integrator, optimizer_config, size=size,
                                crop_size=crop_size, **step_kw)
    if device_data is None:
        device = next(state.scene.parameters()).device
        with profiling.annotate("nrt.train.upload"):
            images = torch.as_tensor(np.asarray(exp_imgs)[..., :3], dtype=torch.float32,
                                     device=device)
            masks = torch.as_tensor(np.asarray(exp_masks), dtype=torch.float32,
                                    device=device)
        profiling.count("train.upload_bytes", 4 * (images.numel() + masks.numel()))
        selector = LossSampler(len(exp_imgs))
    # metrics and logs carry the global attempted step
    base = int(state.step)
    rng = np.random.default_rng(seed)
    losses: list = []
    t0 = time.time()
    rays_done = 0
    pending = None
    consecutive_bad = 0

    def fetch(loss: torch.Tensor):
        """Start the loss's copy to the host, waiting for nothing: a read of
        the card's tensor would wait for every step queued after it."""
        if not loss.is_cuda:
            return loss, None
        host = torch.empty((), dtype=loss.dtype, pin_memory=True)
        host.copy_(loss, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(loss.device))
        return host, done

    def resolve(pending, i):
        nonlocal consecutive_bad
        p_idxs, (p_loss, done) = pending
        if done is not None:
            done.synchronize()
        loss = float(p_loss)
        if not np.isfinite(loss):
            if not skip_nan:
                raise FloatingPointError(f"Unexpected NaN loss at step {base + i - 1}")
            consecutive_bad += 1
            log_fn(f"step {base + i - 1:6d} non-finite loss — update skipped "
                   f"({consecutive_bad} consecutive)")
            if consecutive_bad >= 200:
                raise FloatingPointError(f"200 consecutive non-finite losses at "
                                         f"step {base + i - 1}")
            return
        consecutive_bad = 0
        losses.append(loss)
        if p_idxs is not None:
            selector.update_idxs(p_idxs, loss)
        rps = rays_done / max(time.time() - t0, 1e-9)
        if log_every and ((i - 1) % log_every) == 0:
            log_fn(f"step {base + i - 1:6d} loss {loss:.5f} rays/s {rps:,.0f}")
        if metrics is not None:
            metrics.append({"step": base + i - 1, "loss": loss, "rays_per_sec": rps})

    for i in range(iters):
        with profiling.annotate("nrt.train.step"):
            if device_data is not None:
                idxs = None
                state, aux = dstep(state, device_data, generator)
            else:
                with profiling.annotate("nrt.train.draw"):
                    idxs = selector.sample(n=n_views)
                    camera = make_camera(idxs)
                    if uv_select is not None:
                        u, v = uv_select(rng, exp_masks[idxs[0]], crop_size)
                    else:
                        u, v = rand_uv(rng, size, size, crop_size)
                    sel = torch.as_tensor(idxs)
                    if device.type == "cuda":
                        # pinned, the copy waits for nothing: the host queues
                        # this step while the card runs the one before
                        sel = sel.pin_memory().to(device, non_blocking=True)
                    exp = images[sel, u:u + crop_size, v:v + crop_size]
                    mask = masks[sel, u:u + crop_size, v:v + crop_size]
                if light_update is not None:
                    light_update(state.scene, camera, idxs)
                state, aux = step_fn(state, camera, (u, v), exp, mask, generator)
            rays_done += n_views * crop_size * crop_size * bundle_size
            if pending is not None:
                with profiling.annotate("nrt.train.resolve"):
                    resolve(pending, i)
            pending = (idxs, fetch(aux["loss"]))
            if save_fn is not None and ckpt_freq and (i % ckpt_freq) == 0 and i:
                save_fn(state, base + i)
            if valid_fn is not None and valid_freq and (i % valid_freq) == 0:
                valid_fn(state, base + i)
    if pending is not None:
        with profiling.annotate("nrt.train.resolve"):
            resolve(pending, iters)
    return state, losses
