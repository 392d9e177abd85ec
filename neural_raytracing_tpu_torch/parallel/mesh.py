"""Data parallelism over ``torch.distributed``: one process a device.

Counterpart of ``neural_raytracing_tpu/parallel/mesh.py``.  The JAX package
runs one program over a device mesh and lets XLA insert the gradient
all-reduce; here every device has its own process (``torchrun``, or a
process group made by ``initialize_multihost``), and a ``Mesh`` names the
group, this process's rank and its device.

The data-parallel training step (``make_parallel_train_step``) computes the
function of the JAX sharded step, which is the *unsharded* loss over the
first ``n_views`` views:

  * the view axis is padded to a multiple of the world size (``pad_batch``)
    and each rank renders its contiguous shard (``shard_batch``);
  * an autograd all-gather (``all_gather``) collects the rendered values and
    the interaction's per-view fields, so every rank computes the same loss
    on the first ``n_views`` gathered views (the masked means, SSIM and the
    eikonal mean do not split into per-shard means);
  * the gather's backward sums the gathered gradient over the ranks and
    keeps this rank's rows, so a rank's rendering receives world-size times
    its share; ``reduce_grads`` then all-reduces the parameter gradients by
    their mean, which gives the single-process gradient and counts once a
    term every rank computes alike (``space_reg``);
  * clipping, the finite check and AdamW follow on the reduced gradient,
    the same on every rank, so the replicas stay equal.

Random draws: every rank draws from an identically seeded generator.  Draws
with no view axis (the camera jitter of a crop, the silhouette scan's
jitter) are then the same on every rank, as in one process; a per-ray draw
names its batch axis, and under the shard is drawn at the padded count and
sliced to this rank's rows (``ops.sampling.view_shard``), as the JAX
program draws it over the whole padded batch.

Without a process group a mesh is a world of one and every collective is
the identity.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    """The process group a data-parallel step runs over: ``size`` ranks,
    this process's ``rank`` and its ``device``; ``group`` is None for a
    world of one without a process group."""
    size: int
    rank: int
    device: torch.device
    group: Optional[object] = None

    @property
    def collective(self) -> bool:
        """True when the collectives run (a process group, even of one)."""
        return self.group is not None


class Sharding(NamedTuple):
    """How a tensor lies over a mesh: ``"replicated"`` (whole on every
    rank) or ``"data"`` (split along its leading axis)."""
    kind: str
    mesh: Mesh


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Join the process group of ``num_processes`` processes as rank
    ``process_id``, rendezvousing at ``coordinator_address`` (``host:port``
    or an init-method URL such as ``file://``).  The backend is NCCL where
    CUDA is available, else gloo.  Does nothing when ``num_processes <=
    1``, as the JAX package does."""
    if num_processes is None or num_processes <= 1:
        return
    url = coordinator_address or ""
    if "://" not in url:
        url = f"tcp://{url}"
    dist.init_process_group("nccl" if torch.cuda.is_available() else "gloo", init_method=url,
                            world_size=num_processes, rank=process_id)


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh of the current process group.

    Under ``torchrun`` (``WORLD_SIZE`` > 1) with no group yet, the group is
    made from its environment (NCCL where CUDA is available, else gloo).
    Without a group the mesh is a world of one.  ``device`` defaults to
    ``cuda:LOCAL_RANK`` (``cuda`` for a world of one) and to the CPU for a
    gloo group.  ``n_devices`` other than the world size raises
    ``ValueError``."""
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group("nccl" if torch.cuda.is_available() else "gloo",
                                init_method="env://")
    if dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        group = dist.group.WORLD
        if device is None:
            if dist.get_backend() == "gloo":
                device = "cpu"
            else:
                device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    else:
        size, rank, group = 1, 0, None
        if device is None:
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}): the world size is {size} "
                         "(one process a device: launch that many with torchrun)")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(size, rank, device, group)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding("replicated", mesh)


def data_sharding(mesh: Mesh) -> Sharding:
    return Sharding("data", mesh)


def padded_size(batch_size: int, n: int) -> int:
    return batch_size + (-batch_size) % n


def _tree_map(fn: Callable, tree):
    """``fn`` over the leaves of nested dicts, lists, tuples and NamedTuples
    (a camera, an Interaction)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leading(leaf) -> Optional[int]:
    shape = getattr(leaf, "shape", None)
    return shape[0] if shape is not None and len(shape) >= 1 else None


def pad_batch(tree, batch_size: int, n: int):
    """Pad the leaves whose leading axis is ``batch_size`` to a multiple of
    ``n`` by repeating the last slice (tensors stay tensors, numpy arrays
    numpy arrays).  Other leaves pass through, so a batch already padded is
    padded no further."""
    pad = (-batch_size) % n
    if pad == 0:
        return tree

    def padleaf(leaf):
        if _leading(leaf) != batch_size:
            return leaf
        if isinstance(leaf, torch.Tensor):
            return torch.cat([leaf, leaf[-1:].expand((pad,) + tuple(leaf.shape[1:]))])
        import numpy as np
        return np.concatenate([leaf, np.broadcast_to(leaf[-1:], (pad,) + leaf.shape[1:])])

    return _tree_map(padleaf, tree)


def shard_batch(tree, mesh: Mesh, batch_size: int):
    """Pad the view axis to a multiple of the world size (``pad_batch``),
    then keep this rank's contiguous slice of the leaves whose leading axis
    is the padded size."""
    padded = padded_size(batch_size, mesh.size)
    per = padded // mesh.size
    tree = pad_batch(tree, batch_size, mesh.size)
    lo = mesh.rank * per
    return _tree_map(lambda leaf: leaf[lo:lo + per] if _leading(leaf) == padded else leaf,
                     tree)


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers, so that every rank starts
    from the same state.  Returns the module."""
    if mesh.collective:
        for t in module.state_dict().values():
            dist.broadcast(t, src=0, group=mesh.group)
    return module


class _AllGather(torch.autograd.Function):
    """Forward: the ranks' equal-shaped tensors concatenated along axis 0.
    Backward: the incoming gradient summed over the ranks, this rank's
    rows kept (every rank's loss reads every rank's rows)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.contiguous().clone()
        dist.all_reduce(g, group=mesh.group)
        per = g.shape[0] // mesh.size
        return g[mesh.rank * per:(mesh.rank + 1) * per], None


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Concatenate every rank's ``x`` along axis 0, differentiably (see
    ``_AllGather``); the identity for a world of one with no group."""
    if not mesh.collective:
        return x
    if x.dtype == torch.bool:
        return _AllGather.apply(x.to(torch.uint8), mesh).bool()
    return _AllGather.apply(x, mesh)


def gather_views(tree, mesh: Mesh, n_local: int):
    """``all_gather`` every tensor leaf of a rendered shard (the values, the
    hit flags, the interaction's fields), each of leading axis the shard's
    view count ``n_local``; None passes, and any other leaf raises
    ``ValueError``."""
    def gather(leaf):
        if leaf is None:
            return None
        if _leading(leaf) != n_local:
            raise ValueError(f"a rendered field of shape {tuple(leaf.shape)} has no leading "
                             f"view axis of the shard's {n_local} views")
        return all_gather(leaf, mesh)

    return _tree_map(gather, tree)


@torch.no_grad()
def reduce_grads(params, mesh: Mesh) -> None:
    """All-reduce the ``.grad`` of ``params`` by their mean, in one
    collective over a flat buffer.  Every rank must hold a gradient for
    every parameter (the step fills missing ones with zeros)."""
    if not mesh.collective:
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.size
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def sharded_render_rays(scene, rays: torch.Tensor, integrator, mesh: Mesh,
                        generator=None, training: bool = False):
    """Render a flat ray batch ``[r, ...]`` with the ray axis split over the
    mesh: the rays are padded to a multiple of the world size, each rank
    renders its slice and the results are all-gathered.  -> ``(values[:r],
    active[:r])`` on every rank."""
    from ..ops import sampling
    r = rays.shape[0]
    local = shard_batch(rays, mesh, r)
    with sampling.view_shard(mesh.rank, local.shape[0], padded_size(r, mesh.size)):
        values, active, _ = integrator.sample(scene, local, generator=generator,
                                              training=training)
    return all_gather(values, mesh)[:r], all_gather(active, mesh)[:r]


def make_parallel_train_step(scene, integrator, optimizer_config, mesh: Mesh, *,
                             n_views: int, **step_kwargs):
    """The data-parallel training step ``(state, camera, uv, exp, mask,
    generator) -> (state, aux)`` over ``mesh`` (see the module's
    docstring).  Every rank passes the whole batch of ``n_views`` views (the
    camera, ``exp`` and ``mask``); the step renders this rank's shard of the
    padded view axis and returns the loss of the first ``n_views`` views,
    the same on every rank.  ``step_kwargs`` go to ``build_step_fn``."""
    from ..training.loop import build_step_fn
    return build_step_fn(scene, integrator, optimizer_config, n_real_views=n_views,
                         mesh=mesh, **step_kwargs)
