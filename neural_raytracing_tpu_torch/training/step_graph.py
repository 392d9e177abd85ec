"""One CUDA graph for the whole training step.

``GraphedStep`` wraps the eager step that ``build_step_fn`` builds
(zero_grad, the render, the loss, the backward, the clip and AdamW).  On a
CUDA scene it captures that step into one ``torch.cuda.CUDAGraph`` and
replays it: the same kernels do the same work, launched by one
``cudaGraphLaunch`` instead of the thousands of launches of an eager step,
so the host no longer sets the step's pace.

For each key (``GraphedStep.key``: the inputs' shapes and dtypes, the
addresses and shapes of the parameters, buffers, gradients and AdamW's
state, AdamW's hyperparameters, the clip norm, the scene's settings, the
scene, the optimizer and the generator):

- the first call runs the eager step, which also makes AdamW's lazy state;
- the next call runs the eager step again on a side stream, as that call's
  step and as the warm-up a capture needs on its stream, then captures it
  (a capture records work and does none);
- every later call fills the graph's static inputs on the stream (the
  camera's tensors from pinned memory, ``uv`` as 0-d tensors, the ground
  truth's crop) and replays the graph.  The loss and the rendered crop it
  returns are copies made after the replay, fresh for each step.

A capture that fails (an ``extra_loss`` or ``space_reg`` that waits for the
card, the triangle mesh's host intersect) warns once, and that key runs
eagerly from then on.  At most ``MAX_GRAPHS`` graphs are kept.  The step
stays eager off the card, with an optimizer other than a ``capturable``
Adam or AdamW (``AdamWConfig.init`` makes its AdamW capturable on the
card), with a generator that is not a CUDA generator, and with a camera
that is not a NamedTuple.

A replay sees tensors updated in place (the parameters, NeRV's lights); a
rebound tensor changes the key.  Python values read while capturing are
baked into the graph, so the key holds them: the learning rates, a
camera's non-tensor fields (a float focal length) and the scene's settings
(``settings``: every module's plain attributes, such as the kernels' routes
and modes, the march steps and dtypes).

K1's weight packs are cached by the weights' host-side versions, which a
replay does not move, so the cache is dropped around each capture and after
each replay (``fused_mlp.forget_packs``): the graph packs every net itself,
in its own memory, at each replay (K2-K4 read their shift net from the same
cache; their queue counters and scratch are made at each call, so the
graph's are its own).  The counts the step makes (``profiling.count``)
and the kernels' launch counts (``kernels.launch_counts``) are taken apart
while capturing, which launches nothing, and given back at each replay.
``step.graph_replays``, ``step.graph_captures`` and ``step.graph_fallbacks``
count the mechanism; its spans are ``nrt.step.graph`` (a replay with its
input copies) and ``nrt.step.capture``.
"""

from __future__ import annotations

import collections
import warnings
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from .. import profiling
from ..kernels import add_launches, launches_apart
from ..kernels.fused_mlp import forget_packs

MAX_GRAPHS = 2      # graphs kept a step function, each with its memory pool
MAX_KEYS = 8        # keys remembered as seen once, or as failed to capture


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple       # the static (camera, (u, v), exp, mask) the graph reads
    aux: dict           # the captured step's loss and rendered crop
    counts: dict        # the counts the captured step made
    launches: dict      # the kernel launches it counted (``launches_apart``)
    owners: tuple       # the scene, optimizer and generator the graph reads


def _fill(static: torch.Tensor, value) -> None:
    """Write ``value`` (a number, or a tensor on the host or a device) into
    ``static`` on the current stream without waiting: a host tensor goes
    through pinned memory, which is not reused before its copy is done."""
    if not isinstance(value, torch.Tensor):
        static.fill_(value)
    elif static.is_cuda and not value.is_cuda:
        static.copy_(value.pin_memory(), non_blocking=True)
    else:
        static.copy_(value)


def static_inputs(device, camera, exp, mask) -> tuple:
    """Buffers on ``device`` for the step's inputs: the camera with a
    buffer for each tensor field (its other fields kept), ``(u, v)`` as
    float32 0-d tensors, and the ground truth's crop."""
    like = lambda t: torch.empty(t.shape, dtype=t.dtype, device=device)
    cam = type(camera)(*(like(f) if isinstance(f, torch.Tensor) else f for f in camera))
    uv = (torch.zeros((), device=device), torch.zeros((), device=device))
    return cam, uv, like(exp), like(mask)


def fill_inputs(static: tuple, camera, uv, exp, mask) -> None:
    """Write a call's inputs into ``static_inputs``' buffers."""
    cam, suv, sexp, smask = static
    for s, f in zip(cam, camera):
        if isinstance(s, torch.Tensor):
            _fill(s, f)
    for s, v in zip(suv, uv):
        _fill(s, v)
    _fill(sexp, exp)
    _fill(smask, mask)


_PLAIN = {bool, int, float, str, torch.dtype, type(None)}


def settings(scene: nn.Module) -> tuple:
    """The plain attributes (numbers, strings, dtypes, tuples of them) of
    every module of ``scene``, and of the surface modules an ``SDF`` keeps
    unregistered (``shapes.sdf.adopt_surface``): what chooses the work the
    step does beside its tensors (a kernel's route and mode, K6/K7's
    segments, the march steps and dtype, the throughput mode)."""
    out = []
    for m in scene.modules():
        objs = [m]
        for obj in objs:
            for k, v in vars(obj).items():
                t = type(v)
                if t in _PLAIN or (t is tuple and all(type(x) in _PLAIN for x in v)):
                    out.append((k, v))
                elif obj is m and isinstance(v, nn.Module):
                    objs.append(v)
    return tuple(out)


def _remember(table: "collections.OrderedDict", key) -> None:
    table[key] = True
    table.move_to_end(key)
    while len(table) > MAX_KEYS:
        table.popitem(last=False)


class GraphedStep:
    """The training step ``(state, camera, uv, exp, mask, generator) ->
    (state, aux)`` of ``eager`` (``build_step_fn``'s), captured in a CUDA
    graph and replayed where it can be (the module's docstring).  ``_eager``
    is the step itself."""

    def __init__(self, eager: Callable, clip_norm: Optional[float]):
        self._eager = eager
        self.clip_norm = clip_norm
        self._graphs: "collections.OrderedDict" = collections.OrderedDict()
        self._seen: "collections.OrderedDict" = collections.OrderedDict()
        self._failed: "collections.OrderedDict" = collections.OrderedDict()
        self._stream = None

    @staticmethod
    def engages(state, camera, generator) -> bool:
        """Whether the graph may run the step: the scene on a CUDA device, a
        capturable Adam or AdamW, a NamedTuple camera, no generator or a CUDA
        one."""
        param, opt = next(state.scene.parameters(), None), state.optimizer
        return (param is not None and param.is_cuda
                and isinstance(opt, (torch.optim.Adam, torch.optim.AdamW))
                and all(group["capturable"] for group in opt.param_groups)
                and isinstance(camera, tuple) and hasattr(camera, "_fields")
                and (generator is None or generator.device.type == "cuda"))

    def key(self, state, camera, exp, mask, generator):
        """What a graph is valid for (the module's docstring), or None where
        a camera field is neither a tensor nor hashable.  Read at every call,
        so it reads each tensor's address and no more."""
        scene, opt = state.scene, state.optimizer
        params = list(scene.parameters())
        flat = [type(camera), exp.shape, exp.dtype, mask.shape, mask.dtype,
                self.clip_norm, id(scene), id(opt), id(generator)]
        flat += [(f.shape, f.dtype) if isinstance(f, torch.Tensor) else f for f in camera]
        flat += [t.data_ptr() for t in params]
        flat += [t.shape for t in params]
        flat += [None if t.grad is None else t.grad.data_ptr() for t in params]
        flat += [(t.data_ptr(), t.shape) for t in scene.buffers()]
        for p in params:
            flat += [(k, v.data_ptr() if isinstance(v, torch.Tensor) else v)
                     for k, v in opt.state.get(p, {}).items()]
        flat += [tuple((k, v) for k, v in group.items() if k != "params")
                 for group in opt.param_groups]
        flat += settings(scene)
        key = tuple(flat)
        try:
            hash(key)
        except TypeError:
            return None
        return key

    def __call__(self, state, camera, uv, exp, mask, generator=None):
        if not self.engages(state, camera, generator):
            return self._eager(state, camera, uv, exp, mask, generator)
        key = self.key(state, camera, exp, mask, generator)
        entry = self._graphs.get(key)
        if entry is not None:
            self._graphs.move_to_end(key)
            return self._replay(entry, state, camera, uv, exp, mask)
        if key is not None and key in self._seen and key not in self._failed:
            del self._seen[key]
            return self._capture(key, state, camera, uv, exp, mask, generator)
        out = self._eager(state, camera, uv, exp, mask, generator)
        if key is not None and key not in self._failed:
            # AdamW's first step makes its state: key the next call as it
            # will find the step
            after = self.key(out[0], camera, exp, mask, generator)
            if after is not None:
                _remember(self._seen, after)
        return out

    def _replay(self, entry: _Graph, state, camera, uv, exp, mask):
        with profiling.annotate("nrt.step.graph"):
            fill_inputs(entry.inputs, camera, uv, exp, mask)
            entry.graph.replay()
            forget_packs()
            add_launches(entry.launches)
            for name, n in entry.counts.items():
                profiling.count(name, n)
            profiling.count("step.graph_replays", 1)
            aux = {k: v.clone() for k, v in entry.aux.items()}
        return type(state)(state.scene, state.optimizer, state.step + 1), aux

    def _capture(self, key, state, camera, uv, exp, mask, generator):
        device = next(state.scene.parameters()).device
        static = static_inputs(device, camera, exp, mask)
        fill_inputs(static, camera, uv, exp, mask)
        main = torch.cuda.current_stream(device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        side = self._stream
        side.wait_stream(main)
        with torch.cuda.stream(side):
            # this call's step, and the warm-up a capture needs on its stream
            out = self._eager(state, *static, generator)
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        # a broken capture leaves the generators it holds (the device's
        # default one always) in capture mode: their states are put back
        gens = [g for g in (generator, torch.cuda.default_generators[device.index or 0])
                if g is not None]
        backups = [g.clone_state() for g in gens]
        with profiling.annotate("nrt.step.capture"):
            forget_packs()
            try:
                # the outer stream context puts the caller's stream back where
                # a broken capture leaves ``torch.cuda.graph`` without doing so
                with torch.cuda.stream(side), profiling.collect() as counts, \
                        launches_apart() as launches:
                    with torch.cuda.graph(graph, stream=side):
                        _, aux = self._eager(state, *static, generator)
            except RuntimeError as err:
                for g, backup in zip(gens, backups):
                    g.graphsafe_set_state(backup)
                _remember(self._failed, key)
                profiling.count("step.graph_fallbacks", 1)
                warnings.warn(f"the training step could not be captured in a CUDA graph "
                              f"({err}); it runs eagerly for these inputs and state",
                              RuntimeWarning, stacklevel=3)
            else:
                if len(self._graphs) >= MAX_GRAPHS:
                    torch.cuda.synchronize(device)      # no replay still reads it
                    self._graphs.popitem(last=False)
                self._graphs[key] = _Graph(graph, static, aux, counts, launches,
                                           (state.scene, state.optimizer, generator))
                profiling.count("step.graph_captures", 1)
            finally:
                forget_packs()
        main.wait_stream(side)
        return out
