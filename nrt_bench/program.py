"""What the benchmark takes from the program under test: its scene builders,
its training loop and step, its renderer, and the switch to its own
lower-precision path (the control of the output check).

A configuration names its builder as ``program.module`` and
``program.scene`` (a function of no arguments returning a ``Scene``), and
the training step's extra loss as ``program.extra_loss`` (a factory of the
same module), so a configuration that the program builds elsewhere needs no
edit here.
"""

from __future__ import annotations

import importlib

import torch

PACKAGE = "neural_raytracing_tpu_torch"


def _module(cfg: dict):
    return importlib.import_module(f"{PACKAGE}.{cfg['program']['module']}")


def build_scene(cfg: dict, weights: dict, device):
    """The program's scene for ``cfg`` on ``device`` holding ``weights``
    (loaded strictly: a leaf the configuration does not state raises)."""
    scene = getattr(_module(cfg), cfg["program"]["scene"])().to(device)
    scene.load_state_dict(weights, strict=True)
    return scene


def view_scene(scene, mix: dict):
    """The scene over the same parameters with the mix's march settings and
    occlusion mode, as the program's test splits build theirs."""
    return scene.replace(occlusion=mix["occlusion"], shape=scene.shape.replace(
        max_steps=mix["max_steps"], march_bound=mix.get("march_bound"),
        throughput_mode="full"))


def lower_precision(scene) -> None:
    """Switch ``scene`` to the program's bfloat16 path: every net's
    ``compute_dtype`` and every surface's ``march_dtype``."""
    from neural_raytracing_tpu_torch.nn.mlp import SkipConnMLP
    from neural_raytracing_tpu_torch.shapes import SDF
    for m in scene.modules():
        if isinstance(m, SkipConnMLP):
            m.compute_dtype = torch.bfloat16
        elif isinstance(m, SDF):
            m.march_dtype = torch.bfloat16


def extra_loss(cfg: dict):
    return getattr(_module(cfg), cfg["program"]["extra_loss"])()


def train_parts():
    from neural_raytracing_tpu_torch.cameras import NeRFCamera
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.training import (
        TrainState, build_step_fn, make_optimizer, train,
    )
    return NeRFCamera, Direct, TrainState, build_step_fn, make_optimizer, train


def render_parts():
    from neural_raytracing_tpu_torch.cameras import NeRFCamera
    from neural_raytracing_tpu_torch.integrators import Direct
    from neural_raytracing_tpu_torch.render import pathtrace
    return NeRFCamera, Direct, pathtrace
