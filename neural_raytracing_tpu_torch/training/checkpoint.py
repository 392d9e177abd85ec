"""Checkpoints: scene artifacts in the JAX package's format, and train-state
resume files.

Counterpart of ``neural_raytracing_tpu/training/checkpoint.py``.
``save_scene``/``load_scene`` write and read one ``{comp}.msgpack`` per scene
component (``shape``, ``bsdf``, ``lights``, ``occ``) plus ``meta.json``, in
flax's msgpack format (``flax_msgpack``), so the port reads the JAX
package's artifacts and the JAX package reads the port's.  A component's
tree is its ``state_dict`` nested at the dots (``shift.layers.0.w`` ->
``{"shift": {"layers": {"0": {"w": ...}}}}``), which is the JAX params
pytree as flax stores it.

``save_train_state``/``load_train_state`` are the port's own resume files
(``torch.save`` of the scene state, the optimizer state and the applied-step
count).  optax optimizer state does not carry across between the packages:
resuming a JAX run in the port restarts AdamW from the scene artifacts.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch
from torch import nn

from ..params import state_dict_from_jax
from . import flax_msgpack

COMPONENTS = ("shape", "bsdf", "lights", "occ")


def module_tree(module: nn.Module) -> dict:
    """``state_dict`` of ``module`` as nested dicts of numpy arrays."""
    tree: dict = {}
    for name, t in module.state_dict().items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().cpu().numpy()
    return tree


def save_pytree(path: str, tree) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(flax_msgpack.serialize(tree))


def load_pytree(path: str):
    with open(path, "rb") as f:
        return flax_msgpack.restore(f.read())


def load_tree_into(module: nn.Module, tree) -> nn.Module:
    """Load a nested tree into ``module`` strictly (a missing or extra leaf
    raises), on the module's device."""
    module.load_state_dict(state_dict_from_jax(tree), strict=True)
    return module


def _components(scene: nn.Module):
    for comp in COMPONENTS:
        part = getattr(scene, comp, None)
        if isinstance(part, nn.Module) and len(part.state_dict()):
            yield comp, part


def save_scene(directory: str, scene: nn.Module, step: Optional[int] = None,
               meta: Optional[dict] = None) -> None:
    """Write each scene component as its own artifact (+ meta.json)."""
    os.makedirs(directory, exist_ok=True)
    for comp, part in _components(scene):
        save_pytree(os.path.join(directory, f"{comp}.msgpack"), module_tree(part))
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump({"step": step, **(meta or {})}, f)


def load_scene(directory: str, scene: nn.Module) -> nn.Module:
    """Load whatever component artifacts exist into ``scene`` (in place);
    components without a file keep their parameters.  Returns the scene."""
    for comp, part in _components(scene):
        path = os.path.join(directory, f"{comp}.msgpack")
        if os.path.exists(path):
            load_tree_into(part, load_pytree(path))
    return scene


def save_train_state(path: str, scene: nn.Module, optimizer, step: int) -> None:
    """The port's resume file: scene state, optimizer state and step."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"scene": scene.state_dict(), "optimizer": optimizer.state_dict(),
                "step": int(step)}, path)


def load_train_state(path: str, scene: nn.Module, optimizer) -> int:
    """Restore ``scene`` and ``optimizer`` in place; returns the step.  The
    optimizer keeps its own ``capturable``, which follows its device
    (``AdamWConfig.init``), whichever device wrote the file."""
    device = next(scene.parameters()).device
    state = torch.load(path, map_location=device, weights_only=True)
    scene.load_state_dict(state["scene"], strict=True)
    saved = state["optimizer"]
    for group, own in zip(saved["param_groups"], optimizer.param_groups):
        if "capturable" in own:
            group["capturable"] = own["capturable"]
    optimizer.load_state_dict(saved)
    return int(state["step"])
