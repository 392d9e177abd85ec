"""Carry weights from the JAX package's params pytree into the port.

The JAX package keeps every learnable array in nested dicts and tuples
(``{"shape": {"shift": {"layers": ({"w": ..., "b": ...}, ...)}}}``).  The
port names its parameters and buffers after the same paths
(``shape.shift.layers.0.w``) and keeps the JAX ``[fan_in, fan_out]`` weight
layout, so the bridge is a flattening of the tree followed by a strict
``load_state_dict``, which catches any missing or extra leaf.

The tree must already hold numpy arrays (``jax.tree.map(np.asarray, params)``
on the JAX side), so nothing here touches JAX.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def state_dict_from_jax(tree) -> dict:
    """Flatten a params pytree of numpy arrays to ``{dotted path: tensor}``.
    Empty subtrees (a scene without an occlusion net) contribute nothing."""
    out: dict = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
        else:
            out[prefix[:-1]] = torch.from_numpy(np.array(node, dtype=np.float32))

    walk(tree, "")
    return out


def load_jax_params(module: nn.Module, tree, device="cuda") -> nn.Module:
    """Load a JAX params pytree into ``module`` (strictly) and move it to
    ``device``.  Returns the module."""
    module.load_state_dict(state_dict_from_jax(tree), strict=True)
    return module.to(device)
