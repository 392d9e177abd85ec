"""Helpers shared by the workload twins (the JAX ``scripts/_common.py``)."""

from __future__ import annotations

import argparse
import os

import numpy as np


def chunk_for(size: int, cap: int = 128) -> int:
    """Largest render tile <= cap that divides ``size``."""
    chunk = min(size, cap)
    while size % chunk:
        chunk -= 1
    return chunk


def save_image(path: str, img) -> None:
    from PIL import Image
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[-1] == 1:        # depth, silhouette: grey
        arr = np.repeat(arr, 3, axis=-1)
    arr = (np.clip(arr[..., :3], 0.0, 1.0) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def base_parser(desc: str, size: int = 256) -> argparse.ArgumentParser:
    """The JAX scripts' shared flags (``scripts/_common.py``'s
    ``base_parser``), so a twin takes their command lines; a twin that does
    not train reads only ``--size``, ``--seed`` and ``--outputs`` of them.
    ``--device`` picks the card (default) or the CPU; ``--cpu`` is
    ``--device cpu``."""
    ap = argparse.ArgumentParser(description=desc)
    ap.add_argument("--size", type=int, default=size, help="image size")
    ap.add_argument("--iters", type=int, default=25_000)
    ap.add_argument("--crop-size", type=int, default=80)
    ap.add_argument("--n-views", type=int, default=6)
    ap.add_argument("--outputs", type=str, default="outputs")
    ap.add_argument("--models", type=str, default="models")
    ap.add_argument("--load", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--data-parallel", action="store_true")
    ap.add_argument("--clip-norm", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--skip-test", action="store_true")
    ap.add_argument("--eval-march-bound", type=float, default=1.2)
    ap.add_argument("--nan-skip", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def device_of(args) -> str:
    return "cpu" if getattr(args, "cpu", False) else args.device


def load_trained(scene, model_dir: str, device):
    """``scene`` with seed-0 weights, then the artifacts of ``model_dir``
    (the JAX visualization scripts' ``init_train_state`` + ``load_scene``)."""
    import torch
    from ..training import load_scene
    scene.init(torch.Generator().manual_seed(0), device=device)
    return load_scene(model_dir, scene)


def render_view(scene, camera, integrator, size: int, key: int, device) -> np.ndarray:
    """One view in one tile, background 0 (the visualization scripts'
    ``pathtrace`` call) -> numpy ``[size, size, dims]``."""
    from ..render import pathtrace
    img, _ = pathtrace(scene, camera, integrator, size=size, chunk_size=size,
                       background=0.0, key=key, device=device)
    return img.cpu().numpy()
