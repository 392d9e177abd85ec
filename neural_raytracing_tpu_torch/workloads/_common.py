"""Helpers shared by the workload twins (the JAX ``scripts/_common.py``)."""

from __future__ import annotations

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
