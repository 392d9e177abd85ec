"""Dataset loaders.

Counterpart of ``load_nerf_synthetic`` in
``neural_raytracing_tpu/training/datasets.py``: ``transforms_{split}.json``
plus one PNG per frame; the focal length from ``camera_angle_x``; camera
translations normalised to unit distance; masks ``ceil(alpha - 1e-5)``.
The other loaders (DTU, NeRV, colocate) are not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional

import numpy as np


def load_image(path: str, resize: Optional[tuple] = None) -> np.ndarray:
    from PIL import Image   # only this loader needs PIL
    img = Image.open(path)
    if resize is not None:
        img = img.resize(resize)
    return np.asarray(img, dtype=np.float64).astype(np.float32) / 255.0


class NeRFDataset(NamedTuple):
    cam_to_worlds: np.ndarray   # [V, 3, 4], translations unit-normalised
    focal: float
    images: np.ndarray          # [V, H, W, 3]
    masks: np.ndarray           # [V, H, W]


def load_nerf_synthetic(directory: str, size: int,
                        split: str = "train") -> NeRFDataset:
    with open(os.path.join(directory, f"transforms_{split}.json")) as f:
        tfs = json.load(f)
    focal = 0.5 * size / np.tan(0.5 * float(tfs["camera_angle_x"]))
    images, masks, c2ws = [], [], []
    for frame in tfs["frames"]:
        img = load_image(os.path.join(directory, frame["file_path"] + ".png"),
                         resize=(size, size))
        images.append(img[..., :3])
        masks.append(np.ceil(img[..., 3] - 1e-5))
        mat = np.asarray(frame["transform_matrix"], np.float32)[:3, :4]
        # camera distance normalised to 1
        mat[:3, 3] /= max(np.linalg.norm(mat[:3, 3]), 1e-6)
        c2ws.append(mat)
    return NeRFDataset(np.stack(c2ws), float(focal), np.stack(images),
                       np.stack(masks))
