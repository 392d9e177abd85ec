"""Dataset loaders.

Counterparts of ``load_nerf_synthetic``, ``load_nerv`` and
``load_colocate`` in ``neural_raytracing_tpu/training/datasets.py``:
``transforms_{split}.json`` plus one PNG per frame; the focal length from
``camera_angle_x``; masks ``ceil(alpha - 1e-5)``.  NeRF-synthetic camera
translations are normalised to unit distance; NeRV's are not, and each NeRV
frame carries its point light's ``light_loc`` (and ``light_weights`` where
present).  The colocated set (mitsuba ``cbox_relight``) is an elevation x
azimuth grid of ``{kind}_{i}_{j}.png`` renders, camera and light together.
The DTU loader is not ported yet.
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


class NeRVDataset(NamedTuple):
    cam_to_worlds: np.ndarray   # [V, 3, 4]
    focal: float
    images: np.ndarray          # [V, H, W, 3]
    masks: np.ndarray           # [V, H, W]
    light_locs: np.ndarray      # [V, 3] (or [V, L, 3] multi-light)
    light_weights: Optional[np.ndarray]  # [V, L] or None


def load_nerv(directory: str, size: int, split: str = "train",
              point_dir: Optional[str] = None) -> NeRVDataset:
    """A NeRV scene: ``{split}_point/transforms_{split}.json`` (or
    ``point_dir``), else ``transforms_{split}.json`` at the top; an RGB image
    gets an all-ones mask."""
    sub = point_dir if point_dir is not None else f"{split}_point"
    tf_path = os.path.join(directory, sub, f"transforms_{split}.json")
    if not os.path.exists(tf_path):
        tf_path = os.path.join(directory, f"transforms_{split}.json")
    with open(tf_path) as f:
        tfs = json.load(f)
    focal = 0.5 * size / np.tan(0.5 * float(tfs["camera_angle_x"]))
    images, masks, c2ws, lights, weights = [], [], [], [], []
    base = os.path.dirname(tf_path)
    for frame in tfs["frames"]:
        img = load_image(os.path.join(base, frame["file_path"] + ".png"),
                         resize=(size, size))
        images.append(img[..., :3])
        masks.append(np.ceil(img[..., 3] - 1e-5) if img.shape[-1] > 3
                     else np.ones(img.shape[:2], np.float32))
        c2ws.append(np.asarray(frame["transform_matrix"], np.float32)[:3, :4])
        lights.append(np.asarray(frame.get("light_loc", [0.0, 0.0, 0.0]),
                                 np.float32))
        if "light_weights" in frame:
            weights.append(np.asarray(frame["light_weights"], np.float32))
    return NeRVDataset(np.stack(c2ws), float(focal), np.stack(images),
                       np.stack(masks), np.stack(lights),
                       np.stack(weights) if weights else None)


class ColocateDataset(NamedTuple):
    images: np.ndarray          # [V, H, W, 3]
    masks: np.ndarray           # [V, H, W]
    elevs: np.ndarray           # [V]
    azims: np.ndarray           # [V]
    dist: float


def load_colocate(directory: str, kind: str, size: int,
                  n_elev: int = 8, n_azim: int = 8,
                  min_elev: float = 0.0, max_elev: float = 45.0,
                  min_azim: float = -135.0, max_azim: float = 135.0,
                  dist: float = 1.0) -> ColocateDataset:
    """The ``n_elev x n_azim`` grid of ``{kind}_{i}_{j}.png`` (elevation
    ``i``, azimuth ``j``, evenly spaced over the given ranges, row-major)."""
    images, masks, elevs, azims = [], [], [], []
    for i, elev in enumerate(np.linspace(min_elev, max_elev, n_elev)):
        for j, azim in enumerate(np.linspace(min_azim, max_azim, n_azim)):
            img = load_image(os.path.join(directory, f"{kind}_{i}_{j}.png"),
                             resize=(size, size))
            images.append(img[..., :3])
            masks.append(np.ceil(img[..., 3] - 1e-5))
            elevs.append(elev)
            azims.append(azim)
    return ColocateDataset(np.stack(images), np.stack(masks),
                           np.asarray(elevs, np.float32),
                           np.asarray(azims, np.float32), dist)
