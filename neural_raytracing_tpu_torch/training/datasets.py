"""Dataset loaders.

Counterparts of ``load_nerf_synthetic``, ``load_nerv`` and
``load_colocate`` in ``neural_raytracing_tpu/training/datasets.py``:
``transforms_{split}.json`` plus one PNG per frame; the focal length from
``camera_angle_x``; masks ``ceil(alpha - 1e-5)``.  NeRF-synthetic camera
translations are normalised to unit distance; NeRV's are not, and each NeRV
frame carries its point light's ``light_loc`` (and ``light_weights`` where
present).  The colocated set (mitsuba ``cbox_relight``) is an elevation x
azimuth grid of ``{kind}_{i}_{j}.png`` renders, camera and light together.
Its relight ground truth (``load_colocate_relight_grid``) is the 4 x 4
camera x 3 x 3 light grid ``gt_{kind}_{i}_{j}_{k}_{l}.png``.  A DTU / IDR
scan (``load_dtu``) is ``cameras.npz`` (``world_mat_i = K [R | t]`` and
``scale_mat_i``) beside ``image/`` and ``mask/``: each projection is
decomposed into an intrinsic and a camera-to-world pose
(``decompose_projection``, an RQ decomposition in numpy) and the camera
centres are scaled into the unit sphere (``dtu_dataset``, which takes the
arrays in memory).
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


def decompose_projection(P: np.ndarray):
    """P [3, 4] = K [R | t] -> (K [3, 3], R [3, 3], camera centre c [3]).

    An RQ decomposition of ``P[:, :3]`` with K's diagonal made positive (for
    this use the same as ``cv2.decomposeProjectionMatrix``).
    """
    M = P[:3, :3]
    # RQ through a flipped QR
    flip = np.flipud(np.eye(3))
    q, r = np.linalg.qr((flip @ M).T)
    K = flip @ r.T @ flip
    R = flip @ q.T
    signs = np.sign(np.diag(K))
    signs[signs == 0] = 1.0
    S = np.diag(signs)
    K = K @ S
    R = S @ R
    if np.linalg.det(R) < 0:
        R = -R
    c = -np.linalg.inv(M) @ P[:3, 3]
    K = K / K[2, 2]
    return K, R, c


class DTUDataset(NamedTuple):
    poses: np.ndarray           # [V, 4, 4] camera-to-world
    intrinsics: np.ndarray      # [V, 4, 4]
    images: np.ndarray          # [V, H, W, 3]
    masks: np.ndarray           # [V, H, W]
    src_size: tuple             # the intrinsics' image size (w, h)


def dtu_dataset(cams, images: np.ndarray, masks: np.ndarray, size: int,
                src_size: tuple = (1600, 1200),
                normalize_dist: bool = True) -> DTUDataset:
    """A DTU scan from arrays: ``cams`` maps ``world_mat_i`` (and optionally
    ``scale_mat_i``) to ``[4, 4]`` matrices, ``images`` ``[V, H, W, >=3]``,
    ``masks`` ``[V, H, W]`` in {0, 1}.  ``size`` is the images' size, kept
    for ``load_dtu``'s signature.  ``normalize_dist`` divides every camera
    centre by the largest centre distance, so the farthest camera sits on
    the unit sphere."""
    del size
    poses, intrinsics = [], []
    for i in range(len(images)):
        world_mat = cams[f"world_mat_{i}"]
        scale_mat = cams.get(f"scale_mat_{i}", np.eye(4))
        P = (world_mat @ scale_mat)[:3, :4]
        K, R, c = decompose_projection(P)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = R.T
        pose[:3, 3] = c
        intr = np.eye(4, dtype=np.float32)
        intr[:3, :3] = K
        poses.append(pose)
        intrinsics.append(intr)
    poses = np.stack(poses)
    if normalize_dist:
        max_dist = max(float(np.linalg.norm(poses[:, :3, 3], axis=-1).max()), 1e-6)
        poses[:, :3, 3] /= max_dist
    return DTUDataset(poses, np.stack(intrinsics), np.asarray(images)[..., :3],
                      np.asarray(masks), src_size)


def load_dtu(directory: str, size: int, image_dir: str = "image",
             mask_dir: str = "mask", src_size: tuple = (1600, 1200),
             normalize_dist: bool = True) -> DTUDataset:
    """A DTU / IDR scan: ``cameras.npz``, the sorted PNGs of ``image_dir``
    and ``mask_dir`` resized to ``size``; a mask is its first channel
    ``> 0.5``.  See ``dtu_dataset``."""
    cams = dict(np.load(os.path.join(directory, "cameras.npz")))
    img_files = sorted(os.listdir(os.path.join(directory, image_dir)))
    mask_files = sorted(os.listdir(os.path.join(directory, mask_dir)))
    images, masks = [], []
    for i in range(len(img_files)):
        img = load_image(os.path.join(directory, image_dir, img_files[i]),
                         resize=(size, size))
        images.append(img[..., :3])
        m = load_image(os.path.join(directory, mask_dir, mask_files[i]),
                       resize=(size, size))
        if m.ndim == 3:
            m = m[..., 0]
        masks.append((m > 0.5).astype(np.float32))
    return dtu_dataset(cams, np.stack(images), np.stack(masks), size,
                       src_size=src_size, normalize_dist=normalize_dist)


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


def load_colocate_relight_grid(directory: str, kind: str, size: int,
                               n_cam: int = 4, n_light: int = 3) -> dict:
    """Relight ground truth ``gt_{kind}_{i}_{j}_{k}_{l}.png`` (camera ``i, j``,
    light ``k, l``) -> ``{(i, j, k, l): image [size, size, C]}``; missing
    files are left out."""
    out = {}
    for i in range(n_cam):
        for j in range(n_cam):
            for k in range(n_light):
                for l in range(n_light):
                    path = os.path.join(directory, f"gt_{kind}_{i}_{j}_{k}_{l}.png")
                    if os.path.exists(path):
                        out[(i, j, k, l)] = load_image(path, resize=(size, size))
    return out
