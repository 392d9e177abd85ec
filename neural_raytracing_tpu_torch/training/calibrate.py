"""One-shot light-exposure calibration at init.

Counterpart of ``neural_raytracing_tpu/training/calibrate.py``.
``PointLights`` radiance is ``scale * normalize(intensity) / falloff(d)``:
only the scalar ``scale`` and the falloff set the global exposure, and
AdamW at the NeRV light rate (4e-5) moves a scalar by about ``lr * steps``
over a run, so an initial scale far from the capture's cannot train away.
``calibrate_exposure`` renders a few training views with the initial
parameters and rescales ``lights.scale`` so that the masked render
brightness matches the ground truth's.  Nothing else of the scene changes.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..integrators import Direct
from ..render import pathtrace
from .eval import restored_parameters


def calibrate_exposure(scene, state, make_camera: Callable, images, masks, *,
                       size: int, chunk_size: int,
                       light_update: Optional[Callable] = None,
                       views: Optional[Sequence[int]] = None,
                       key: Optional[int] = 2, log_fn: Callable = print):
    """Rescale ``scene.lights.scale`` (in place) so that renders of the
    initial scene match the ground-truth brightness on the object mask.

    ``make_camera([i])`` builds the view-``i`` camera batch;
    ``light_update(scene, camera, [i])`` moves the lights for view ``i``
    before its render (the scene's parameters are restored afterwards).
    Views ``[0, V // 2]`` by default; ``key`` seeds the render jitter (None:
    none).  Returns ``(state, ratio)``.  A light without a ``scale``, and a
    degenerate measurement (no mask pixel, a black ground truth, a render
    that misses the object), leave the scene unchanged with ratio 1.0.
    """
    scale = getattr(scene.lights, "scale", None)
    if not isinstance(scale, torch.Tensor):
        return state, 1.0
    if views is None:
        # a single-image dataset would otherwise render view 0 twice
        views = tuple(sorted({0, len(images) // 2}))
    device = scale.device
    rsum = gsum = 0.0
    n_used = 0
    with restored_parameters(scene):
        for i in views:
            camera = make_camera([i])
            if light_update is not None:
                light_update(scene, camera, [i])
            img, _ = pathtrace(scene, camera, Direct(training=False), size=size,
                               chunk_size=chunk_size, background=0.0, key=key,
                               device=device)
            im = img.cpu().numpy()[..., :3]
            im = im.reshape(im.shape[-3:])
            m = np.asarray(masks[i]) > 0.5
            if not m.any():
                continue
            n_used += 1
            rsum += float(im[m].mean())
            gsum += float(np.asarray(images[i])[..., :3][m].mean())
    # a degenerate measurement is not committed: an empty mask or a black
    # GT would zero the scale, a render missing the object would explode it
    if n_used == 0 or rsum <= 1e-6 or gsum <= 1e-6:
        log_fn("exposure calibration: degenerate measurement "
               f"(views used {n_used}, render {rsum:.2e}, GT {gsum:.2e}) "
               "— leaving light scale unchanged")
        return state, 1.0
    ratio = gsum / rsum
    with torch.no_grad():
        scale.mul_(ratio)
    log_fn(f"exposure calibration: render {rsum / n_used:.4f} "
           f"vs GT {gsum / n_used:.4f} -> scale x{ratio:.4f} = "
           f"{float(scale.detach()):.2f}")
    return state, ratio
