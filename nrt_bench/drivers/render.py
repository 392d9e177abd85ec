"""The render driver: one client renders views back to back through
``render.pathtrace``, called as ``training.evaluate`` calls it (bundle 1,
background 0, a jitter key per view), each view's point light set first, and
each image brought to the host.

A view's latency runs from its first call (the light's update) to its image
in host memory, timed by CUDA events on the device's clock; the stream is
idle when the first event is recorded, since the previous view ended by
waiting for its image.  Set-up renders ``warmup_views`` views of their own.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import program, reference, traffic, weights
from ..tracing import Stretch
from .common import synchronize


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, variant=None):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.variant = variant
        self.pixels = mix["size"] ** 2

    def setup(self):
        mix, dev = self.mix, self.device
        NeRFCamera, Direct, self._pathtrace = program.render_parts()
        self.camera_cls, self.integrator = NeRFCamera, Direct(training=False)
        self.focal = traffic.focal(mix)
        self.weights = weights.make(self.cfg, self.seed, dev)
        scene = program.build_scene(self.cfg, self.weights, dev)
        if self.variant == "bf16":
            program.lower_precision(scene)
        self.scene = program.view_scene(scene, mix)
        self.views = traffic.Views(mix, self.seed)
        warmup = traffic.Views(mix, self.seed, stream=1)
        for i in range(mix["warmup_views"]):
            self._render(warmup[i])
        synchronize(dev)

    def _render(self, view) -> np.ndarray:
        mix = self.mix
        if view["light"] is not None:
            self.scene.lights.set_location(view["light"][None])
        camera = self.camera_cls(torch.from_numpy(view["c2w"][None]), self.focal)
        img, _ = self._pathtrace(self.scene, camera, self.integrator, size=mix["size"],
                                 chunk_size=mix["chunk"], bundle_size=1, background=0.0,
                                 key=view["key"], training=False, device=self.device)
        if self.variant == "altered":
            img = img * 1.05
        elif self.variant == "half_batch":
            img = torch.cat([img[: mix["size"] // 2], torch.zeros_like(img[mix["size"] // 2:])])
        return img.cpu().numpy()

    def _timed(self, i: int) -> None:
        if self.device.type == "cuda":
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            self.images.append(self._render(self.views[i]))
            t1.record()
            t1.synchronize()
            self.view_ms.append(t0.elapsed_time(t1))
        else:
            t = time.perf_counter()
            self.images.append(self._render(self.views[i]))
            self.view_ms.append(1e3 * (time.perf_counter() - t))

    def window(self, seconds: float, trace: bool) -> dict:
        """Views back to back until ``seconds`` have passed; with ``trace``,
        views ``trace_at`` and on run under the profiler."""
        mix = self.mix
        self.stretch = Stretch() if trace else None
        self.images, self.view_ms, self.traced = [], [], []
        start = time.perf_counter()
        i = 0
        while True:
            if trace and i == mix["trace_at"]:
                t = time.perf_counter()
                with self.stretch.record():
                    for _ in range(mix["trace_views"]):
                        self._timed(i)
                        self.traced.append(i)
                        i += 1
                self.trace_wall = time.perf_counter() - t
            else:
                self._timed(i)
                i += 1
            if time.perf_counter() - start >= seconds and (self.traced or not trace):
                break
        self.window_s = time.perf_counter() - start
        self.attempted = i
        return {"render_rays_per_s": i * self.pixels / self.window_s,
                "view_ms_p95": float(np.quantile(np.asarray(self.view_ms), 0.95))}

    def release(self):
        self.scene = None

    # ---- the output check ------------------------------------------------------

    def _reference(self):
        return reference.Scene(self.cfg, self.weights, {
            "max_steps": self.mix["max_steps"], "march_bound": self.mix.get("march_bound"),
            "occlusion": self.mix["occlusion"]})

    def _ref_view(self, scene, view):
        light = None if view["light"] is None else torch.from_numpy(view["light"]).to(self.device)
        return reference.render_view(scene, torch.from_numpy(view["c2w"]).to(self.device),
                                     self.focal, self.mix["size"], self.mix["chunk"],
                                     view["key"], light)

    def check(self) -> dict:
        """Over a sample of the window's views drawn from the seed: the summed
        absolute difference from the reference's images over the reference's
        summed magnitude."""
        rng = traffic.rng_for(self.seed, 2)
        n = len(self.images)
        sample = sorted(rng.choice(n, size=min(self.mix["check_views"], n), replace=False))
        scene = self._reference()
        diff = mag = 0.0
        for i in sample:
            want, _ = self._ref_view(scene, self.views[i])
            got = torch.from_numpy(self.images[i]).to(self.device)
            diff += float(torch.abs(got - want).double().sum())
            mag += float(torch.abs(want).double().sum())
        return {"rel_err": diff / max(mag, 1e-30)}

    # ---- the traced stretch ----------------------------------------------------

    def trace_context(self) -> dict:
        """What the per-layer metrics read: the stretch's summary and the
        work its views needed, counted by the reference over the same rays:
        the rays, the hits, the march's and the shadow march's SDF
        evaluations and the blocked shadow rays."""
        scene = self._reference()
        n = len(self.traced)
        work = {"rays": n * self.pixels, "hits": 0, "march_evals": 0, "shadow_evals": 0,
                "blocked": 0}
        for i in self.traced:
            for k, v in self._ref_view(scene, self.views[i])[1].items():
                work[k] += v
        return {
            "cfg": self.cfg,
            "summary": self.stretch.summary(),
            "units": n,
            # the window without the traced views, whose profiler slows them
            "untraced": {"units": self.attempted - n, "seconds": self.window_s - self.trace_wall},
            "work": work,
        }
