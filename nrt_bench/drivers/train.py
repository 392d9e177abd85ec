"""The training driver: ``training.train`` on the host data path, called in
fixed blocks of steps with the state carried from block to block.

Set-up makes the ground truth and the weights from the seed, builds the
program's scene, optimizer and step, and runs the first block of
``warmup_steps`` steps through the same call and feed as the window; those
steps are recorded (their views, crop corners, the generator's state, the
losses, the parameters after the last of them) for the reference to
follow.  The window then runs blocks of ``block_steps`` until ``--seconds``
have passed, the last one to its end.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import program, reference, traffic, weights
from ..tracing import Stretch
from .common import leaf_gaps, median, synchronize


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, variant=None):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.variant = variant
        self.rays = mix["n_views"] * mix["crop"] ** 2

    # ---- set-up ----------------------------------------------------------------

    def setup(self):
        mix, cfg, dev = self.mix, self.cfg, self.device
        NeRFCamera, Direct, TrainState, build_step_fn, make_optimizer, self._train = \
            program.train_parts()
        self.c2ws, self.images, self.masks = traffic.sphere_ground_truth(mix, self.seed, dev)
        self.focal = traffic.focal(mix)
        self.weights = weights.make(cfg, self.seed, dev)
        scene = program.build_scene(cfg, self.weights, dev)
        scene = scene.replace(shape=scene.shape.replace(max_steps=mix["max_steps"]))
        if self.variant == "bf16":
            program.lower_precision(scene)
        o = cfg["optimizer"]
        self.opt_cfg = make_optimizer(o["lrs"], default_lr=o["default_lr"],
                                      weight_decay=o["weight_decay"], b1=o["b1"], b2=o["b2"],
                                      eps=o["eps"])
        self.state = TrainState(scene, self.opt_cfg.init(scene), 0)
        self.names = {p: k for k, p in scene.named_parameters()}
        self.integrator = Direct(training=True)
        self.extra_loss = program.extra_loss(cfg)
        self.step = build_step_fn(scene, self.integrator, self.opt_cfg, size=mix["size"],
                                  crop_size=mix["crop"], mask_weight=cfg["loss"]["mask_weight"],
                                  with_ssim=cfg["loss"]["ssim"], extra_loss=self.extra_loss)
        self.make_camera_cls = NeRFCamera
        self.generator = torch.Generator(device=dev).manual_seed(
            int(traffic.rng_for(self.seed, 3).integers(0, 2 ** 62)))
        self.records, self.traced = [], []
        self.steps_done = self.blocks = 0
        self._tracing = False
        self._recording = True
        self._block(mix["warmup_steps"])
        self._recording = False
        synchronize(dev)

    def _make_camera(self, idxs):
        self._idxs = [int(i) for i in idxs]
        return self.make_camera_cls(torch.from_numpy(self.c2ws[np.asarray(idxs)]), self.focal)

    def _step(self, state, camera, uv, exp, mask, generator=None):
        i = self.steps_done
        rec = {"idxs": self._idxs, "uv": (int(uv[0]), int(uv[1]))}
        if self._recording:
            rec["generator"] = generator.get_state().clone()
            self.records.append(rec)
        if self._tracing:
            self.traced.append(rec)
        if self.variant == "unchanged":
            new_state, aux = state, {"loss": torch.zeros((), device=self.device)}
        elif self.variant == "half_batch":
            h = len(camera) // 2
            half = self.make_camera_cls(camera.cam_to_world[:h], camera.focal)
            new_state, aux = self.step(state, half, uv, exp[:h], mask[:h], generator)
        else:
            new_state, aux = self.step(state, camera, uv, exp, mask, generator)
        if self._recording:
            rec["loss"] = aux["loss"]
            if i == 0:
                self.first_grads = self._first_grads(new_state.optimizer)
            if i == self.mix["warmup_steps"] - 1:
                self.params_after = {k: p.detach().clone() for p, k in self.names.items()}
        self.steps_done += 1
        return new_state, aux

    def _first_grads(self, optimizer) -> dict:
        """The first step's gradient as the optimizer got it, worked out from
        its state: AdamW's first moment after one step is ``(1 - b1) g``.  A
        leaf the step left without a moment reads 0."""
        b1 = self.cfg["optimizer"]["b1"]
        out = {}
        for p, k in self.names.items():
            m = optimizer.state.get(p, {}).get("exp_avg")
            out[k] = torch.zeros_like(p) if m is None else m.detach() / (1.0 - b1)
        return out

    def _block(self, n: int):
        mix = self.mix
        self.state, _ = self._train(
            self.state.scene, self.integrator, self.opt_cfg, self.state, self._make_camera,
            self.images, self.masks, self.generator, size=mix["size"], crop_size=mix["crop"],
            iters=n, n_views=mix["n_views"], mask_weight=self.cfg["loss"]["mask_weight"],
            with_ssim=self.cfg["loss"]["ssim"], extra_loss=self.extra_loss, log_every=0,
            step_fn=self._step, seed=self._block_seed())
        self.blocks += 1

    def _block_seed(self) -> int:
        """Each block's crops come from a seed of its own: ``train`` seeds its
        crop generator afresh at each call."""
        return int(traffic.rng_for(self.seed, 4, self.blocks).integers(0, 2 ** 31))

    # ---- the window ------------------------------------------------------------

    def window(self, seconds: float, trace: bool) -> dict:
        mix, dev = self.mix, self.device
        self.stretch = Stretch() if trace else None
        first = self.steps_done
        traced = not trace
        start = time.perf_counter()
        while True:
            if not traced and self.blocks >= 2:
                self.trace_params = {k: p.detach().clone() for p, k in self.names.items()}
                t = time.perf_counter()
                with self.stretch.record():
                    self._tracing = True
                    self._block(mix["trace_steps"])
                    self._tracing = False
                self.trace_wall = time.perf_counter() - t
                traced = True
            self._block(mix["block_steps"])
            if traced and time.perf_counter() - start >= seconds:
                break
        synchronize(dev)
        self.window_s = time.perf_counter() - start
        self.window_steps = self.steps_done - first
        self.attempted = self.window_steps
        return {"train_rays_per_s": self.window_steps * self.rays / self.window_s}

    def release(self):
        """Frees the program's state; what the checks read was copied."""
        self.state = self.step = self.opt_cfg = None
        for rec in self.records:
            rec["loss"] = float(rec["loss"])

    # ---- the output check ------------------------------------------------------

    def _steps_for_reference(self, records):
        out = []
        for rec in records:
            jitter = None
            if "generator" in rec:
                g = torch.Generator(device=self.device)
                g.set_state(rec["generator"])
                jitter = torch.rand((), generator=g, device=self.device)
            out.append({"c2w": torch.from_numpy(self.c2ws[rec["idxs"]]).to(self.device),
                        "idxs": rec["idxs"], "uv": rec["uv"], "jitter": jitter})
        return out

    def check(self) -> dict:
        """The numbers of the recorded steps, each leaf's gap relative to the
        reference's norm of that leaf or of the median leaf: the first step's
        loss gap (``loss_gap_first``, relative to the reference's loss) and
        the worst step's; the gaps of the norm of the first gradient, as the
        optimizer got it, by the worst and the median leaf (``grad_gap_*``);
        and of the norm of the parameters' change over the recorded steps
        (``update_gap_*``).  The limits file says which are compared
        (PERF.md gives the readings)."""
        images = torch.from_numpy(self.images).to(self.device)
        masks = torch.from_numpy(self.masks).to(self.device)
        losses, grads, params = reference.train_steps(
            self.cfg, self.weights, self._steps_for_reference(self.records),
            march={"max_steps": self.mix["max_steps"]}, size=self.mix["size"],
            crop=self.mix["crop"], focal=self.focal, images=images, masks=masks,
            loss_cfg=self.cfg["loss"])
        loss_gaps = [abs(float(r["loss"]) - want) / max(abs(want), 1e-30)
                     for r, want in zip(self.records, losses)]
        w0 = self.weights
        grad = leaf_gaps({k: self.first_grads[k] for k in grads}, grads, grads)
        update = leaf_gaps({k: self.params_after[k] - w0[k] for k in grads},
                           {k: params[k] - w0[k] for k in grads}, grads)
        return {"loss_gap_first": loss_gaps[0], "loss_gap_worst": max(loss_gaps),
                "grad_gap_worst": max(grad.values()), "grad_gap_median": median(grad.values()),
                "update_gap_worst": max(update.values()),
                "update_gap_median": median(update.values())}

    # ---- the traced stretch ----------------------------------------------------

    def trace_context(self) -> dict:
        """What the per-layer metrics read: the stretch's summary and the
        work its steps needed, counted by the reference's march over the
        same rays at the parameters the stretch started from: the rays, the
        hits, the march's SDF evaluations and the min-scan's samples."""
        scene = reference.Scene(self.cfg, self.trace_params | {
            k: v for k, v in self.weights.items() if reference.is_basis(k)},
            {"max_steps": self.mix["max_steps"]})
        mix = self.mix
        n = len(self.traced)
        work = {"rays": n * self.rays, "hits": 0, "march_evals": 0,
                "scan_evals": n * self.rays * (self.cfg["sdf"]["throughput_steps"] + 1)}
        with torch.no_grad(), reference.full_float32():
            for rec in self.traced:
                u, v = rec["uv"]
                rays = reference.camera_rays(
                    torch.from_numpy(self.c2ws[rec["idxs"]]).to(self.device), self.focal,
                    reference.tile_positions(float(u), float(v), mix["crop"], self.device),
                    mix["size"])
                _, hit, evals = scene.intersect(rays, primary=False)
                work["hits"] += int(hit.sum())
                work["march_evals"] += int(evals.sum())
        return {
            "cfg": self.cfg,
            "summary": self.stretch.summary(),
            "units": n,
            # the window without the traced block, whose profiler slows it
            "untraced": {"units": self.window_steps - n,
                         "seconds": self.window_s - self.trace_wall},
            "work": work,
        }
