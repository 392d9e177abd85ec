"""neural_raytracing_tpu_torch — the PyTorch and CUDA port of neural_raytracing_tpu.

A second package beside the JAX one, for one NVIDIA H100.  It mirrors the
JAX package's layout and names; each kernel the JAX package wrote in Pallas
for the TPU is a CUDA kernel written for Hopper here (``csrc/``), with a
plain PyTorch version beside it (``kernels/``).

Ported so far: the flagship eval render (``pathtrace`` with
``Direct(training=False)`` over ``SDF(SphereSDF)``,
``ComposeSpatialVarying(NeuralBSDF)`` and ``LightField``) and its training
step and host loop (``training.train``, ``training.evaluate``), with the
fused MLP forward and backward, fused sphere-trace and fused silhouette
min-scan kernels; and the NeRV workload (``workloads.nerv``: per-view
``PointLights``, hard and learned occlusion through the fused shadow march,
``FusedSphereSDF`` through the fused SphereSDF kernel); the NeRF-family
volume path (``shapes.nerf``, ``NeRFReproduce``, ``pathtrace_sample``, the
twin ``workloads.nerfle``) with the alpha-compositing kernel; and the
over-relaxed sphere trace behind the orbit renderer ``workloads.render``.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from . import (
    bsdf, cameras, integrators, kernels, lights, nn, ops, shapes, training,
    workloads,
)
from .params import load_jax_params, state_dict_from_jax
from .render import pathtrace, pathtrace_sample, render_rays
from .scene import Scene, sample_emitter

__all__ = [
    "bsdf", "cameras", "integrators", "kernels", "lights", "nn", "ops",
    "shapes", "training", "workloads", "load_jax_params", "state_dict_from_jax",
    "pathtrace", "pathtrace_sample", "render_rays", "Scene", "sample_emitter",
]
