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
twin ``workloads.nerfle``) with the alpha-compositing kernel; the
over-relaxed sphere trace behind the orbit renderer ``workloads.render``;
and the colocate workload (``bsdf.Diffuse``, ``bsdf.Conductor``, the
twin ``workloads.colocate``) with its dataset generator
(``shapes.FunctionalSDF``, ``integrators.Mask``, the twin
``workloads.make_dataset``); and Monte Carlo transport (every BSDF's
``sample``, the ``Constant`` light, Direct's BSDF arm, ``Path``, the debug
integrators, ``shapes.Sphere``/``SphereCloud``, the twin
``workloads.path_nerv``), drawing its uniforms through
``ops.sampling.uniform``; and scene editing (``edits``, ``SDF.with_warp``,
the twins ``workloads.edit_nerf``, ``edit_dtu`` and the multi-light
``eval_nerv``) with the other SDF surfaces, ``shapes.prime``,
``nn.prime_identity`` and the NeRF-- and NeRV cameras; and triangle meshes
(``shapes.TriangleMesh``, ``load_obj``), the rasterizers (``raster``), the
native host ops (``native``, host C++) and ``ops.geometry``, with the mesh
ground truth (``workloads.make_mesh_dataset``, ``make_dtu_dataset
--mesh``), ``workloads.path_demo`` and ``workloads.seed_shape``.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from . import (
    bsdf, cameras, edits, integrators, kernels, lights, native, nn, ops, raster, shapes,
    training, workloads,
)
from .params import load_jax_params, state_dict_from_jax
from .render import pathtrace, pathtrace_sample, render_rays
from .scene import Scene, sample_emitter

__all__ = [
    "bsdf", "cameras", "edits", "integrators", "kernels", "lights", "native", "nn", "ops",
    "raster", "shapes", "training", "workloads", "load_jax_params", "state_dict_from_jax",
    "pathtrace", "pathtrace_sample", "render_rays", "Scene", "sample_emitter",
]
