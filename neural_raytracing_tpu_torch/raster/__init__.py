"""Rasterizers, blends, compositors and the mesh utility ops.

Counterpart of ``neural_raytracing_tpu/raster``: plain PyTorch on the
tensors' device (the JAX package's forms are plain ``jnp``; none has a
Pallas kernel).
"""

from .meshops import (
    edge_point_distance, face_areas_normals, face_point_distance, gather_scatter,
    interp_face_attrs, packed_to_padded, padded_to_packed, point_edge_distance,
    point_face_distance, point_line_seg_dists, point_triangle_dists,
)
from .rasterize import Fragments, pix_to_ndc, rasterize_meshes, rasterize_points, rasterize_spheres
from .blending import hard_rgb_blend, sigmoid_alpha_blend, softmax_rgb_blend
from .compositing import alpha_composite, norm_weighted_sum, weighted_sum
from .renderer import (
    MeshRasterizer, PointsRasterizer, RasterizationSettings, SphereFragments,
    SpheresRasterizer, transform_points_screen,
)
from .pulsar import PulsarRenderer
