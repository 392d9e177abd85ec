from .dirs import (
    dir_to_elev_azim, dir_to_uv, elev_azim_to_dir, elev_azim_to_uv,
    uv_to_dir, uv_to_elev_azim,
)
from .encoding import fourier_basis, fourier_encode, fourier_size
from .fresnel import fresnel, fresnel_conductor, fresnel_diff_refl
from .frames import coordinate_system, from_local, partial_frame, to_local
from .geometry import distance_between_rays_and_segments, mesh_level_surfaces, ray_point_dist
from .losses import (
    binary_cross_entropy, binary_cross_entropy_with_logits, masked_loss,
)
from .math import (
    INV_PI, PI, TWO_PI, almost_identity, dot, eikonal_loss, fwidth, local_reflect,
    mse2psnr, nonzero_eps, normalize, pos_weak_sigmoid, qmul, quat_rot, reflect,
    rotate_vector, smooth_min, stable_smooth_min, weak_sigmoid,
)
from .misc import (
    cartesian_indices, cartesian_to_log_polar, crop, edge_detection, finite_diff_ray,
    gaussian_kernel, inverse_tan_activation, log_polar_indices,
)
from .rusin import param_rusin, param_rusin2
from .ssim import ms_ssim, ssim
from .warps import (
    random_on_sphere, square_to_cos_hemisphere, square_to_cos_hemisphere_pdf,
    square_to_uniform_disk_concentric, square_to_uniform_sphere,
    square_to_uniform_sphere_pdf,
)
