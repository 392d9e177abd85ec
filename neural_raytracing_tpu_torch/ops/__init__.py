from .dirs import (
    dir_to_elev_azim, dir_to_uv, elev_azim_to_dir, elev_azim_to_uv,
    uv_to_dir, uv_to_elev_azim,
)
from .encoding import fourier_basis, fourier_encode, fourier_size
from .frames import coordinate_system, from_local, to_local
from .losses import (
    binary_cross_entropy, binary_cross_entropy_with_logits, masked_loss,
)
from .math import (
    eikonal_loss, mse2psnr, nonzero_eps, normalize, rotate_vector, smooth_min,
    stable_smooth_min,
)
from .rusin import param_rusin2
from .ssim import ms_ssim, ssim
