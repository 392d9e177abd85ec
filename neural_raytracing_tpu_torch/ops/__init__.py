from .encoding import fourier_basis, fourier_encode, fourier_size
from .frames import coordinate_system, from_local, to_local
from .math import (
    nonzero_eps, normalize, rotate_vector, smooth_min, stable_smooth_min,
)
from .rusin import param_rusin2
