from .nerf import MPI, NeRFLE, PartialNeRF, PlainNeRF, volumetric_integrate
from .sdf import SDF, SphereSDF, march_interval
