from .analytic import Sphere, SphereCloud, quad_solve
from .nerf import MPI, NeRFLE, PartialNeRF, PlainNeRF, volumetric_integrate
from .sdf import (
    SDF, UNIT_SPHERE, FunctionalSDF, SphereSDF, box_sdf, capsule_sdf, march_interval,
    sphere_sdf,
)
