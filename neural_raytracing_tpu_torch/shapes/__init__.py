from .analytic import Sphere, SphereCloud, quad_solve
from .mesh import TriangleMesh, load_obj
from .nerf import MPI, NeRFLE, PartialNeRF, PlainNeRF, volumetric_integrate
from .sdf import (
    SDF, UNIT_SPHERE, CapsuleSDF, FunctionalSDF, ParametricSDFSet, RoundBoxSDF, SphereSDF,
    box_sdf, capsule_sdf, march_interval, prime, sphere_sdf,
)
