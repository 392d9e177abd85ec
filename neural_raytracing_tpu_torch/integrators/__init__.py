from .integrators import (
    BasisBRDF, Debug, Depth, Direct, Illumination, Integrator, LevelSurfaces, Luminance,
    Mask, NeRFIntegrator, NeRFReproduce, Path, Silhouette, mis_weight,
)
