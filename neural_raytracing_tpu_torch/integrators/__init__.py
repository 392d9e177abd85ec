from .integrators import (
    BasisBRDF, Debug, Depth, Direct, Illumination, Integrator, LevelSurfaces, Luminance,
    Mask, NeRFIntegrator, NeRFReproduce, NeuralApprox, Path, Silhouette, mis_weight,
)
