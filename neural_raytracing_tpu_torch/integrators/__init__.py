from .integrators import Direct, Integrator, Mask, NeRFIntegrator, NeRFReproduce
