from .integrators import Direct, Integrator, NeRFIntegrator, NeRFReproduce
