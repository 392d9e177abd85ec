from .integrators import Direct, Integrator
