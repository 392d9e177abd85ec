from .sdf import SDF, SphereSDF, march_interval
