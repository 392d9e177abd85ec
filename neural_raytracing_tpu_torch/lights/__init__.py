from .lights import LightField, PointLights
