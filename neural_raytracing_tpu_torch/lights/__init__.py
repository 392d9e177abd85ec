from .lights import Constant, LightField, PointLights
