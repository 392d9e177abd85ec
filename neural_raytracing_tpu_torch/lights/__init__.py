from .lights import LightField
