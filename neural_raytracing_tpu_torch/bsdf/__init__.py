from .bsdfs import (
    Bidirectional, Compose, ComposeSpatialVarying, Conductor, Diffuse, NeuralBSDF, Phong,
    Plastic, SelectBSDF, invert_z,
)
