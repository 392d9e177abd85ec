from .bsdfs import (
    Bidirectional, Compose, ComposeSpatialVarying, Conductor, Diffuse, GlobalNeuralBSDF,
    NeuralBSDF, Phong, Plastic, SelectBSDF, invert_z,
)
