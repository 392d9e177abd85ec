from .bsdfs import (
    Bidirectional, Compose, ComposeSpatialVarying, Conductor, Diffuse, GlobalNeuralBSDF,
    NeuralBSDF, Phong, Plastic, SelectBSDF, identity, identity_div_pi, invert_z,
)
