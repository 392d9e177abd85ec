from .bsdfs import ComposeSpatialVarying, NeuralBSDF
