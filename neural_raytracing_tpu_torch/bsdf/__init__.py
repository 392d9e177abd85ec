from .bsdfs import ComposeSpatialVarying, Conductor, Diffuse, NeuralBSDF
