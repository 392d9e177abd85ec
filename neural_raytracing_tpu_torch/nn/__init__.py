from .conv import Discriminator, Embedder
from .hash_encoding import HashEncoding, HashSDF
from .mlp import (
    ACTIVATION_GRADS, ACTIVATIONS, AutoDecoder, DensityEstimator, Linear,
    PartitionedAutoDecoder, SkipConnMLP, TwoStageMLP, activation_name, linear, mlp_forward,
    prime_identity, resolve_activation,
)
