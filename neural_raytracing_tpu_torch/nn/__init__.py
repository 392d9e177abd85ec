from .hash_encoding import HashEncoding, HashSDF
from .mlp import (
    ACTIVATION_GRADS, ACTIVATIONS, Linear, SkipConnMLP, mlp_forward, prime_identity,
)
