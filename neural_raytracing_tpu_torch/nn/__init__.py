from .mlp import ACTIVATION_GRADS, ACTIVATIONS, Linear, SkipConnMLP, mlp_forward
