from .mlp import ACTIVATIONS, Linear, SkipConnMLP, mlp_forward
