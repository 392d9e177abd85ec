"""Convolutional blocks: the DCGAN critic of the GAN experiment and the
image-embedding encoder.

Counterpart of ``neural_raytracing_tpu/nn/conv.py``.  Images are NCHW,
convolution weights ``[out, in, k, k]`` (``F.conv2d``; the JAX package's
``lax.conv_general_dilated`` with ``("NCHW", "OIHW", "NCHW")``).  Instance
norm over each image's spatial axes with the population variance and eps
1e-5, no running statistics; leaky ReLU of slope 0.2.  The parameter names
follow the JAX params tree: ``c0``-``c4``; ``convs.i``, ``head.w`` and
``head.b``.  No Pallas kernel in the JAX package: plain PyTorch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _conv_init(generator: torch.Generator, k: int, c_in: int, c_out: int) -> torch.Tensor:
    std = math.sqrt(2.0 / (c_in * k * k))
    return std * torch.randn((c_out, c_in, k, k), generator=generator,
                             device=generator.device)


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps)


def _act(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class Discriminator(nn.Module):
    """DCGAN critic over NCHW images (64x64 native, strided to 1 logit):
    ``forward(x [N, C, H, W]) -> logits [N]``."""

    def __init__(self, num_features: int = 64, num_channels: int = 3):
        super().__init__()
        nf, nc = num_features, num_channels
        self.nf, self.nc = nf, nc
        shapes = [(nc, nf), (nf, 2 * nf), (2 * nf, 4 * nf), (4 * nf, 8 * nf), (8 * nf, 1)]
        for i, (c_in, c_out) in enumerate(shapes):
            self.register_parameter(f"c{i}", nn.Parameter(torch.zeros(c_out, c_in, 4, 4)))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        for i in range(5):
            w = getattr(self, f"c{i}")
            w.copy_(_conv_init(generator, 4, w.shape[1], w.shape[0]))

    def init(self, generator: torch.Generator, device="cuda") -> "Discriminator":
        self.to(device)
        self.reset_parameters(generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _act(F.conv2d(x, self.c0, stride=2, padding=1))
        for w in (self.c1, self.c2, self.c3):
            h = _act(_instance_norm(F.conv2d(h, w, stride=2, padding=1)))
        h = F.conv2d(h, self.c4, stride=1, padding=0)
        return h.reshape(x.shape[0], -1).mean(dim=-1)


class _Head(nn.Module):
    def __init__(self, fan_in: int, fan_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(fan_in, fan_out))
        self.b = nn.Parameter(torch.zeros(fan_out))


class Embedder(nn.Module):
    """Image -> latent code: a strided conv pyramid, instance norm (after
    the first layer) and leaky ReLU, a global average pool and a linear
    head.  ``forward(img [N, C, H, W]) -> [N, latent_size]``, any
    resolution."""

    def __init__(self, latent_size: int = 64, num_features: int = 32,
                 num_channels: int = 3, num_layers: int = 4):
        super().__init__()
        self.latent_size = latent_size
        self.nf, self.nc, self.num_layers = num_features, num_channels, num_layers
        convs, c_in = [], num_channels
        for i in range(num_layers):
            c_out = num_features * (2 ** i)
            convs.append(nn.Parameter(torch.zeros(c_out, c_in, 4, 4)))
            c_in = c_out
        self.convs = nn.ParameterList(convs)
        self.head = _Head(c_in, latent_size)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        for w in self.convs:
            w.copy_(_conv_init(generator, 4, w.shape[1], w.shape[0]))
        c_in = self.head.w.shape[0]
        self.head.w.copy_(math.sqrt(1.0 / c_in) * torch.randn(
            self.head.w.shape, generator=generator, device=generator.device))
        self.head.b.zero_()

    def init(self, generator: torch.Generator, device="cuda") -> "Embedder":
        self.to(device)
        self.reset_parameters(generator)
        return self

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        h = img
        for i, w in enumerate(self.convs):
            h = F.conv2d(h, w, stride=2, padding=1)
            if i > 0:
                h = _instance_norm(h)
            h = _act(h)
        feat = h.mean(dim=(2, 3))
        return feat @ self.head.w + self.head.b
