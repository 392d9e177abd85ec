"""BSDFs: the analytic lobes, the neural lobe and their mixtures.

Counterpart of ``neural_raytracing_tpu/bsdf/bsdfs.py``:
  * ``NeuralBSDF``: one lobe, ``act(MLP(param_rusin2(wi, wo)))``;
  * ``ComposeSpatialVarying``: the spatially-varying mixture, weights
    ``sigmoid(MLP_16x256(x))`` per basis lobe;
  * ``Diffuse``: a Lambertian lobe with a learnable reflectance;
  * ``Conductor``: a near-mirror lobe, thresholded around the reflection
    vector, with the conductor Fresnel term;
  * ``Phong``, ``Plastic``: learnable Phong and Mitsuba-style smooth
    plastic lobes;
  * ``Bidirectional``: a two-sided wrapper that flips the local frame for
    back-facing hits;
  * ``Compose``: a global softmax mixture; ``SelectBSDF``: a hard spatial
    pick by a selector function;
  * ``GlobalNeuralBSDF``: one global pair of nets, attenuation over
    ``param_rusin(n, wi, wo)`` times colour over the position, with a
    ``DensityEstimator`` over uv as its pdf and sampler.

``eval_and_pdf(it, wo, active) -> (spectrum [..., 3], pdf [...], aux)`` and
``sample(it, generator, active) -> (BSDFSample, spectrum [..., 3])``.  Every
sampler draws its uniforms through ``ops.sampling.uniform``; a mixture picks
its basis by a Gumbel-argmax, as the JAX package does.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..interaction import BSDFSample
from ..kernels.fused_mlp import FusedSkipConnMLP
from ..nn.mlp import ACTIVATIONS, DensityEstimator, SkipConnMLP, resolve_activation
from ..ops import sampling
from ..ops.dirs import dir_to_uv, uv_to_dir
from ..ops.fresnel import fresnel, fresnel_conductor, fresnel_diff_refl
from ..ops.math import local_reflect, maximum, normalize, reflect
from ..ops.rusin import param_rusin, param_rusin2
from ..ops.warps import square_to_cos_hemisphere, square_to_cos_hemisphere_pdf


def active_mask(active, batch_shape, device) -> torch.Tensor:
    """``active`` (a bool or a bool tensor) broadcast to ``batch_shape``."""
    return torch.as_tensor(active, dtype=torch.bool, device=device).expand(batch_shape)


def invert_z(xyz: torch.Tensor) -> torch.Tensor:
    """``(x, y, z) -> (x, y, -z)``: the bits, and the gradient, of a
    product with (1, 1, -1)."""
    return torch.cat([xyz[..., :2], -xyz[..., 2:]], dim=-1)


def gumbel_argmax(generator, weights: torch.Tensor) -> torch.Tensor:
    """A categorical pick ``~ weights`` over the last axis (Gumbel-argmax):
    one uniform on ``[1e-10, 1)`` a weight."""
    u = sampling.uniform(generator, weights.shape, weights.device, minval=1e-10,
                         batch_axis=0)
    gumbel = -torch.log(-torch.log(u))
    # torch.argmax, like jnp.argmax, returns the first of tied maxima
    return torch.argmax(torch.log(maximum(weights, 1e-20)) + gumbel, dim=-1)


def combine_samples(samples, onehot: torch.Tensor):
    """Gather per-basis ``(BSDFSample, spectrum)`` pairs by a one-hot pick
    ``[..., K]`` -> (wo [..., 3], pdf [...], spectrum [..., 3])."""
    wos = torch.stack([bs.wo for bs, _ in samples], dim=-1)         # [..., 3, K]
    pdfs = torch.stack([bs.pdf for bs, _ in samples], dim=-1)       # [..., K]
    specs = torch.stack([s for _, s in samples], dim=-1)            # [..., 3, K]
    wo = normalize(torch.sum(wos * onehot[..., None, :], dim=-1))
    pdf = torch.sum(pdfs * onehot, dim=-1)
    spectrum = torch.sum(specs * onehot[..., None, :], dim=-1)
    return wo, pdf, spectrum


def one_hot(idx: torch.Tensor, k: int) -> torch.Tensor:
    return F.one_hot(idx.long(), k).to(torch.float32)


def cos_hemisphere_sample(it, generator, active=True) -> BSDFSample:
    """A cosine-weighted direction on the local upper hemisphere."""
    u = sampling.uniform(generator, it.p.shape[:-1] + (2,), it.p.device, batch_axis=0)
    wo = normalize(square_to_cos_hemisphere(u))
    return BSDFSample(wo=wo, pdf=square_to_cos_hemisphere_pdf(wo))


class _Leaves(nn.Module):
    """A BSDF whose parameters are constant leaves, reset to their initial
    values (``self._init``: name -> tensor)."""

    def _register(self, **init):
        self._init = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in init.items()}
        for name, value in self._init.items():
            self.register_parameter(name, nn.Parameter(value.clone()))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None):
        for name, value in self._init.items():
            getattr(self, name).copy_(value)


class NeuralBSDF(nn.Module):
    """Single neural lobe: MLP(rusin(wi, wo)) -> RGB, cos-hemisphere sampling.
    ``zero()`` makes it return black (an ablation)."""

    def __init__(self, activation="sigmoid",
                 mlp: Optional[SkipConnMLP] = None):
        super().__init__()
        if mlp is None:
            mlp = FusedSkipConnMLP(in_size=3, out=3, num_layers=6,
                                   hidden_size=96, freqs=64)
        self.mlp = mlp
        self.act = resolve_activation(activation)
        self.zeroed = False

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.mlp.reset_parameters(generator)

    def zero(self) -> "NeuralBSDF":
        self.zeroed = True
        return self

    def _spectrum(self, it, wo: torch.Tensor) -> torch.Tensor:
        if self.zeroed:
            return torch.zeros(it.p.shape[:-1] + (3,), dtype=it.p.dtype, device=it.p.device)
        # argument order of the reference: param_rusin2(it.wi, wo)
        return self.act(self.mlp(param_rusin2(it.wi, wo)))

    def eval_and_pdf(self, it, wo: torch.Tensor, active=True):
        spectrum = self._spectrum(it, wo)
        pdf = torch.ones(spectrum.shape[:-1], dtype=spectrum.dtype,
                         device=spectrum.device)
        return spectrum, pdf, {}

    def sample(self, it, generator, active=True):
        bs = cos_hemisphere_sample(it, generator)
        return bs, self._spectrum(it, bs.wo)


def identity(x):
    return x


class ComposeSpatialVarying(nn.Module):
    """Spatially-varying mixture: weights = sigmoid(MLP(preprocess(x))) per
    basis BSDF.  ``preprocess`` maps the hit points before the weight net
    (``identity``, the default); it is a torch function, so gradients reach
    the points through it."""

    def __init__(self, bsdfs: Sequence[nn.Module],
                 sp_var_fn: Optional[SkipConnMLP] = None,
                 preprocess: Callable = identity):
        super().__init__()
        self.bsdfs = nn.ModuleList(bsdfs)
        if sp_var_fn is None:
            sp_var_fn = FusedSkipConnMLP(
                in_size=3, out=len(self.bsdfs), num_layers=16,
                hidden_size=256, freqs=128, sigma=128.0, init="xavier")
        self.sp_var_fn = sp_var_fn
        self.preprocess = preprocess

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        for b in self.bsdfs:
            b.reset_parameters(generator)
        self.sp_var_fn.reset_parameters(generator)

    def normalized_weights(self, p: torch.Tensor):
        """-> (sigmoid weights [..., K], raw logits [..., K])."""
        raw = self.sp_var_fn(self.preprocess(p))
        # the reference uses sigmoid rather than softmax
        return torch.sigmoid(raw), raw

    def eval_and_pdf(self, it, wo: torch.Tensor, active=True):
        k, raw = self.normalized_weights(it.p)
        spec_pdf = torch.stack([
            torch.cat([s, p[..., None]], dim=-1)
            for s, p, _ in (b.eval_and_pdf(it, wo, active) for b in self.bsdfs)
        ], dim=-1)                                            # [..., 4, K]
        ok = active_mask(active, it.p.shape[:-1], it.p.device)
        spec_pdf = torch.where(ok[..., None, None], spec_pdf * k[..., None, :], 0.0)
        summed = torch.sum(spec_pdf, dim=-1)
        aux = {"nonnormalized_weights": raw, "normalized_weights": k}
        # the spectrum keeps the sigmoid weighting (k does not sum to 1);
        # the pdf is the density of sample()'s categorical pick ~ k, hence / sum k
        ksum = maximum(torch.sum(k, dim=-1), 1e-10)
        return summed[..., :3], summed[..., 3] / ksum, aux

    def sample(self, it, generator, active=True):
        samples = [b.sample(it, generator, active) for b in self.bsdfs]
        k, _ = self.normalized_weights(it.p)
        onehot = one_hot(gumbel_argmax(generator, k), len(self.bsdfs))
        wo, pdf, spectrum = combine_samples(samples, onehot)
        # the pick of basis i has probability k_i / sum k: that factor, not
        # the raw sigmoid weight, multiplies the basis pdf
        sel = torch.sum(k * onehot, dim=-1) / maximum(torch.sum(k, dim=-1), 1e-10)
        return BSDFSample(wo=wo, pdf=pdf * sel), spectrum


def identity_div_pi(x):
    # divided by pi, not multiplied by 1/pi, as the JAX package does
    return x / math.pi


class Diffuse(_Leaves):
    """Lambertian lobe with a learnable reflectance colour ``[3]``;
    ``preprocess`` maps the spectrum (``identity_div_pi``, the default:
    reflectance over pi).  As in the JAX package, its spectrum is not
    masked by ``active`` (nor clamped below the horizon)."""

    def __init__(self, reflectance=(0.25, 0.2, 0.7), preprocess: Callable = identity_div_pi):
        super().__init__()
        self._register(reflectance=reflectance)
        self.preproc = preprocess

    def eval_and_pdf(self, it, wo: torch.Tensor, active=True):
        cos_theta_o = wo[..., 2]
        spectrum = self.preproc(cos_theta_o[..., None] * self.reflectance)
        return spectrum, square_to_cos_hemisphere_pdf(wo), {}

    def sample(self, it, generator, active=True):
        bs = cos_hemisphere_sample(it, generator)
        return bs, self.preproc(self.reflectance).expand(it.p.shape)


class Conductor(_Leaves):
    """Near-mirror conductor lobe: ``fresnel_conductor(cos_i,
    softplus(eta), 0) * act(specular)`` where ``local_reflect(wi) . wo``
    exceeds ``threshold``, else 0 (pdf 1 or 0).  ``activation`` is a
    registered name or a callable (``sigmoid``, the default); ``threshold``
    0.94 by default.

    ``specular`` is ``[3]``, ``eta`` and ``k`` are 0-d.  ``sample`` reflects
    ``wi`` (no draw) and, as the JAX package does, reads ``eta`` raw, ``k``
    (its only reader) and ``specular`` without the sigmoid.  torch's
    softplus is linear above 20 and jax's is not (below float32 resolution
    there).
    """

    def __init__(self, specular=(1.0, 1.0, 1.0), eta: float = 1.3,
                 k: float = 1.0, activation="sigmoid", threshold: float = 0.94):
        super().__init__()
        self._register(specular=specular, eta=float(eta), k=float(k))
        self.act = resolve_activation(activation)
        self.threshold = float(threshold)

    def eval_and_pdf(self, it, wo: torch.Tensor, active=True):
        refl = local_reflect(it.wi)
        thresh = torch.sum(refl * wo, dim=-1) > self.threshold
        fr = fresnel_conductor(it.wi[..., 2], ACTIVATIONS["softplus"](self.eta), 0.0)
        spectrum = torch.where(thresh[..., None],
                               fr[..., None] * self.act(self.specular), 0.0)
        pdf = torch.where(thresh, 1.0, 0.0)
        ok = active_mask(active, it.p.shape[:-1], it.p.device)
        spectrum = torch.where(ok[..., None], spectrum, 0.0)
        return spectrum, pdf, {}

    def sample(self, it, generator, active=True):
        cos_theta_i = it.wi[..., 2]
        ok = active_mask(active, it.p.shape[:-1], it.p.device) & (cos_theta_i > 0)
        fr = fresnel_conductor(cos_theta_i, self.eta, self.k)
        spectrum = torch.where(ok[..., None], self.specular * fr[..., None], 0.0)
        return (BSDFSample(wo=local_reflect(it.wi), pdf=torch.ones_like(cos_theta_i)),
                spectrum)


class Phong(_Leaves):
    """Phong lobe with learnable ``diffuse`` and ``specular`` colours
    ``[3]`` and shininess ``shine`` (0-d; exponent ``min_spec +
    exp(shine)``).  As in the JAX package the mirror direction reflects the
    local ``wi`` about the world normal ``frame[..., 2]``."""

    def __init__(self, diffuse=(0.6, 0.5, 0.7), specular=(0.8, 0.8, 0.8),
                 shine: float = 40.0, min_spec: float = 1.0):
        super().__init__()
        self._register(diffuse=diffuse, specular=specular, shine=float(shine))
        self.min_spec = float(min_spec)

    def _spectrum(self, it, wo):
        cos_theta_i = it.wi[..., 2]
        r = reflect(it.frame[..., 2], it.wi)
        spectral = torch.pow(maximum(torch.sum(r * wo, dim=-1), 1e-20),
                             self.min_spec + torch.exp(self.shine))
        return (cos_theta_i[..., None] * self.diffuse / math.pi
                + spectral[..., None] * self.specular / math.pi)

    def eval_and_pdf(self, it, wo: torch.Tensor, active=True):
        return self._spectrum(it, wo), square_to_cos_hemisphere_pdf(wo), {}

    def sample(self, it, generator, active=True):
        u = sampling.uniform(generator, it.p.shape[:-1] + (2,), it.p.device, batch_axis=0)
        wo = square_to_cos_hemisphere(u)
        pdf = square_to_cos_hemisphere_pdf(wo)
        ok = (active_mask(active, it.p.shape[:-1], it.p.device)
              & (it.wi[..., 2] > 0) & (wo[..., 2] > 0) & (pdf > 0))
        spectrum = torch.where(ok[..., None], self._spectrum(it, wo), 0.0)
        return BSDFSample(wo=wo, pdf=pdf), spectrum


class Plastic(_Leaves):
    """Mitsuba-style smooth plastic: a specular lobe over an internally
    scattered diffuse one, learnable ``diffuse`` and ``specular`` ``[3]``."""

    def __init__(self, diffuse=(0.5, 0.5, 0.5), specular=(1.0, 1.0, 1.0),
                 int_ior: float = 1.49, ext_ior: float = 1.000277):
        super().__init__()
        if int_ior <= 0 or ext_ior <= 0:
            raise ValueError("Plastic needs positive indices of refraction")
        self._register(diffuse=diffuse, specular=specular)
        self.eta = int_ior / ext_ior
        self.inv_eta_2 = 1.0 / (self.eta * self.eta)
        self.fdr_int = fresnel_diff_refl(1.0 / self.eta)
        self.fdr_ext = fresnel_diff_refl(self.eta)

    def _spec_sample_weight(self):
        d = torch.mean(self.diffuse)
        s = torch.mean(self.specular)
        return s / (d + s)

    def eval_and_pdf(self, it, wo: torch.Tensor, active=True):
        f_i = fresnel(it.wi[..., 2], self.eta)[0]
        f_o = fresnel(wo[..., 2], self.eta)[0]
        pdf = square_to_cos_hemisphere_pdf(wo)
        spectrum = (self.diffuse / (1.0 - self.fdr_int) * self.inv_eta_2
                    * (pdf * (1.0 - f_i) * (1.0 - f_o))[..., None])
        ssw = self._spec_sample_weight()
        prob_specular = ssw * f_i
        prob_diffuse = (1.0 - f_i) * (1.0 - ssw)
        prob_diffuse = prob_diffuse / (prob_specular + prob_diffuse)
        return spectrum, pdf * prob_diffuse, {}

    def sample(self, it, generator, active=True):
        cos_theta_i = it.wi[..., 2]
        f_i = fresnel(cos_theta_i, self.eta)[0]
        ssw = self._spec_sample_weight()
        p_spec = f_i * ssw
        p_diff = (1.0 - f_i) * (1.0 - ssw)
        p_spec = p_spec / (p_spec + p_diff)
        p_diff = 1.0 - p_spec
        ok = active_mask(active, it.p.shape[:-1], it.p.device) & (cos_theta_i > 0)
        pick = sampling.uniform(generator, p_spec.shape, it.p.device, batch_axis=0)
        sample_spec = ok & (pick < p_spec)
        diff_wo = square_to_cos_hemisphere(
            sampling.uniform(generator, it.p.shape[:-1] + (2,), it.p.device, batch_axis=0))
        wo = torch.where(sample_spec[..., None], reflect(it.frame[..., 2], it.wi), diff_wo)
        pdf = maximum(torch.where(sample_spec, p_spec,
                                  p_diff * square_to_cos_hemisphere_pdf(wo)), 1e-10)
        f_o = fresnel(wo[..., 2], self.eta)[0]
        spectrum = torch.where(
            sample_spec[..., None],
            self.specular * (f_i / pdf)[..., None],
            self.diffuse / (1.0 - self.fdr_int) * pdf[..., None] * self.inv_eta_2
            * (1.0 - f_i[..., None]) * (1.0 - f_o[..., None]))
        return BSDFSample(wo=wo, pdf=pdf), spectrum


class Bidirectional(nn.Module):
    """Two-sided wrapper: ``front`` where ``wi`` is above the local horizon,
    ``back`` (in the frame flipped by ``invert_z``) where it is below.

    With no ``back`` the JAX package hands both sides the front's initial
    values as two leaves, each with its own gradient, so they part after
    the first optimizer step: ``back`` is then a copy of ``front`` with
    parameters of its own, reset to the front's values.
    """

    def __init__(self, front: nn.Module, back: Optional[nn.Module] = None):
        super().__init__()
        self.shared = back is None
        self.front = front
        self.back = copy.deepcopy(front) if self.shared else back

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None):
        self.front.reset_parameters(generator)
        if self.shared:
            self.back.load_state_dict(self.front.state_dict())
        else:
            self.back.reset_parameters(generator)

    def _sides(self, it, active):
        cos_theta_i = it.wi[..., 2]
        act = active_mask(active, it.p.shape[:-1], it.p.device)
        return (cos_theta_i > 0) & act, (cos_theta_i < 0) & act

    def eval_and_pdf(self, it, wo: torch.Tensor, active=True):
        front, back = self._sides(it, active)
        f_spec, f_pdf, f_aux = self.front.eval_and_pdf(it, wo, front)
        it_b = it._replace(wi=invert_z(it.wi))
        b_spec, b_pdf, _ = self.back.eval_and_pdf(it_b, invert_z(wo), back)
        spectrum = torch.where(front[..., None], f_spec,
                               torch.where(back[..., None], b_spec, 0.0))
        pdf = torch.where(front, f_pdf, torch.where(back, b_pdf, 0.0))
        return spectrum, pdf, f_aux

    def sample(self, it, generator, active=True):
        front, back = self._sides(it, active)
        f_bs, f_spec = self.front.sample(it, generator, front)
        b_bs, b_spec = self.back.sample(it._replace(wi=invert_z(it.wi)), generator, back)
        wo = torch.where(front[..., None], f_bs.wo,
                         torch.where(back[..., None], invert_z(b_bs.wo), 0.0))
        pdf = torch.where(front, f_bs.pdf, torch.where(back, b_bs.pdf, 0.0))
        spectrum = torch.where(front[..., None], f_spec,
                               torch.where(back[..., None], b_spec, 0.0))
        return BSDFSample(wo=wo, pdf=pdf), spectrum


class Compose(nn.Module):
    """Global (not spatially varying) softmax mixture of BSDFs: learnable
    logits ``weights`` ``[K]``, drawn as ``U[0.5, 1.5)`` at init."""

    def __init__(self, bsdfs: Sequence[nn.Module]):
        super().__init__()
        self.bsdfs = nn.ModuleList(bsdfs)
        self.weights = nn.Parameter(torch.full((len(self.bsdfs),), 1.0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        for b in self.bsdfs:
            b.reset_parameters(generator)
        u = torch.rand(self.weights.shape, generator=generator, device=generator.device)
        self.weights.copy_(u + 0.5)

    def normalized_weights(self) -> torch.Tensor:
        return torch.softmax(self.weights, dim=-1)

    def eval_and_pdf(self, it, wo: torch.Tensor, active=True):
        k = self.normalized_weights()
        spec_pdfs = [b.eval_and_pdf(it, wo, active) for b in self.bsdfs]
        spectrum = sum(k[i] * s for i, (s, _, _) in enumerate(spec_pdfs))
        pdf = sum(k[i] * p for i, (_, p, _) in enumerate(spec_pdfs))
        return spectrum, pdf, {}

    def sample(self, it, generator, active=True):
        """A basis picked ~ the softmax weights; the joint pdf is the pick's
        probability times the basis pdf."""
        samples = [b.sample(it, generator, active) for b in self.bsdfs]
        k = self.normalized_weights().expand(it.p.shape[:-1] + (len(self.bsdfs),))
        onehot = one_hot(gumbel_argmax(generator, k), len(self.bsdfs))
        wo, pdf, spectrum = combine_samples(samples, onehot)
        return BSDFSample(wo=wo, pdf=pdf * torch.sum(k * onehot, dim=-1)), spectrum


class SelectBSDF(nn.Module):
    """Hard spatial pick: ``selector(p) -> basis index`` (an integer tensor)."""

    def __init__(self, selector: Callable, bsdfs: Sequence[nn.Module]):
        super().__init__()
        self.selector = selector
        self.bsdfs = nn.ModuleList(bsdfs)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        for b in self.bsdfs:
            b.reset_parameters(generator)

    def eval_and_pdf(self, it, wo: torch.Tensor, active=True):
        onehot = one_hot(self.selector(it.p), len(self.bsdfs))
        spec_pdf = torch.stack([
            torch.cat([s, p[..., None]], dim=-1)
            for s, p, _ in (b.eval_and_pdf(it, wo, active) for b in self.bsdfs)
        ], dim=-1)
        summed = torch.sum(spec_pdf * onehot[..., None, :], dim=-1)
        return summed[..., :3], summed[..., 3], {}

    def sample(self, it, generator, active=True):
        """The selected basis's sample (the pick is deterministic: no
        selection factor in the pdf)."""
        onehot = one_hot(self.selector(it.p), len(self.bsdfs))
        samples = [b.sample(it, generator, active) for b in self.bsdfs]
        wo, pdf, spectrum = combine_samples(samples, onehot)
        return BSDFSample(wo=wo, pdf=pdf), spectrum


class GlobalNeuralBSDF(nn.Module):
    """One global net pair: ``attenuation(param_rusin(n, wi, wo)) * (1 +
    color(p)) / 2``, two plain 3 x 64 relu SkipConnMLPs; the pdf is the
    ``DensityEstimator`` ``dist`` at ``dir_to_uv(wo)``, and ``sample`` draws
    from it (``wo = uv_to_dir(tanh(val))``), where the attenuation is
    remapped to ``(1 + att) / 2``, as in the JAX package."""

    def __init__(self):
        super().__init__()
        self.attenuation = SkipConnMLP(in_size=3, out=1, num_layers=3, hidden_size=64,
                                       activation="relu")
        self.color = SkipConnMLP(in_size=3, out=3, num_layers=3, hidden_size=64,
                                 activation="relu")
        self.dist = DensityEstimator()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.attenuation.reset_parameters(generator)
        self.color.reset_parameters(generator)
        self.dist.reset_parameters(generator)

    def eval_and_pdf(self, it, wo: torch.Tensor, active=True):
        att = self.attenuation(param_rusin(it.n, it.wi, wo))
        spectrum = att * (1.0 + self.color(it.p)) / 2.0
        pdf = self.dist.pdf(dir_to_uv(wo))[..., 0]
        return spectrum, pdf, {}

    def sample(self, it, generator, active=True):
        val, pdf = self.dist.sample(generator, it.p.shape[:-1])
        wo = normalize(uv_to_dir(torch.tanh(val)), eps=1e-7)
        att = (1.0 + self.attenuation(param_rusin(it.n, it.wi, wo))) / 2.0
        spectrum = att * (1.0 + self.color(it.p)) / 2.0
        return BSDFSample(wo=wo, pdf=pdf), spectrum
