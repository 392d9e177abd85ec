"""Fresnel terms for dielectrics and conductors.

Counterpart of ``neural_raytracing_tpu/ops/fresnel.py``.  Its clamps keep
JAX's gradients at a tie: ``jnp.maximum`` is ``ops.math.maximum`` and
``jnp.abs`` is ``ops.math.absolute``.
"""

from __future__ import annotations

import torch

from .math import absolute, maximum


def fresnel(cos_t: torch.Tensor, eta: float):
    """Dielectric Fresnel.

    Returns ``(r, cos_tt, eta_it, eta_ti)``: reflectance, transmitted cosine,
    and the relative IORs for each side.
    """
    out_mask = cos_t >= 0
    inv_eta = 1.0 / eta
    eta_it = torch.where(out_mask, eta, inv_eta)
    eta_ti = torch.where(out_mask, inv_eta, eta)
    # cos^2 of the transmitted angle by Snell's law
    cos_tt_sqr = 1.0 - (1.0 - cos_t * cos_t) * (eta_ti * eta_ti)
    cos_t_abs = absolute(cos_t)
    cos_tt_abs = torch.sqrt(maximum(cos_tt_sqr, 1e-10))

    idx_match = eta == 1.0
    special_case = (cos_t_abs == 0.0) | idx_match

    a_s = (-eta_it * cos_tt_abs + cos_t_abs) / (eta_it * cos_tt_abs + cos_t_abs)
    a_p = (-eta_it * cos_t_abs + cos_tt_abs) / (eta_it * cos_t_abs + cos_tt_abs)

    r = 0.5 * (torch.square(a_s) + torch.square(a_p))
    r = torch.where(special_case, 0.0 if idx_match else 1.0, r)

    cos_tt = cos_tt_abs * -torch.sign(cos_t)
    return r, cos_tt, eta_it, eta_ti


def fresnel_diff_refl(eta: float) -> float:
    """Polynomial fit of the diffuse Fresnel reflectance."""
    if eta < 1:
        return (-1.4399 * (eta * eta) + 0.7099 * eta + 0.6681 + 0.0636 / eta)
    inv_eta = 1.0 / eta
    inv_eta_2 = inv_eta * inv_eta
    inv_eta_3 = inv_eta_2 * inv_eta
    inv_eta_4 = inv_eta_3 * inv_eta
    inv_eta_5 = inv_eta_4 * inv_eta
    return (0.919317 - 3.4793 * inv_eta + 6.75335 * inv_eta_2
            - 7.80989 * inv_eta_3 + 4.98554 * inv_eta_4 - 1.36881 * inv_eta_5)


def fresnel_conductor(cos_t: torch.Tensor, eta_r, eta_i) -> torch.Tensor:
    """Unpolarized conductor Fresnel reflectance."""
    ct2 = cos_t * cos_t
    st2 = maximum(1.0 - ct2, 1e-10)
    st4 = st2 * st2
    tmp = eta_r * eta_r - eta_i * eta_i - st2
    a_2_pb_2 = torch.sqrt(maximum(tmp * tmp + 4 * eta_i * eta_i * eta_r * eta_r, 1e-10))
    a = torch.sqrt(maximum(0.5 * (a_2_pb_2 + tmp), 1e-10))
    t1 = a_2_pb_2 + ct2
    t2 = 2.0 * cos_t * a
    r_s = (t1 - t2) / (t1 + t2)
    t3 = a_2_pb_2 * ct2 + st4
    t4 = t2 * st2
    r_p = r_s * (t3 - t4) / (t3 + t4)
    return 0.5 * (r_s + r_p)
