"""CKD cost functions for LUT optimization.

Equivalents of ``calc_cost_function_ckd_lw``
(calc_cost_function_lw.cpp:115-232) and ``calc_cost_function_ckd_sw``
(calc_cost_function_sw.cpp:115-277).  Pure functions of the optical depth:
differentiate with ``jax.grad`` (replacing the Adept tape), vmap over
profiles, shard profiles across the mesh with psum-reduced sums.

Band mapping (g -> band sums) is passed as a one-hot (ng, nband) matrix so
the reduction is a matmul; pass identity for no mapping.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..constants import HR_WEIGHT
from .heating_rate import heating_rate
from .rt_lw import rt_lw
from .rt_sw import rt_direct_sw, rt_norayleigh_sw


class CostWeights(NamedTuple):
    """Static scalar weights of the CKD cost function."""
    flux_weight: float = 0.02
    flux_profile_weight: float = 0.0
    broadband_weight: float = 0.5
    spectral_boundary_weight: float = 0.0


def _band_sum(x, band_onehot):
    """(..., ng) -> (..., nband) via one-hot matmul (full precision: a
    TF32 dot would round the fluxes to ~2^-11)."""
    return jnp.matmul(x, band_onehot, precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=x.dtype)


def _common_cost(pressure_hl, flux_dn_fwd_orig, flux_up_fwd_orig,
                 flux_dn_true, flux_up_true, hr_true,
                 layer_weight, band_onehot, w: CostWeights,
                 hr_uses_up: bool,
                 sw_toa_up_factor: float = 1.0,
                 include_bb_up: bool = True,
                 bb_unconditional: bool = True,
                 relative_flux_dn=None, relative_flux_up=None):
    """Shared spectral+broadband cost assembly for LW and SW.

    flux_*_fwd_orig are per-g-point (nlev+1, ng); truths are per band.
    """
    if relative_flux_dn is not None:
        flux_dn_fwd_orig = flux_dn_fwd_orig - relative_flux_dn
        flux_up_fwd_orig = flux_up_fwd_orig - relative_flux_up

    flux_dn_fwd = _band_sum(flux_dn_fwd_orig, band_onehot)
    flux_up_fwd = _band_sum(flux_up_fwd_orig, band_onehot)
    nband = flux_dn_fwd.shape[-1]

    if hr_uses_up:
        hr_fwd = heating_rate(pressure_hl, flux_dn_fwd, flux_up_fwd)
    else:
        hr_fwd = heating_rate(pressure_hl, flux_dn_fwd)

    hr_err = hr_fwd - hr_true
    dn_surf_err = flux_dn_fwd[-1] - flux_dn_true[-1]
    up_toa_err = flux_up_fwd[0] - flux_up_true[0]

    # Spectral (per band) contribution
    cost = (HR_WEIGHT * HR_WEIGHT
            * jnp.sum(layer_weight[:, None] * hr_err * hr_err)
            + w.flux_weight * (jnp.sum(dn_surf_err * dn_surf_err)
                               + sw_toa_up_factor
                               * jnp.sum(up_toa_err * up_toa_err)))

    interface_weight = (w.flux_profile_weight
                        * 0.5 * (layer_weight[:-1] + layer_weight[1:]))
    if w.flux_profile_weight > 0.0:
        dn_err = flux_dn_fwd[1:-1] - flux_dn_true[1:-1]
        up_err = flux_up_fwd[1:-1] - flux_up_true[1:-1]
        cost = cost + jnp.sum(interface_weight[:, None]
                              * (dn_err * dn_err + up_err * up_err))

    # Broadband contribution.  The LW reference applies this block even when
    # broadband_weight is zero (calc_cost_function_lw.cpp:207-216), while the
    # SW reference guards it (calc_cost_function_sw.cpp:246).
    if bb_unconditional or w.broadband_weight > 0.0:
        bb_hr_err = jnp.sum(hr_err, axis=-1)
        bb_dn_err = jnp.sum(dn_surf_err)
        bb_up_err = jnp.sum(up_toa_err)
        cost = (cost * (1.0 - w.broadband_weight)) / nband
        cost = cost + (w.broadband_weight * HR_WEIGHT * HR_WEIGHT
                       * jnp.sum(layer_weight * bb_hr_err * bb_hr_err))
        cost = cost + w.broadband_weight * w.flux_weight * bb_dn_err * bb_dn_err
        if include_bb_up:
            cost = (cost + w.broadband_weight * w.flux_weight
                    * bb_up_err * bb_up_err)
        if w.flux_profile_weight > 0.0:
            bb_dn_prof = jnp.sum(flux_dn_fwd[1:-1] - flux_dn_true[1:-1],
                                 axis=-1)
            cost = cost + w.broadband_weight * jnp.sum(
                interface_weight * bb_dn_prof * bb_dn_prof)
            if include_bb_up:
                bb_up_prof = jnp.sum(flux_up_fwd[1:-1] - flux_up_true[1:-1],
                                     axis=-1)
                cost = cost + w.broadband_weight * jnp.sum(
                    interface_weight * bb_up_prof * bb_up_prof)
    return cost, flux_dn_fwd_orig, flux_up_fwd_orig


def cost_ckd_lw(pressure_hl, planck_hl, surf_emissivity_g, surf_planck,
                optical_depth, flux_dn_true, flux_up_true, hr_true,
                layer_weight, band_onehot, weights: CostWeights,
                spectral_flux_dn_surf=None, spectral_flux_up_toa=None,
                relative_flux_dn=None, relative_flux_up=None):
    """Longwave CKD cost for one profile (ref calc_cost_function_ckd_lw).

    Args:
      pressure_hl: (nlev+1,); planck_hl: (nlev+1, ng); surf_emissivity_g:
        (ng,) surface emissivity already mapped to g-points; surf_planck:
        (ng,); optical_depth: (nlay, ng); truths per band (nlev+1, nband) /
        (nlay, nband); layer_weight: (nlay,) normalized; band_onehot:
        (ng, nband); spectral boundary truths per g-point (ng,).

    Returns scalar cost.
    """
    flux_dn, flux_up = rt_lw(planck_hl, optical_depth,
                             surf_emissivity_g, surf_planck)
    cost, fdn_orig, fup_orig = _common_cost(
        pressure_hl, flux_dn, flux_up, flux_dn_true, flux_up_true, hr_true,
        layer_weight, band_onehot, weights, hr_uses_up=True,
        relative_flux_dn=relative_flux_dn, relative_flux_up=relative_flux_up)
    if (weights.spectral_boundary_weight > 0.0
            and spectral_flux_dn_surf is not None):
        dn_err = fdn_orig[-1] - spectral_flux_dn_surf
        up_err = fup_orig[0] - spectral_flux_up_toa
        cost = cost + weights.spectral_boundary_weight * jnp.sum(
            dn_err * dn_err + up_err * up_err)
    return cost


def cost_ckd_sw(cos_sza, pressure_hl, ssi_g, albedo_g,
                optical_depth, flux_dn_true, flux_up_true, hr_true,
                layer_weight, band_onehot, weights: CostWeights,
                with_upwelling: bool,
                spectral_boundary_weights=None, spectral_flux_dn_surf=None,
                relative_flux_dn=None, relative_flux_up=None):
    """Shortwave CKD cost for one profile (ref calc_cost_function_ckd_sw).

    Reproduces the reference's 20x weighting of the per-band TOA upwelling
    error (calc_cost_function_sw.cpp:214) and the exclusion of broadband
    upwelling when albedo <= 0 (``with_upwelling=False``).  Heating rate uses
    downwelling only (ref :202).
    """
    if with_upwelling:
        flux_dn, flux_up = rt_norayleigh_sw(cos_sza, ssi_g, optical_depth,
                                            albedo_g)
    else:
        flux_dn = rt_direct_sw(cos_sza, ssi_g, optical_depth)
        flux_up = jnp.zeros_like(flux_dn)

    cost, fdn_orig, _ = _common_cost(
        pressure_hl, flux_dn, flux_up, flux_dn_true, flux_up_true, hr_true,
        layer_weight, band_onehot, weights, hr_uses_up=False,
        sw_toa_up_factor=20.0, include_bb_up=with_upwelling,
        bb_unconditional=False,
        relative_flux_dn=relative_flux_dn, relative_flux_up=relative_flux_up)
    if (spectral_boundary_weights is not None
            and spectral_flux_dn_surf is not None):
        dn_err = fdn_orig[-1] - spectral_flux_dn_surf
        cost = cost + jnp.sum(spectral_boundary_weights * dn_err * dn_err)
    return cost
