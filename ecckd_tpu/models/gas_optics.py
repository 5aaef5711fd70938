"""Pure-JAX gas optics: LUT interpolation to optical depth.

Equivalent of ``CkdModel::calc_optical_depth``
(ckd_model.cpp:923-1102).  The reference's per-(column, level) scalar loops
become vectorized gathers from the (tiny, replicated) look-up tables; the
functions are pure in the LUT arrays so ``jax.grad`` differentiates through
them (replacing the Adept-active template instantiation).

Conventions (matching the reference):
* pressure LUT is evenly spaced in log(p);
* temperature LUT axis is an offset from a pressure-dependent reference
  profile ``temperature_[0, ip]``, with uniform spacing d_t;
* concentration LUT (conc_dependence == LUT) is evenly spaced in log(vmr).
"""

from __future__ import annotations

import enum
from typing import Optional

import jax.numpy as jnp

from ..constants import MOLES_PER_PA


class ConcDependence(enum.IntEnum):
    """Concentration-dependence codes (ref ckd_model.h:30-35 and the
    _conc_dependence_code values written at ckd_model.cpp:566-630)."""
    NONE = 0
    LINEAR = 1
    LUT = 2
    RELATIVE_LINEAR = 3


def _pt_indices(pressure_hl, temperature_fl, log_pressure, temperature_lut):
    """Fractional (pressure, temperature) interpolation indices and weights.

    Args:
      pressure_hl: (ncol, nlev+1); temperature_fl: (ncol, nlay);
      log_pressure: (np,) LUT log-pressure grid (evenly spaced);
      temperature_lut: (nt, np) LUT temperature grid.

    Returns:
      ip0, pw1, it0, tw1: int/float arrays of shape (ncol, nlay).
    """
    np_ = log_pressure.shape[0]
    nt = temperature_lut.shape[0]
    log_p0 = log_pressure[0]
    d_log_p = log_pressure[1] - log_pressure[0]
    d_t = temperature_lut[1, 0] - temperature_lut[0, 0]

    log_p_fl = jnp.log(0.5 * (pressure_hl[:, 1:] + pressure_hl[:, :-1]))
    pindex = jnp.clip((log_p_fl - log_p0) / d_log_p, 0.0, np_ - 1.0001)
    ip0 = pindex.astype(jnp.int32)
    pw1 = pindex - ip0

    t_0 = ((1.0 - pw1) * temperature_lut[0, ip0]
           + pw1 * temperature_lut[0, ip0 + 1])
    tindex = jnp.clip((temperature_fl - t_0) / d_t, 0.0, nt - 1.0001)
    it0 = tindex.astype(jnp.int32)
    tw1 = tindex - it0
    return ip0, pw1, it0, tw1


def _interp_2d(table, ip0, pw1, it0, tw1, logarithmic):
    """Bi-linear (or log-linear) interpolation of a (nt, np, ng) table at
    fractional (temperature, pressure) indices -> (ncol, nlay, ng)."""
    if logarithmic:
        table = jnp.log(table)
    pw1e = pw1[..., None]
    tw1e = tw1[..., None]
    v = ((1.0 - tw1e) * ((1.0 - pw1e) * table[it0, ip0]
                         + pw1e * table[it0, ip0 + 1])
         + tw1e * ((1.0 - pw1e) * table[it0 + 1, ip0]
                   + pw1e * table[it0 + 1, ip0 + 1]))
    if logarithmic:
        v = jnp.exp(v)
    return v


def calc_optical_depth(conc_dependence: ConcDependence,
                       molar_abs,
                       pressure_hl,
                       temperature_fl,
                       log_pressure,
                       temperature_lut,
                       vmr_fl=None,
                       lut_vmr=None,
                       reference_vmr: Optional[float] = None,
                       logarithmic_interpolation: bool = False):
    """Optical depth per g-point for multiple columns.

    Args:
      conc_dependence: how absorption depends on concentration.
      molar_abs: (nt, np, ng) table, or (nconc, nt, np, ng) for LUT mode.
      pressure_hl: (ncol, nlev+1) Pa.
      temperature_fl: (ncol, nlay) K.
      log_pressure: (np,) LUT grid; temperature_lut: (nt, np) LUT grid.
      vmr_fl: (ncol, nlay) volume mixing ratio (required unless NONE).
      lut_vmr: (nconc,) LUT concentration coordinate (LUT mode).
      reference_vmr: subtracted from vmr in RELATIVE_LINEAR mode.
      logarithmic_interpolation: interpolate log(k) instead of k.

    Returns:
      (ncol, nlay, ng) optical depth.
    """
    molar_abs = jnp.asarray(molar_abs)
    pressure_hl = jnp.asarray(pressure_hl)
    temperature_fl = jnp.asarray(temperature_fl)
    ip0, pw1, it0, tw1 = _pt_indices(pressure_hl, temperature_fl,
                                     jnp.asarray(log_pressure),
                                     jnp.asarray(temperature_lut))

    simple_weight = MOLES_PER_PA * (pressure_hl[:, 1:] - pressure_hl[:, :-1])

    if conc_dependence == ConcDependence.NONE:
        weight = simple_weight
        k = _interp_2d(molar_abs, ip0, pw1, it0, tw1,
                       logarithmic_interpolation)
        return weight[..., None] * k

    if vmr_fl is None:
        raise ValueError("Concentration required for this gas")
    vmr_fl = jnp.asarray(vmr_fl)

    if conc_dependence in (ConcDependence.LINEAR,
                           ConcDependence.RELATIVE_LINEAR):
        if conc_dependence == ConcDependence.RELATIVE_LINEAR:
            weight = simple_weight * (vmr_fl - reference_vmr)
        else:
            weight = simple_weight * vmr_fl
        k = _interp_2d(molar_abs, ip0, pw1, it0, tw1,
                       logarithmic_interpolation)
        return weight[..., None] * k

    # LUT concentration dependence: tri-linear in (log conc, T, p)
    lut_vmr = jnp.asarray(lut_vmr)
    nconc = lut_vmr.shape[0]
    weight = simple_weight * vmr_fl
    d_log_c = jnp.log(lut_vmr[1] / lut_vmr[0])
    cindex = jnp.clip((jnp.log(vmr_fl) - jnp.log(lut_vmr[0])) / d_log_c,
                      0.0, nconc - 1.0001)
    ic0 = cindex.astype(jnp.int32)
    cw1 = (cindex - ic0)[..., None]

    if logarithmic_interpolation:
        table = jnp.log(molar_abs)
    else:
        table = molar_abs

    def conc_slice(ic):
        # Gather (ncol, nlay, ng) from table[ic] at fractional (t, p)
        pw1e = pw1[..., None]
        tw1e = tw1[..., None]
        return ((1.0 - tw1e) * ((1.0 - pw1e) * table[ic, it0, ip0]
                                + pw1e * table[ic, it0, ip0 + 1])
                + tw1e * ((1.0 - pw1e) * table[ic, it0 + 1, ip0]
                          + pw1e * table[ic, it0 + 1, ip0 + 1]))

    v = (1.0 - cw1) * conc_slice(ic0) + cw1 * conc_slice(ic0 + 1)
    if logarithmic_interpolation:
        v = jnp.exp(v)
    return weight[..., None] * v


def planck_from_lut(temperature, temperature_planck, planck_lut):
    """Interpolate the Planck-function LUT in temperature.

    Ref CkdModel::calc_planck_function (ckd_model.cpp:1119-1145): linear
    interpolation/extrapolation above the table start; linear to zero below.

    Args:
      temperature: (...,) K; temperature_planck: (ntp,) LUT coordinate;
      planck_lut: (ntp, ng).

    Returns: (..., ng).
    """
    temperature = jnp.asarray(temperature)
    tp = jnp.asarray(temperature_planck)
    lut = jnp.asarray(planck_lut)
    ntp = tp.shape[0]
    d_t = tp[1] - tp[0]
    t0 = tp[0]
    tindex = (temperature - t0) / d_t
    it0 = jnp.clip(tindex.astype(jnp.int32), 0, ntp - 2)
    tw1 = (tindex - it0)[..., None]
    normal = (1.0 - tw1) * lut[it0] + tw1 * lut[it0 + 1]
    below = (temperature / t0)[..., None] * lut[0]
    return jnp.where((tindex >= 0)[..., None], normal, below)


def rayleigh_optical_depth(pressure_hl, rayleigh_molar_scat):
    """Rayleigh od per g-point (ref CkdModel::calc_rayleigh_optical_depth,
    ckd_model.h:242-252): moles of air per layer times molar coefficient."""
    moles = MOLES_PER_PA * (pressure_hl[:, 1:] - pressure_hl[:, :-1])
    return moles[..., None] * jnp.asarray(rayleigh_molar_scat)


def temperature_fl_from_hl(pressure_hl, temperature_hl):
    """Full-level temperature as the pressure-weighted half-level mean
    (ref solve_adept.cpp:37-40, run_ckd.cpp:118-121)."""
    p_x_t = temperature_hl * pressure_hl
    return ((p_x_t[:, :-1] + p_x_t[:, 1:])
            / (pressure_hl[:, :-1] + pressure_hl[:, 1:]))
