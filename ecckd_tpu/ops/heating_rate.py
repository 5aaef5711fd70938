"""Heating-rate from flux profiles: hr = -(g/cp) d(net flux)/dp.

Equivalent of src/ecckd/heating_rate.h:25-72.  Operates on any
trailing spectral axes; ``flux_up=None`` reproduces the SW direct-only case.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from ..constants import ACCEL_GRAVITY, SPECIFIC_HEAT_AIR


def heating_rate(pressure_hl, flux_dn, flux_up=None):
    """Heating rate (K s-1) per layer from half-level fluxes.

    Args:
      pressure_hl: (..., nlev+1) half-level pressure, Pa.
      flux_dn: (..., nlev+1, *spectral) downwelling flux, W m-2, where the
        level axis is axis ``-1 - nspec`` with ``nspec = flux_dn.ndim -
        pressure_hl.ndim`` trailing spectral axes.
      flux_up: optional upwelling flux, same shape as flux_dn.

    Returns:
      (..., nlev, *spectral) heating rate.
    """
    p = jnp.asarray(pressure_hl)
    fd = jnp.asarray(flux_dn)
    nspec = fd.ndim - p.ndim
    conv = -(ACCEL_GRAVITY / SPECIFIC_HEAT_AIR) / (p[..., 1:] - p[..., :-1])
    conv = conv.reshape(conv.shape + (1,) * nspec)
    lev_axis = fd.ndim - 1 - nspec
    lo = [slice(None)] * fd.ndim
    hi = [slice(None)] * fd.ndim
    lo[lev_axis] = slice(None, -1)
    hi[lev_axis] = slice(1, None)
    net_diff = fd[tuple(hi)] - fd[tuple(lo)]
    if flux_up is not None:
        fu = jnp.asarray(flux_up)
        net_diff = net_diff - fu[tuple(hi)] + fu[tuple(lo)]
    return conv * net_diff
