"""Planck function (integrated spectral irradiance per wavenumber interval).

Equivalent of src/ecckd/planck_function.cpp:21-54: the OpenMP loop
over temperatures becomes a broadcast outer product; jit/vmap-compatible.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..constants import PLANCK_H, SPEED_OF_LIGHT, BOLTZMANN_K, PI


def planck_function(temperature, wavenumber_cm_1, d_wavenumber_cm_1):
    """Planck irradiance integrated over each wavenumber interval, W m-2.

    Args:
      temperature: (..., nt) temperatures in K.
      wavenumber_cm_1: (nwav,) wavenumber in cm-1.
      d_wavenumber_cm_1: (nwav,) wavenumber interval width in cm-1.

    Returns:
      (..., nt, nwav) Planck function in W m-2.
    """
    h, c, k = PLANCK_H, SPEED_OF_LIGHT, BOLTZMANN_K
    inv_cm_2_hz = 100.0 * c
    freq = wavenumber_cm_1 * inv_cm_2_hz
    # The physical constants are folded in double precision and applied to
    # wavenumber^3 in cm^-3: freq^3 (~1e41 Hz^3) and 2h/c^2 (~1e-50)
    # are both outside float32's range.
    const = 2.0 * h * inv_cm_2_hz * PI / (c * c) * inv_cm_2_hz ** 3
    nu = jnp.asarray(wavenumber_cm_1)
    prefactor = d_wavenumber_cm_1 * const * (nu * nu * nu)
    t = jnp.asarray(temperature)[..., None]        # (..., nt, 1)
    return prefactor / jnp.expm1((h / k) * (freq / t))
