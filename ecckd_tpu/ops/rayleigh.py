"""Rayleigh molar scattering coefficient, Bucholtz (1995) model.

Equivalent of src/ecckd/rayleigh_scattering.h:23-43.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..constants import AVOGADRO_CONSTANT


def rayleigh_molar_scattering_coeff(wavenumber_cm_1):
    """Rayleigh molar scattering coefficient (m2 mol-1) vs wavenumber (cm-1)."""
    wavelength_um = 10000.0 / jnp.asarray(wavenumber_cm_1)
    short = 3.01577e-32 * wavelength_um ** -(
        3.55212 + 1.35579 * wavelength_um + 0.11563 / wavelength_um)
    long_ = 4.01061e-32 * wavelength_um ** -(
        3.99668 + 0.00110298 * wavelength_um + 0.0271393 / wavelength_um)
    scat = jnp.where(wavelength_um < 0.5, short, long_)
    return scat * AVOGADRO_CONSTANT
