"""Longwave no-scattering two-stream radiative transfer.

Equivalent of src/ecckd/radiative_transfer_lw.cpp:25-142.  The
layer recurrence is a short ``lax.scan`` (nlay ~ 50) vectorized over the
trailing spectral axis; everything is jit/grad/vmap-compatible (the
reference's Adept ``IsActive`` template duality disappears: differentiate
with ``jax.grad`` through these functions).

Three variants:

* :func:`rt_lw` — full spectral fluxes (nlev+1, nwav).
* :func:`rt_lw_bb` — broadband fluxes only, summing over wavenumber inside
  the scan to bound memory (ref ``radiative_transfer_lw_bb``,
  radiative_transfer_lw.cpp:83-142, including its clamped ``factor``).
* :func:`rt_lw_bb_intervals` — the batched-candidate generalization: a
  per-wavenumber grey optical depth (gathered from per-interval fits) and
  prefix-sum interval reductions give the broadband flux profile of *every*
  candidate interval in one pass (replaces the OpenMP loop P1 at
  equipartition.h:100-104).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..constants import LW_DIFFUSIVITY
from .segments import interval_sum, interval_sum_fused

# Below this emissivity the linear-in-planck "factor" is replaced by its
# small-od limit (ref radiative_transfer_lw.cpp:42, :104)
THRESHOLD_EMISSIVITY = 1.0e-5


def _emissivity_factor(od):
    """Emissivity and linear-in-Planck source factor (spectral form).

    factor = 1 - (1/D)*emissivity/od, with the small-od limit 0.5*emissivity
    below THRESHOLD_EMISSIVITY (ref radiative_transfer_lw.cpp:41-43).
    """
    emissivity = -jnp.expm1(-LW_DIFFUSIVITY * od)
    safe_od = jnp.where(od > 0.0, od, 1.0)
    factor = jnp.where(
        emissivity > THRESHOLD_EMISSIVITY,
        1.0 - emissivity * (1.0 / LW_DIFFUSIVITY) / safe_od,
        0.5 * emissivity)
    return emissivity, factor


def _emissivity_factor_bb(od):
    """Clamped emissivity/factor used by the broadband variant
    (ref radiative_transfer_lw.cpp:104-126)."""
    te = THRESHOLD_EMISSIVITY
    emissivity = -jnp.expm1(-LW_DIFFUSIVITY * od)
    factor = jnp.maximum(
        1.0 - (1.0 / LW_DIFFUSIVITY) * jnp.maximum(emissivity, te)
        / jnp.maximum(od, te / LW_DIFFUSIVITY),
        0.5 * te)
    return emissivity, factor


def rt_lw(planck_hl, od, surf_emissivity, surf_planck):
    """Spectral longwave fluxes.

    Args:
      planck_hl: (nlev+1, nwav) Planck function at half levels, W m-2.
      od: (nlay, nwav) layer optical depth.
      surf_emissivity: (nwav,) surface emissivity.
      surf_planck: (nwav,) surface Planck function.

    Returns:
      (flux_dn, flux_up), each (nlev+1, nwav).
    """
    emissivity, factor = _emissivity_factor(od)
    trans = 1.0 - emissivity

    def down_step(flux, xs):
        t, p_top, p_base, f = xs
        new = flux * t + p_top * (1.0 - t - f) + p_base * f
        return new, new

    top = jnp.zeros_like(planck_hl[0])
    _, dn_levels = jax.lax.scan(
        down_step, top,
        (trans, planck_hl[:-1], planck_hl[1:], factor))
    flux_dn = jnp.concatenate([top[None], dn_levels], axis=0)

    surf = surf_planck * surf_emissivity + (1.0 - surf_emissivity) * flux_dn[-1]

    def up_step(flux, xs):
        t, p_top, p_base, f = xs
        new = flux * t + p_base * (1.0 - t - f) + p_top * f
        return new, new

    _, up_levels = jax.lax.scan(
        up_step, surf,
        (trans, planck_hl[:-1], planck_hl[1:], factor),
        reverse=True)
    flux_up = jnp.concatenate([up_levels, surf[None]], axis=0)
    return flux_dn, flux_up


def rt_lw_bb(planck_hl, spectral_od, grey_od, surf_emissivity, surf_planck):
    """Broadband longwave fluxes with a grey od added per layer.

    Ref radiative_transfer_lw_bb (radiative_transfer_lw.cpp:83-142): spectral
    layer od plus a per-layer grey (fitted) od; only the broadband sums are
    returned, with the spectral flux kept as the scan carry to bound memory.

    Args:
      planck_hl: (nlev+1, nwav); spectral_od: (nlay, nwav);
      grey_od: (nlay,); surf_emissivity, surf_planck: (nwav,).

    Returns:
      (flux_dn, flux_up), each (nlev+1,) broadband.
    """
    total_od = spectral_od + grey_od[:, None]
    emissivity, factor = _emissivity_factor_bb(total_od)
    trans = 1.0 - emissivity

    def down_step(flux, xs):
        t, p_top, p_base, f = xs
        new = flux * t + p_top * (1.0 - t - f) + p_base * f
        return new, jnp.sum(new)

    top = jnp.zeros_like(planck_hl[0])
    flux_surf_spec, dn_sums = jax.lax.scan(
        down_step, top, (trans, planck_hl[:-1], planck_hl[1:], factor))
    flux_dn = jnp.concatenate([jnp.zeros((1,), dn_sums.dtype), dn_sums])

    surf = (surf_planck * surf_emissivity
            + (1.0 - surf_emissivity) * flux_surf_spec)

    def up_step(flux, xs):
        t, p_top, p_base, f = xs
        new = flux * t + p_base * (1.0 - t - f) + p_top * f
        return new, jnp.sum(new)

    _, up_sums = jax.lax.scan(
        up_step, surf, (trans, planck_hl[:-1], planck_hl[1:], factor),
        reverse=True)
    flux_up = jnp.concatenate([up_sums, jnp.sum(surf)[None]])
    return flux_dn, flux_up


def rt_lw_bb_intervals(planck_hl, bg_od, grey_od_wav,
                       surf_emissivity, surf_planck, i1, i2,
                       materialize=None):
    """Per-interval broadband longwave fluxes for batched candidates.

    Each wavenumber carries its own grey (fitted) optical depth; the flux
    recurrence runs once over all wavenumbers and prefix-sum interval
    reductions extract the broadband flux profile of each candidate interval
    [i1[k], i2[k]] (inclusive).  This evaluates an entire equipartition sweep
    in one kernel.

    Args:
      planck_hl: (nlev+1, nwav); bg_od: (nlay, nwav) background od;
      grey_od_wav: (nlay, nwav) fitted od gathered per wavenumber;
      surf_emissivity, surf_planck: (nwav,);
      i1, i2: (nseg,) inclusive interval index bounds.

    Returns:
      (flux_dn, flux_up), each (nlev+1, nseg).
    """
    # The whole sweep is ONE fused-reduction part (ops.segments
    # interval_sum_fused): per wavenumber tile the full down+up recurrence
    # runs on in-register slices and the (2*(nlev+1), tile) flux rows are
    # reduced immediately against the shared membership matmul.  Nothing of
    # size nwav is ever materialized beyond the inputs (the former
    # "materialized" strategy wrote ~GBs of emissivity/factor/flux-row
    # temporaries per sweep at CKDMIP scale; the former in-scan strategy
    # paid a full HBM round trip of (nwav,) carries per layer).  Same
    # 3-independent-chain recurrence shape as the Pallas kernel
    # (ops/pallas/sweep_lw.py): hoisted source terms, upward sweep affine
    # in its surface boundary.  `materialize` is accepted for backward
    # compatibility and ignored.
    del materialize
    nlay = bg_od.shape[0]
    n = bg_od.shape[-1]
    dtype = jnp.asarray(planck_hl).dtype

    def flux_part(start, size):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, size,
                                                    axis=a.ndim - 1)
        p = sl(planck_hl)
        od = sl(bg_od) + sl(grey_od_wav)
        se = sl(surf_emissivity)
        sp = sl(surf_planck)
        emissivity, factor = _emissivity_factor_bb(od)
        trans = 1.0 - emissivity
        coeff_top = emissivity - factor          # == 1 - trans - factor
        src_dn = p[:-1] * coeff_top + p[1:] * factor
        src_up = p[1:] * coeff_top + p[:-1] * factor

        flux_dn = jnp.zeros((size,), dtype)
        b = jnp.zeros((size,), dtype)
        a = jnp.ones((size,), dtype)
        dn_rows = [flux_dn]
        b_rows = [None] * (nlay + 1)
        a_rows = [None] * (nlay + 1)
        b_rows[nlay] = b
        a_rows[nlay] = a
        for k in range(nlay):
            up_lay = nlay - 1 - k
            flux_dn = flux_dn * trans[k] + src_dn[k]
            b = b * trans[up_lay] + src_up[up_lay]
            a = a * trans[up_lay]
            dn_rows.append(flux_dn)
            b_rows[up_lay] = b
            a_rows[up_lay] = a

        boundary = sp * se + (1.0 - se) * flux_dn
        up = jnp.stack(b_rows) + boundary[None, :] * jnp.stack(a_rows)
        return jnp.concatenate([jnp.stack(dn_rows), up], axis=0)

    sums = interval_sum_fused([flux_part], n, i1, i2, dtype=dtype)
    return sums[:nlay + 1], sums[nlay + 1:]
