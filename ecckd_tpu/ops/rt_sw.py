"""Shortwave radiative transfer: direct beam + no-Rayleigh two-stream.

Equivalent of src/ecckd/radiative_transfer_sw.cpp:24-184.
Downwelling is Beer-Lambert attenuation of the direct beam at sec(sza);
upwelling (no-Rayleigh variant) reflects off the surface with albedo and
propagates at the fixed two-stream secant 2.0 (Zdunkowski 1980, ref :70).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import SW_DIFFUSE_SECANT
from .segments import interval_sum, interval_sum_fused


def rt_direct_sw(cos_sza, ssi, od):
    """Spectral direct-beam downwelling flux (nlev+1, nwav).

    Args: cos_sza scalar; ssi (nwav,) solar irradiance; od (nlay, nwav).
    """
    minus_sec = -1.0 / cos_sza
    top = cos_sza * ssi

    def step(flux, od_lay):
        new = flux * jnp.exp(minus_sec * od_lay)
        return new, new

    _, dn = jax.lax.scan(step, top, od)
    return jnp.concatenate([top[None], dn], axis=0)


def rt_norayleigh_sw(cos_sza, ssi, od, albedo):
    """Spectral down+up fluxes with surface reflection, no Rayleigh.

    Args: albedo (nwav,) surface albedo (per g-point/band in CKD use).
    Returns: (flux_dn, flux_up), each (nlev+1, nwav).
    """
    flux_dn = rt_direct_sw(cos_sza, ssi, od)
    surf = flux_dn[-1] * albedo

    def step(flux, od_lay):
        new = flux * jnp.exp(-SW_DIFFUSE_SECANT * od_lay)
        return new, new

    _, up = jax.lax.scan(step, surf, od, reverse=True)
    return flux_dn, jnp.concatenate([up, surf[None]], axis=0)


def rt_direct_sw_bb(cos_sza, ssi, spectral_od, grey_od):
    """Broadband direct flux with grey od per layer (ref :119-146)."""
    minus_sec = -1.0 / cos_sza
    total_od = spectral_od + grey_od[:, None]
    top = cos_sza * ssi

    def step(flux, od_lay):
        new = flux * jnp.exp(minus_sec * od_lay)
        return new, jnp.sum(new)

    _, dn = jax.lax.scan(step, top, total_od)
    return jnp.concatenate([jnp.sum(top)[None], dn])


def rt_norayleigh_sw_bb(cos_sza, ssi, spectral_od, grey_od, albedo):
    """Broadband down+up fluxes with grey od and scalar albedo (ref :148-196)."""
    minus_sec = -1.0 / cos_sza
    total_od = spectral_od + grey_od[:, None]
    top = cos_sza * ssi

    def dn_step(flux, od_lay):
        new = flux * jnp.exp(minus_sec * od_lay)
        return new, jnp.sum(new)

    surf_spec, dn = jax.lax.scan(dn_step, top, total_od)
    flux_dn = jnp.concatenate([jnp.sum(top)[None], dn])

    up_surf = surf_spec * albedo

    def up_step(flux, od_lay):
        new = flux * jnp.exp(-SW_DIFFUSE_SECANT * od_lay)
        return new, jnp.sum(new)

    _, up = jax.lax.scan(up_step, up_surf, total_od, reverse=True)
    flux_up = jnp.concatenate([up, jnp.sum(up_surf)[None]])
    return flux_dn, flux_up


def rt_sw_bb_intervals(cos_sza, ssi, bg_od, grey_od_wav, albedo, i1, i2,
                       with_upwelling=True, materialize=None):
    """Per-interval broadband SW fluxes for batched candidate evaluation.

    Like :func:`rt_lw.rt_lw_bb_intervals`: each wavenumber carries its own
    fitted grey od, and prefix-sum interval reductions extract broadband flux
    profiles for every candidate interval in one pass.

    Returns (flux_dn, flux_up) each (nlev+1, nseg); flux_up is zeros when
    ``with_upwelling`` is False (albedo <= 0 in the reference,
    calc_cost_function_sw.cpp:59-88).
    """
    # One fused-reduction part per sweep (see rt_lw.rt_lw_bb_intervals):
    # per wavenumber tile the per-level direct fluxes follow from a
    # cumulative sum of od over the (tiny) layer axis, the upward product
    # chain runs from 1 and is scaled by the surface boundary afterwards,
    # and all (2*(nlev+1), tile) rows reduce against one membership matmul.
    # No nwav-sized temporaries, no per-layer reduction passes.
    # `materialize` is accepted for backward compatibility and ignored.
    del materialize
    minus_sec = -1.0 / cos_sza
    nlay = bg_od.shape[0]
    n = bg_od.shape[-1]
    ssi = jnp.asarray(ssi)
    dtype = ssi.dtype
    # Albedo may be a scalar (single band, ref behaviour) or a per-
    # wavenumber vector (gas-level kernels spanning bands with different
    # no-Rayleigh albedos, find_g_points.cpp:415-417 per band).
    albedo = jnp.broadcast_to(jnp.asarray(albedo, dtype), (n,))

    def flux_part(start, size):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, size,
                                                    axis=a.ndim - 1)
        od = sl(bg_od) + sl(grey_od_wav)
        top = (cos_sza * sl(ssi))[None, :]
        dn = top * jnp.exp(minus_sec * jnp.cumsum(od, axis=0))
        dn_rows = jnp.concatenate([top, dn], axis=0)
        if not with_upwelling:
            return dn_rows
        # cumulative transmittance from the surface upward; level nlay = 1
        a = jnp.exp(-SW_DIFFUSE_SECANT
                    * jnp.cumsum(od[::-1], axis=0))[::-1]
        up = (sl(albedo) * dn[-1])[None, :] * jnp.concatenate(
            [a, jnp.ones_like(top)], axis=0)
        return jnp.concatenate([dn_rows, up], axis=0)

    sums = interval_sum_fused([flux_part], n, i1, i2, dtype=dtype)
    flux_dn = sums[:nlay + 1]
    if not with_upwelling:
        return flux_dn, jnp.zeros_like(flux_dn)
    return flux_dn, sums[nlay + 1:]
