"""Fused Pallas kernel (Triton route) for the SW candidate-sweep broadband RT.

SW counterpart of :mod:`.sweep_lw`, with the same chunked work split and
deterministic partial sums: direct-beam Beer-Lambert downwelling at
sec(sza), optional no-Rayleigh upwelling at the fixed two-stream secant 2.0
(Zdunkowski) run from the surface boundary as a second layer loop that
recomputes each layer's optical depth.  Albedo is a per-wavenumber operand
(scalar broadcast on entry): gas-level kernels span bands whose
no-Rayleigh albedo differs (ref find_g_points.cpp:415-417 uses one scalar
per band; per-wavenumber is the superset that evaluates identically within
a band).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ...constants import SW_DIFFUSE_SECANT
from .sweep_lw import (BLOCK, NUM_WARPS, _next_pow2, interval_chunks,
                       num_programs, reduce_chunks)


def _sweep_kernel(nlay: int, nwav: int, nseg: int, block: int, width: int,
                  cos_sza: float, with_up: bool,
                  lo_ref, hi_ref, seg_ref, od_fit_ref, ssi_ref, bg_ref,
                  albedo_ref, out_ref):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    nlev1 = nlay + 1
    p = pl.program_id(0)
    lo = plgpu.load(lo_ref.at[p])
    hi = plgpu.load(hi_ref.at[p])
    idx = lo + jnp.arange(block, dtype=jnp.int32)
    valid = idx < hi
    dtype = out_ref.dtype
    zero = jnp.zeros((block,), dtype)
    seg = plgpu.load(seg_ref.at[idx], mask=valid, other=0)
    col = jnp.arange(width, dtype=jnp.int32)

    def put(res, c, v):
        return jnp.where(col == c, jnp.sum(jnp.where(valid, v, zero)), res)

    def od_of(k):
        return (plgpu.load(bg_ref.at[k * nwav + idx], mask=valid, other=0.0)
                + plgpu.load(od_fit_ref.at[k * nseg + seg], mask=valid,
                             other=0.0))

    minus_sec = -1.0 / cos_sza
    flux = cos_sza * plgpu.load(ssi_ref.at[idx], mask=valid, other=0.0)
    res = put(jnp.zeros((width,), dtype), 0, flux)

    def down(k, carry):
        flux, res = carry
        flux = flux * jnp.exp(minus_sec * od_of(k))
        return flux, put(res, k + 1, flux)

    flux, res = jax.lax.fori_loop(0, nlay, down, (flux, res))
    if with_up:
        up = plgpu.load(albedo_ref.at[idx], mask=valid, other=0.0) * flux
        res = put(res, nlev1 + nlay, up)

        def upward(i, carry):
            up, res = carry
            lay = nlay - 1 - i
            up = up * jnp.exp(-SW_DIFFUSE_SECANT * od_of(lay))
            return up, put(res, nlev1 + lay, up)

        _, res = jax.lax.fori_loop(0, nlay, upward, (up, res))
    plgpu.store(out_ref.at[p * width + col], res)


def rt_sw_bb_intervals_pallas(ssi, bg_od, od_fit, seg_of_wav, i1, i2,
                              cos_sza: float, albedo,
                              with_upwelling: bool = True,
                              interpret: bool = False):
    """Per-interval broadband SW fluxes (see the jitted impl below).
    ``albedo`` is a scalar or (nwav,) vector; broadcast HERE (outside the
    jit) so scalar and vector calls share one compiled kernel."""
    albedo = jnp.broadcast_to(jnp.asarray(albedo, bg_od.dtype),
                              (bg_od.shape[-1],))
    return _rt_sw_bb_intervals_pallas(
        ssi, bg_od, od_fit, seg_of_wav, i1, i2, albedo, cos_sza=cos_sza,
        with_upwelling=with_upwelling, interpret=interpret)


@functools.partial(jax.jit, static_argnames=("cos_sza", "with_upwelling",
                                             "interpret"))
def _rt_sw_bb_intervals_pallas(ssi, bg_od, od_fit, seg_of_wav, i1, i2,
                               albedo, cos_sza: float,
                               with_upwelling: bool = True,
                               interpret: bool = False):
    """Per-interval broadband SW fluxes, fused Pallas kernel.

    Args: ssi: (nwav,); bg_od: (nlay, nwav); od_fit: (nlay, nseg);
    seg_of_wav: (nwav,); i1, i2: (nseg,) meeting
    :func:`.sweep_lw.chunks_fit`; albedo: (nwav,); cos_sza static.

    Returns (flux_dn, flux_up), each (nlev+1, nseg); flux_up zeros without
    upwelling.
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    nlay, nwav = bg_od.shape
    nlev1 = nlay + 1
    nseg = i1.shape[0]
    dtype = bg_od.dtype
    if nlay * nwav >= 2 ** 31:
        raise ValueError("sweep kernel indexes with int32: "
                         f"{nlay} x {nwav} operands are too large")
    width = _next_pow2(2 * nlev1)
    nprog = num_programs(nwav, nseg)
    lo, hi, pseg = interval_chunks(i1, i2, nwav, BLOCK, nprog)
    kernel = functools.partial(_sweep_kernel, nlay, nwav, nseg, BLOCK,
                               width, float(cos_sza), bool(with_upwelling))
    partial = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((nprog * width,), dtype),
        grid=(nprog,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="ecckd_sweep_sw",
    )(lo, hi, jnp.asarray(seg_of_wav, jnp.int32),
      jnp.asarray(od_fit, dtype).reshape(-1), jnp.asarray(ssi, dtype),
      bg_od.reshape(-1), albedo.astype(dtype))
    sums = reduce_chunks(partial.reshape(nprog, width), pseg, nseg)
    return sums[:, :nlev1].T, sums[:, nlev1:2 * nlev1].T
