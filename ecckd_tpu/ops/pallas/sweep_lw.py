"""Fused Pallas kernel (Triton route) for the LW candidate-sweep broadband RT.

The hot loop of find_g_points (SURVEY.md §7 "hard parts"): the broadband
two-stream recurrence evaluated for every wavenumber, reduced to
per-interval broadband flux profiles.  The XLA form
(:func:`ecckd_tpu.ops.rt_lw.rt_lw_bb_intervals`) materialises the grey
fitted optical depth as a full (nlay, nwav) array and reduces each tile's
flux rows with a membership matmul; this kernel reads each input once and
writes only small per-program partial sums.

Work is split into *chunks*: each chunk is at most ``block`` consecutive
wavenumbers of ONE interval, so every program contributes to exactly one
interval and the interval reduction inside a program is a plain sum over
its lanes.  Ranks outside every interval (gaps between probes) are never
visited.  Per program:

  1. the grey fitted od is gathered from the (nlay, nseg) fit table by the
     rank's partition index (``seg_of_wav``) — no one-hot matmul;
  2. the downward recurrence runs as a loop over layers, one wavenumber
     per lane, its carry in registers;
  3. the upward recurrence runs from the surface boundary as a second
     loop, recomputing each layer's terms from the same (cache-resident)
     rows rather than keeping 2*nlay values per lane: the loop compiles
     in about a second where the unrolled form took half a minute, and
     runs faster for the registers it frees (PERF.md);
  4. every level's flux is summed over the chunk's lanes and written to the
     program's own row of the partial-sum output.

The partial rows are added per interval by one small one-hot matmul at
``Precision.HIGHEST`` (exact 0/1 operand, fixed order): no atomics, so two
identical sweeps give bit-identical costs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ...constants import LW_DIFFUSIVITY

# Wavenumbers per program and warps per program, chosen on an H100 among
# blocks of 64-256 lanes over 2-8 warps (PERF.md): 128 over 2 warps was the
# fastest for both sweeps.
BLOCK = 128
NUM_WARPS = 2


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def num_programs(nwav: int, nseg: int, block: int = BLOCK) -> int:
    """Grid size for ``nseg`` intervals over ``nwav`` ranks.

    Enough chunks for intervals whose lengths add up to at most
    ``nwav + nseg`` (sorted candidates sharing boundary ranks, plus the
    bucket's front padding; see :func:`chunks_fit`)."""
    return -(-nwav // block) + 2 * nseg


def chunks_fit(i1, i2, nwav: int) -> bool:
    """Whether the intervals fit the kernel's fixed grid: the ranks they
    cover more than once may number at most ``len(i1)``.  True for every
    batch :class:`ecckd_tpu.partition.cost_kernel.CkdEquipartition` sends
    (non-overlapping groups, boundary-sharing at most, front padding)."""
    i1 = np.clip(np.asarray(i1, np.int64), 0, nwav)
    i2 = np.clip(np.asarray(i2, np.int64), -1, nwav - 1)
    length = np.maximum(i2 - i1 + 1, 0)
    order = np.argsort(i1, kind="stable")
    covered = 0
    end = -1
    for k in order:
        if length[k] == 0:
            continue
        lo = max(i1[k], end + 1)
        if i2[k] >= lo:
            covered += i2[k] - lo + 1
        end = max(end, i2[k])
    return bool(int(length.sum()) - covered <= len(i1))


def interval_chunks(i1, i2, nwav: int, block: int, nprog: int):
    """Chunk table of the interval sweep: (lo, hi, seg), each (nprog,)
    int32.  Program ``p`` covers ranks [lo[p], hi[p]) of interval seg[p];
    programs past the last chunk get an empty range and seg -1.  Bounds
    are clipped to [0, nwav) (mesh shards pass shifted local bounds)."""
    i1 = jnp.asarray(i1, jnp.int32)
    i2 = jnp.asarray(i2, jnp.int32)
    nseg = i1.shape[0]
    lo = jnp.clip(i1, 0, nwav)
    hi = jnp.clip(i2 + 1, 0, nwav)
    nchunk = (jnp.maximum(hi - lo, 0) + (block - 1)) // block
    ends = jnp.cumsum(nchunk).astype(jnp.int32)
    p = jnp.arange(nprog, dtype=jnp.int32)
    seg = jnp.searchsorted(ends, p, side="right").astype(jnp.int32)
    live = seg < nseg
    s = jnp.minimum(seg, nseg - 1)
    first = ends[s] - nchunk[s]
    plo = lo[s] + (p - first) * block
    phi = jnp.minimum(plo + block, hi[s])
    zero = jnp.zeros_like(p)
    return (jnp.where(live, plo, zero), jnp.where(live, phi, zero),
            jnp.where(live, seg, -1))


def reduce_chunks(partial, seg, nseg: int):
    """(nseg, width) per-interval sums of the (nprog, width) program rows:
    one exact-0/1 one-hot matmul at HIGHEST precision (full f32 on GPUs,
    never TF32), deterministic for a fixed chunk table."""
    onehot = (seg[None, :] == jnp.arange(nseg, dtype=jnp.int32)[:, None]
              ).astype(partial.dtype)
    return jnp.dot(onehot, partial, precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=partial.dtype)


def _sweep_kernel(nlay: int, nwav: int, nseg: int, block: int, width: int,
                  lo_ref, hi_ref, seg_ref, od_fit_ref, planck_ref, bg_ref,
                  emis_ref, surfp_ref, out_ref):
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

    def row(ref, r):
        return plgpu.load(ref.at[r * nwav + idx], mask=valid, other=0.0)

    seg = plgpu.load(seg_ref.at[idx], mask=valid, other=0)
    col = jnp.arange(width, dtype=jnp.int32)

    def put(res, c, v):
        return jnp.where(col == c, jnp.sum(jnp.where(valid, v, zero)), res)

    te = 1.0e-5

    def layer(k):
        """Transmittance and the top/base Planck weights of layer ``k``
        (clamped broadband emissivity/factor, rt_lw._emissivity_factor_bb)."""
        od = row(bg_ref, k) + plgpu.load(od_fit_ref.at[k * nseg + seg],
                                         mask=valid, other=0.0)
        emissivity = -jnp.expm1(-LW_DIFFUSIVITY * od)
        factor = jnp.maximum(
            1.0 - (1.0 / LW_DIFFUSIVITY) * jnp.maximum(emissivity, te)
            / jnp.maximum(od, te / LW_DIFFUSIVITY),
            0.5 * te)
        return 1.0 - emissivity, emissivity - factor, factor

    def down(k, carry):
        flux, p_top, res = carry
        p_base = row(planck_ref, k + 1)
        trans, coeff_top, factor = layer(k)
        flux = flux * trans + p_top * coeff_top + p_base * factor
        return flux, p_base, put(res, k + 1, flux)

    # Level 0: no downwelling at TOA
    flux, p_surf, res = jax.lax.fori_loop(
        0, nlay, down, (zero, row(planck_ref, 0), jnp.zeros((width,), dtype)))
    emis = plgpu.load(emis_ref.at[idx], mask=valid, other=0.0)
    surfp = plgpu.load(surfp_ref.at[idx], mask=valid, other=0.0)
    up = surfp * emis + (1.0 - emis) * flux
    res = put(res, nlev1 + nlay, up)

    def upward(i, carry):
        up, p_base, res = carry
        lay = nlay - 1 - i
        p_top = row(planck_ref, lay)
        trans, coeff_top, factor = layer(lay)
        up = up * trans + p_base * coeff_top + p_top * factor
        return up, p_top, put(res, nlev1 + lay, up)

    _, _, res = jax.lax.fori_loop(0, nlay, upward, (up, p_surf, res))
    plgpu.store(out_ref.at[p * width + col], res)


@functools.partial(jax.jit, static_argnames=("interpret",))
def rt_lw_bb_intervals_pallas(planck_hl, bg_od, od_fit, seg_of_wav,
                              surf_emissivity, surf_planck, i1, i2,
                              interpret=False):
    """Per-interval broadband LW fluxes, fused Pallas kernel.

    Args:
      planck_hl: (nlev+1, nwav); bg_od: (nlay, nwav);
      od_fit: (nlay, nseg) fitted od per interval;
      seg_of_wav: (nwav,) int32 partition map (whose fit each wav carries);
      surf_emissivity, surf_planck: (nwav,);
      i1, i2: (nseg,) inclusive interval bounds, meeting :func:`chunks_fit`.

    Returns (flux_dn, flux_up), each (nlev+1, nseg).
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    nlev1, nwav = planck_hl.shape
    nlay = nlev1 - 1
    nseg = i1.shape[0]
    dtype = planck_hl.dtype
    if nlev1 * nwav >= 2 ** 31:
        raise ValueError("sweep kernel indexes with int32: "
                         f"{nlev1} x {nwav} operands are too large")
    width = _next_pow2(2 * nlev1)
    nprog = num_programs(nwav, nseg)
    lo, hi, pseg = interval_chunks(i1, i2, nwav, BLOCK, nprog)
    kernel = functools.partial(_sweep_kernel, nlay, nwav, nseg, BLOCK,
                               width)
    partial = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((nprog * width,), dtype),
        grid=(nprog,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="ecckd_sweep_lw",
    )(lo, hi, jnp.asarray(seg_of_wav, jnp.int32),
      jnp.asarray(od_fit, dtype).reshape(-1), planck_hl.reshape(-1),
      bg_od.reshape(-1), jnp.asarray(surf_emissivity, dtype),
      jnp.asarray(surf_planck, dtype))
    sums = reduce_chunks(partial.reshape(nprog, width), pseg, nseg)
    return sums[:, :nlev1].T, sums[:, nlev1:2 * nlev1].T
