"""reorder_spectrum: rank wavenumbers within each band by a sorting variable.

Equivalent of src/ecckd/reorder_spectrum.cpp:36-313.

LW: the sorting variable is the pseudo-height of peak cooling computed from a
spectral radiative-transfer calculation with an idealized temperature
profile; SW: the pseudo-height at which cumulative optical depth from TOA
reaches a threshold.  The reference's per-wavenumber serial threshold scan
(reorder_spectrum.cpp:196-222) becomes a vectorized cumulative-sum +
first-true search; the per-band std::stable_sort is a NumPy stable argsort
(deterministic, matching the reference's tie semantics).
"""

from __future__ import annotations

import sys

import numpy as np

from .. import logs
from ..config import Config
from ..constants import REFERENCE_COS_SZA
from ..io import NcFile
from ..io.spectrum import open_spectrum_profile
from ..io.order import write_order
from .common import tool_prologue, find_file, setup_jax


import functools as _functools

import jax as _jax


@_functools.partial(_jax.jit,
                    static_argnames=("do_sw", "threshold_optical_depth"))
def _sorting_kernel(pressure_hl, wavenumber, d_wavenumber, od, ssi,
                    do_sw=False, threshold_optical_depth=0.5):
    """Sorting variable for ONE wavenumber block; every operand is a jit
    ARGUMENT (closures become HLO constants — at CKDMIP scale, multi-GB
    programs).
    The computation is independent per wavenumber, so blocks reproduce the
    whole-spectrum evaluation bitwise.
    """
    import jax.numpy as jnp
    from ..ops import planck_function, rt_lw, rt_direct_sw, heating_rate

    nwav = od.shape[1]
    if not do_sw:
        # Idealized T(log p): -100 C at 1 Pa to +15 C at 1e5 Pa
        # (ref reorder_spectrum.cpp:121-124)
        log_p = jnp.log(pressure_hl)
        t_hl = jnp.interp(log_p, jnp.log(jnp.array([1.0, 100000.0])),
                          jnp.array([173.15, 288.15]))
        planck_hl = planck_function(t_hl, wavenumber, d_wavenumber)
        surf_planck = planck_hl[-1]
        surf_emissivity = jnp.ones(nwav)
        flux_dn, flux_up = rt_lw(planck_hl, od, surf_emissivity,
                                 surf_planck)
        hr = heating_rate(pressure_hl, flux_dn, flux_up)
        # Only interested in cooling (ref :172-175)
        hr = jnp.minimum(hr, 0.0)
    else:
        flux_dn = rt_direct_sw(REFERENCE_COS_SZA, ssi, od)
        hr = heating_rate(pressure_hl, flux_dn)

    column_od = jnp.sum(od, axis=0)

    # Peak cooling (LW) / heating (SW) pseudo-height (ref :178-183)
    log_p_hl = jnp.log(pressure_hl)
    pseudo_height = log_p_hl[-1] - 0.5 * (log_p_hl[:-1] + log_p_hl[1:])
    d_height = log_p_hl[1:] - log_p_hl[:-1]
    num = jnp.sum(hr * (d_height * pseudo_height)[:, None], axis=0)
    den = jnp.sum(hr * d_height[:, None], axis=0)
    peak_cooling_height = num / jnp.where(den != 0.0, den, 1.0)
    peak_cooling_height = jnp.where(den != 0.0, peak_cooling_height, 0.0)

    if threshold_optical_depth > 0.0:
        peak_cooling_height = jnp.where(
            column_od < threshold_optical_depth,
            column_od - threshold_optical_depth, peak_cooling_height)

    # Height at which cumulative od from TOA reaches the threshold
    # (vectorized version of ref :196-222)
    pseudo_height_hl = log_p_hl[-1] - log_p_hl
    cum_od = jnp.concatenate(
        [jnp.zeros((1, nwav), od.dtype), jnp.cumsum(od, axis=0)], axis=0)
    reaches = cum_od[1:] >= threshold_optical_depth   # (nlay, nwav)
    ilay = jnp.argmax(reaches, axis=0)                # first such layer
    cum_above = jnp.take_along_axis(cum_od, ilay[None], axis=0)[0]
    od_lay = jnp.take_along_axis(od, ilay[None], axis=0)[0]
    h_above = pseudo_height_hl[ilay]
    h_below = pseudo_height_hl[ilay + 1]
    t = threshold_optical_depth
    interp_h = (((t - cum_above) * h_below
                 + (cum_above + od_lay - t) * h_above)
                / jnp.maximum(1.0e-12, od_lay))
    od_threshold_height = jnp.where(
        column_od <= t, column_od - t, interp_h)

    sorting = od_threshold_height if do_sw else peak_cooling_height
    return sorting, column_od


def compute_sorting_variable(pressure_hl, wavenumber, d_wavenumber,
                             optical_depth, do_sw, ssi=None,
                             threshold_optical_depth=0.5,
                             block_wav=None):
    """Sorting variable per wavenumber (jitted JAX computation, blockwise).

    ``optical_depth`` may be a dense (nlay, nwav) array or anything with
    ``iter_blocks(block_wav)`` (io.spectrum.ProfileBlocks) — the kernel
    runs per wavenumber block with all operands as jit arguments, so
    nothing of size nwav beyond 1-D outputs is ever device-resident
    (ref reorder_spectrum.cpp:98-228 holds the full spectrum; CKDMIP
    spectra at 3-5.6M wavenumbers must stream).

    Returns (sorting_variable, column_optical_depth) as numpy arrays.
    """
    import jax.numpy as jnp

    pressure_hl = jnp.asarray(pressure_hl)
    wavenumber = np.asarray(wavenumber)
    d_wavenumber = np.asarray(d_wavenumber)
    nwav = len(wavenumber)
    if block_wav is None:
        block_wav = max(1, min(nwav, 1 << 20))
    sorting = np.empty(nwav)
    column_od = np.empty(nwav)

    if hasattr(optical_depth, "iter_blocks"):
        blocks = optical_depth.iter_blocks(block_wav=block_wav)
    else:
        od_arr = np.asarray(optical_depth)
        blocks = ((i0, od_arr[:, i0:i0 + block_wav])
                  for i0 in range(0, nwav, block_wav))

    for i0, od_blk in blocks:
        nb = od_blk.shape[1]
        # Pad the ragged last block up to the uniform size so the kernel
        # compiles once; padded columns are discarded below.
        pad = min(block_wav, nwav) - nb
        if pad:
            od_blk = np.pad(od_blk, ((0, 0), (0, pad)))
        sl = slice(i0, i0 + nb)
        # Edge-padding keeps the Planck evaluation finite on the padded
        # columns (wavenumber 0 would divide 0/0); results are discarded.
        pad1 = (lambda a: np.pad(a[sl], (0, pad), mode="edge") if pad
                else a[sl])
        s_blk, c_blk = _sorting_kernel(
            pressure_hl, jnp.asarray(pad1(wavenumber)),
            jnp.asarray(pad1(d_wavenumber)), jnp.asarray(od_blk),
            jnp.asarray(pad1(np.asarray(ssi))) if do_sw else None,
            do_sw=bool(do_sw),
            threshold_optical_depth=float(threshold_optical_depth))
        sorting[sl] = np.asarray(s_blk)[:nb]
        column_od[sl] = np.asarray(c_blk)[:nb]
    return sorting, column_od


def reorder_spectrum(cfg: Config, argv=()) -> str:
    setup_jax(cfg)
    input_file = find_file(cfg.read_string("input"))
    output_file = cfg.read_string("output")
    ssi_file = cfg.read_string("ssi", default=None)
    do_sw = ssi_file is not None
    iprofile = cfg.read_int("iprofile", default=0)
    threshold = cfg.read_float("threshold_optical_depth", default=0.5)

    logs.log(("Assuming shortwave spectral region (ssi provided)" if do_sw
              else "Assuming longwave spectral region (ssi not provided)"))
    logs.log(f"Reading {input_file}")
    # Blockwise read + compute (ref reorder_spectrum.cpp:98-228 holds the
    # full spectrum; here only O(nwav) 1-D outputs are ever materialized —
    # CKDMIP spectra are 3-5.6M wavenumbers x ~50 layers).
    sp = open_spectrum_profile(input_file, iprofile)
    molecule = cfg.read_string("molecule", default=sp.molecule)
    nlay = len(sp.pressure_hl) - 1
    nwav = len(sp.wavenumber)
    block_wav = cfg.read_int("streaming_block_wav", default=1 << 20)
    logs.log(f"{nlay} layers\n{nwav} spectral points")

    ssi = None
    if do_sw:
        f = NcFile(find_file(ssi_file))
        ssi = np.asarray(f.read("solar_spectral_irradiance"), np.float64)
        f.close()

    sorting, column_od = compute_sorting_variable(
        sp.pressure_hl, sp.wavenumber, sp.d_wavenumber, sp,
        do_sw, ssi=ssi, threshold_optical_depth=threshold,
        block_wav=block_wav)
    sp.close()

    # Band boundaries
    if cfg.exist("wavenumber1"):
        band1 = np.asarray(cfg.read_floats("wavenumber1"))
        band2 = np.asarray(cfg.read_floats("wavenumber2"))
    else:
        band1 = np.array([max(0.0, sp.wavenumber[0] - sp.d_wavenumber[0])])
        band2 = np.array([sp.wavenumber[-1] + sp.d_wavenumber[-1]])
    nband = len(band1)
    logs.log("Treating the entire spectrum as one band" if nband == 1
             else f"Splitting the spectrum into {nband} bands")

    band_clamp1 = band1.copy()
    band_clamp2 = band2.copy()
    band_clamp1[0] = max(sp.wavenumber[0], band1[0])
    band_clamp2[-1] = min(sp.wavenumber[-1], band2[-1])

    # Per-band stable sort ascending in the sorting variable
    # (ref :262-295; stable_sort tie semantics preserved via kind="stable")
    iband = np.full(nwav, -1, np.int32)
    g_index = np.arange(nwav)
    for jband in range(nband):
        logs.log(f"  Band {jband}: {band_clamp1[jband]}-"
                 f"{band_clamp2[jband]} cm-1")
        if jband < nband - 1:
            sel = ((sp.wavenumber >= band1[jband])
                   & (sp.wavenumber < band2[jband]))
        else:
            sel = ((sp.wavenumber >= band1[jband])
                   & (sp.wavenumber <= band2[jband]))
        idx = np.nonzero(sel)[0]
        if len(idx) == 0:
            continue
        iband[idx] = jband
        i1, i2 = idx[0], idx[-1]
        sub = g_index[i1:i2 + 1]
        order = np.argsort(sorting[sub], kind="stable")
        g_index[i1:i2 + 1] = sub[order]

    rank = np.empty(nwav, np.int32)
    rank[g_index] = np.arange(nwav)

    logs.log(f"Writing {output_file}")
    write_order(output_file, argv or sys.argv, molecule, cfg.sprint(),
                band_clamp1, band_clamp2, sp.wavenumber, sp.d_wavenumber,
                iband, rank, column_od, sorting)
    return output_file


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from ..errors import run_tool
    return run_tool(
        lambda: reorder_spectrum(tool_prologue(argv), argv=["reorder_spectrum"] + argv),
        name="reorder_spectrum")


if __name__ == "__main__":
    sys.exit(main())
