"""find_g_points: partition reordered spectra into g-points.

Equivalent of src/ecckd/find_g_points.cpp:430-1662, the heart of
the spectral partitioning.  Per gas and band, an equipartition search finds
rank intervals of equal radiative cost; all candidate-interval costs of a
sweep are evaluated in ONE jitted device kernel (partition.cost_kernel) instead
of the reference's OpenMP loop.  Features covered: per-gas background
spectra, LW and SW (incl. the total-transmission method with low/high
scaling runs), g_split sub-band machinery, base_split/base_wavenumber
dissection, min/max g-point overrides with sqrt-spaced re-initialization,
the SW cloud pseudo-gas, hypercube gas overlap, and the g-point NetCDF
output schema.
"""

from __future__ import annotations

import functools as _functools
import sys
from typing import Dict, List, Optional

import jax as _jax
import numpy as np

from .. import logs
from ..config import Config
from ..constants import REFERENCE_COS_SZA, LW_DIFFUSIVITY
from ..io import NcFile, NcWriter, write_standard_attributes, read_order
from ..io.spectrum import open_merged_spectrum_profile
from ..partition.cost_kernel import (CandidateCostLw, CandidateCostSw,
                                     CkdEquipartition)
from ..partition.gas_data import (SingleGasData, overlap_g_points,
                                  merged_g_point_map)
from .common import tool_prologue, read_string_list, find_file, setup_jax


def calc_median_sorting_variable(sorting_variable, weight, i1, i2):
    """Weight-weighted median of the sorting variable over [i1, i2]
    (ref find_g_points.cpp:36-49)."""
    w = np.asarray(weight[i1:i2 + 1])
    half = 0.5 * w.sum()
    cum = np.cumsum(w)
    idx = int(np.searchsorted(cum, half))
    idx = min(idx, i2 - i1)   # loop runs iind < i2 so caps at i2
    return float(sorting_variable[i1 + idx])


def _sqrt_bounds(ng):
    return np.sqrt(np.arange(ng + 1, dtype=np.float64) / ng)


def _read_reordered_od(pb, irank, block_wav):
    """Stream a profile's optical depth from disk directly into RANK order.

    Reads wavenumber blocks (contiguous on disk) and scatters each into its
    rank positions, so only ONE (nlay, nwav) array is ever resident — the
    dense gather ``od[:, ireorder]`` would peak at two full copies (~5 GB
    at CKDMIP scale).  Equivalent to read_merged_spectrum + reorder
    (find_g_points.cpp reads then permutes the same way).  Reads run one
    block AHEAD on a background thread (io.prefetch), overlapping disk
    I/O with the scatter — the reference's reads are synchronous and
    dominate its wall clock (doc/ecckd_documentation.tex:225-228).
    """
    from ..io.prefetch import prefetch_iter
    od = np.empty((pb.nlay, pb.nwav))
    col_od = np.zeros(pb.nlay)
    for i0, block in prefetch_iter(pb.iter_blocks(block_wav=block_wav),
                                   depth=2):
        od[:, irank[i0:i0 + block.shape[1]]] = block
        col_od += block.sum(axis=1)
    logs.log(f"    Column optical depth: {col_od.mean():g} +/- "
             f"{col_od.std():g}")
    return od


@_functools.partial(_jax.jit, static_argnames=("with_bg",))
def _lw_truth_block(temperature_hl, pressure_hl, wav, dwav, od, bg_od,
                    with_bg):
    """One wavenumber block of the LW truth fields, ONE compiled dispatch
    instead of one per operation.  All operands are jit arguments (no
    closure constants)."""
    import jax.numpy as jnp
    from ..ops import planck_function, rt_lw
    from ..ops.heating_rate import heating_rate

    pblk = planck_function(temperature_hl, wav, dwav)
    tot = bg_od + od if with_bg else od
    fd, fu = rt_lw(pblk, tot, jnp.ones(od.shape[1], od.dtype), pblk[-1])
    hr = heating_rate(pressure_hl, fd, fu)
    return pblk, hr, fd[-1], fu[0]


def _lw_truth_blockwise(planck_function, rt_lw, hr_fn, temperature_hl,
                        pressure_hl, wavenumber_cm_1, d_wavenumber_cm_1,
                        optical_depth, bg_optical_depth, block_wav):
    """LW truth fields computed in wavenumber blocks.

    The spectral RT is independent per wavenumber, so the full
    (nlev+1, nwav) flux arrays never need to exist — only the Planck LUT
    and heating rate (needed per band by the candidate kernels) plus the
    boundary-flux rows are kept.  Results are bitwise identical to the
    whole-spectrum evaluation.  Each block runs as one jitted dispatch.
    """
    del planck_function, rt_lw, hr_fn   # kept for signature stability
    nwav = optical_depth.shape[1]
    nlev1 = len(temperature_hl)
    nlay = len(pressure_hl) - 1
    planck_hl = np.empty((nlev1, nwav))
    hr = np.empty((nlay, nwav))
    flux_dn_surf = np.empty(nwav)
    flux_up_toa = np.empty(nwav)
    with_bg = bg_optical_depth is not None
    for i0 in range(0, nwav, block_wav):
        sl = slice(i0, min(i0 + block_wav, nwav))
        pblk, hrb, fds, fut = _lw_truth_block(
            temperature_hl, pressure_hl, wavenumber_cm_1[sl],
            d_wavenumber_cm_1[sl], optical_depth[:, sl],
            bg_optical_depth[:, sl] if with_bg else np.zeros((0, 0)),
            with_bg)
        planck_hl[:, sl] = np.asarray(pblk)
        hr[:, sl] = np.asarray(hrb)
        flux_dn_surf[sl] = np.asarray(fds)
        flux_up_toa[sl] = np.asarray(fut)
    return planck_hl, hr, flux_dn_surf, flux_up_toa


@_functools.partial(_jax.jit, static_argnames=("with_bg", "scalings",
                                               "use_albedo"))
def _sw_truth_block(cos_sza, pressure_hl, ssi, od, bg_od, albedo,
                    with_bg, scalings, use_albedo):
    """One wavenumber block of the SW truth fields (one dispatch; all
    operands jit arguments).  With ``scalings`` = (min, max), also the
    low/high scaled runs of the total-transmission method."""
    from ..ops import rt_direct_sw, rt_norayleigh_sw
    from ..ops.heating_rate import heating_rate

    bg = bg_od if with_bg else 0.0
    tot = bg + od
    fd = rt_direct_sw(cos_sza, ssi, tot)
    out = dict(hr=heating_rate(pressure_hl, fd), flux_dn_surf=fd[-1])
    if scalings is not None:
        for tag, scaling in (("low", scalings[0]), ("high", scalings[1])):
            od_s = bg + scaling * od
            if use_albedo:
                fds, fus = rt_norayleigh_sw(cos_sza, ssi, od_s, albedo)
                out[f"flux_up_toa_{tag}"] = fus[0]
            else:
                fds = rt_direct_sw(cos_sza, ssi, od_s)
            out[f"hr_{tag}"] = heating_rate(pressure_hl, fds)
            out[f"flux_dn_surf_{tag}"] = fds[-1]
    return out


def _sw_truth_blockwise(rt_direct_sw, rt_norayleigh_sw, hr_fn, cos_sza,
                        pressure_hl, ssi_reorder, optical_depth,
                        bg_optical_depth, albedo, total_trans_scalings,
                        block_wav):
    """SW truth fields in wavenumber blocks; with ``total_trans_scalings``
    = (min_scaling, max_scaling, use_albedo) also the low/high scaled runs
    of the total-transmission method (find_g_points.cpp:906-960).
    Each block runs as one jitted dispatch."""
    del rt_direct_sw, rt_norayleigh_sw, hr_fn   # signature stability
    nwav = optical_depth.shape[1]
    nlay = len(pressure_hl) - 1
    hr = np.empty((nlay, nwav))
    flux_dn_surf = np.empty(nwav)
    extras = None
    scalings = None
    use_albedo = False
    if total_trans_scalings is not None:
        min_scaling, max_scaling, use_albedo = total_trans_scalings
        scalings = (float(min_scaling), float(max_scaling))
        extras = dict(
            flux_dn_surf_low=np.empty(nwav), flux_up_toa_low=np.zeros(nwav),
            flux_dn_surf_high=np.empty(nwav),
            flux_up_toa_high=np.zeros(nwav),
            hr_low=np.empty((nlay, nwav)), hr_high=np.empty((nlay, nwav)))
    with_bg = bg_optical_depth is not None
    empty = np.zeros((0, 0))
    for i0 in range(0, nwav, block_wav):
        sl = slice(i0, min(i0 + block_wav, nwav))
        out = _sw_truth_block(
            cos_sza, pressure_hl, ssi_reorder[sl], optical_depth[:, sl],
            bg_optical_depth[:, sl] if with_bg else empty,
            albedo[sl] if albedo is not None else np.zeros(0),
            with_bg, scalings, bool(use_albedo))
        hr[:, sl] = np.asarray(out["hr"])
        flux_dn_surf[sl] = np.asarray(out["flux_dn_surf"])
        if extras is None:
            continue
        for tag in ("low", "high"):
            extras[f"hr_{tag}"][:, sl] = np.asarray(out[f"hr_{tag}"])
            extras[f"flux_dn_surf_{tag}"][sl] = np.asarray(
                out[f"flux_dn_surf_{tag}"])
            if use_albedo:
                extras[f"flux_up_toa_{tag}"][sl] = np.asarray(
                    out[f"flux_up_toa_{tag}"])
    return hr, flux_dn_surf, extras


def _cloud_pseudo_gas(cfg: Config, cloud_str: str, ssi: np.ndarray
                      ) -> SingleGasData:
    """SW cloud pseudo-gas: partition by equal solar energy within
    reflectance ranges (ref find_g_points.cpp:545-651)."""
    reordering_input = cfg.read_string(f"{cloud_str}.reordering_input")
    logs.log(f"Reading {reordering_input}")
    order = read_order(find_file(reordering_input))
    irank = order.rank.astype(np.int64).copy()
    iband = order.band_number
    sorting_variable = order.sorting_variable
    band1 = order.wavenumber1_band
    nband = len(band1)

    max_reflectance_range = cfg.read_float(
        f"{cloud_str}.max_reflectance_range", default=0.26)

    n_g_points = np.zeros(nband, np.int64)
    rank1_l, rank2_l, band_l = [], [], []
    error_l, median_l = [], []

    for jband in range(nband):
        logs.log(f"Band {jband}")
        band_index = np.nonzero(iband == jband)[0]
        ibegin, iend = band_index[0], band_index[-1]
        sv_band = sorting_variable[ibegin:iend + 1]
        min_ref, max_ref = sv_band.min(), sv_band.max()
        ng_band = int((max_ref - min_ref) / max_reflectance_range) + 1
        n_g_points[jband] = ng_band

        # Partition into equal ranges of solar energy
        ireorder = np.empty(len(band_index), np.int64)
        ireorder[irank[ibegin:iend + 1] - ibegin] = np.arange(ibegin,
                                                              iend + 1)
        cum_ssi = np.full(len(irank), -1.0)
        cum_ssi[ireorder] = np.cumsum(ssi[ireorder])
        band_irradiance = ssi[ibegin:iend + 1].sum()
        d_irr = band_irradiance * (1.0 + 1.0e-8) / ng_band
        for jg in range(ng_band):
            sel = ((iband == jband) & (cum_ssi >= jg * d_irr)
                   & (cum_ssi < (jg + 1) * d_irr))
            idx = np.nonzero(sel)[0]
            rank1_l.append(int(irank[idx].min()))
            rank2_l.append(int(irank[idx].max()))
            error_l.append(float(sorting_variable[idx].max()
                                 - sorting_variable[idx].min()))
            # -2.0 keeps cloud sorting variables below those of gases
            median_l.append(-2.0 + float(sorting_variable[idx].mean()))
            band_l.append(jband)

    gas = SingleGasData(
        molecule=cloud_str, n_g_points=n_g_points,
        band_number=np.asarray(band_l, np.int32),
        rank1=np.asarray(rank1_l, np.int64),
        rank2=np.asarray(rank2_l, np.int64),
        error=np.asarray(error_l), sorting_variable=np.asarray(median_l))
    gas.store_g_points(irank)
    gas.print()
    return gas


def find_g_points(cfg: Config, argv=()) -> str:
    setup_jax(cfg)
    from ..ops import planck_function, rt_lw, rt_direct_sw, rt_norayleigh_sw
    from ..ops.heating_rate import heating_rate as hr_fn
    import jax.numpy as jnp

    output = cfg.read_string("output")
    debug_partition = cfg.read_bool("debug_partition", default=False)

    do_sw = False
    cos_sza = REFERENCE_COS_SZA
    reference_albedo = 0.15
    ssi = None
    ssi_file_name = cfg.read_string("ssi", default=None)
    if ssi_file_name:
        do_sw = True
        logs.log("Assuming shortwave spectral region (ssi provided)")
        f = NcFile(find_file(ssi_file_name))
        ssi = np.asarray(f.read("solar_spectral_irradiance"), np.float64)
        f.close()
    else:
        logs.log("Assuming longwave spectral region (ssi not provided)")

    iprofile = cfg.read_int("iprofile", default=0)
    hr_tol_in = np.asarray(cfg.read_floats("heating_rate_tolerance"))
    tolerance_tolerance = cfg.read_float("tolerance_tolerance", default=0.02)
    max_iterations = cfg.read_int("max_iterations", default=60)
    averaging_method = cfg.read_string("averaging_method", default="linear")
    flux_weight = cfg.read_float("flux_weight", default=0.02)
    max_no_rayleigh_wavenumber = cfg.read_float(
        "max_no_rayleigh_wavenumber", default=10000.0)
    min_pressure = cfg.read_float("min_pressure", default=0.0)
    use_pallas = cfg.read_bool("use_pallas", default=None)

    # Mesh-sharded candidate sweeps: the band's wavenumber axis is sharded
    # over the mesh's spectral axis and interval/flux partials psum across
    # devices (partition.cost_kernel docstring; multi-device form of the
    # reference's OpenMP candidate loop, equipartition.h:100-104).  "auto"
    # follows the execution policy (on for several GPUs); force with
    # sharded=1 (used by the CPU-mesh tests — the psum changes f64
    # summation order, so the default CPU path stays single-device for
    # bit-stable partition determinism).
    sharded_cfg = str(cfg.read_string("sharded", default="auto")).lower()
    mesh = None
    if sharded_cfg not in ("0", "no", "false"):
        import jax
        from ..policy import execution_policy
        if jax.device_count() > 1 and (
                sharded_cfg in ("1", "yes", "true")
                or execution_policy().auto_shard):
            from ..parallel import make_mesh
            mesh = make_mesh(data_parallel=1)
            logs.log(f"Sharding candidate sweeps over "
                     f"{mesh.shape['spectral']} devices (spectral axis)")

    single_gas_data: List[SingleGasData] = []
    planck_hl_cache = None
    surf_planck_cache = None
    band_bound1 = band_bound2 = None
    nwav = 0
    wavenumber_orig = None

    cloud_str = cfg.read_string("cloud", default=None)
    if cloud_str:
        logs.log(f"*** FINDING G POINTS FOR {cloud_str}")
        if not do_sw:
            raise ValueError("Don't yet know how to sort cloud properties "
                             "in the longwave")
        single_gas_data.append(_cloud_pseudo_gas(cfg, cloud_str, ssi))
        corder = read_order(
            find_file(cfg.read_string(f"{cloud_str}.reordering_input")))
        band_bound1 = corder.wavenumber1_band
        band_bound2 = corder.wavenumber2_band

    gases = read_string_list(cfg, "gases")
    for gas_str in gases:
        Gas = gas_str.upper()
        logs.log(f"*** FINDING G POINTS FOR {Gas}")

        min_scaling = min(0.5, cfg.read_float(f"{gas_str}.min_scaling",
                                              default=1.0))
        max_scaling = max(2.5, cfg.read_float(f"{gas_str}.max_scaling",
                                              default=1.0))

        reordering_input = cfg.read_string(f"{gas_str}.reordering_input")
        logs.log(f"Reading {reordering_input}")
        order = read_order(find_file(reordering_input))
        irank = order.rank.astype(np.int64).copy()
        iband = order.band_number
        band_bound1 = order.wavenumber1_band
        band_bound2 = order.wavenumber2_band
        sorting_variable_orig = order.sorting_variable
        nband = len(band_bound1)

        base_wavenumber_boundary = np.asarray(cfg.read_floats(
            f"{gas_str}.base_wavenumber_boundary", default=None) or [])

        g_split = np.full(nband, -1.0)
        have_g_split = False
        subband_wavenumber_boundary = np.asarray([])
        raw = cfg.read_floats(f"{gas_str}.g_split", default=None)
        if raw is not None:
            have_g_split = True
            n = min(nband, len(raw))
            g_split[:n] = raw[:n]
            sub = cfg.read_floats(f"{gas_str}.subband_wavenumber_boundary",
                                  default=None)
            if sub is None:
                raise ValueError("g_split must be accompanied by "
                                 "subband_wavenumber_boundary")
            subband_wavenumber_boundary = np.asarray(sub)
            logs.log(f"Bands will be split at g values according to: "
                     f"{g_split}")

        base_split = np.ones(nband)
        raw = cfg.read_floats(f"{gas_str}.base_split", default=None)
        if raw is not None:
            if have_g_split:
                raise ValueError("Cannot use both g_split and base_split")
            n = min(nband, len(raw))
            base_split[:n] = raw[:n]

        min_g_points = np.ones(nband, np.int64)
        raw = cfg.read_ints(f"{gas_str}.min_g_points", default=None)
        if raw is not None:
            n = min(nband, len(raw))
            min_g_points[:n] = raw[:n]
        max_g_points = np.full(nband, 256, np.int64)
        raw = cfg.read_ints(f"{gas_str}.max_g_points", default=None)
        if raw is not None:
            n = min(nband, len(raw))
            max_g_points[:n] = raw[:n]

        band_albedo = np.zeros(nband)
        no_rayleigh = band_bound2 <= max_no_rayleigh_wavenumber
        band_albedo[no_rayleigh] = reference_albedo
        if np.any(no_rayleigh):
            max_no_rayleigh_wavenumber = band_bound2[no_rayleigh].max()

        if len(hr_tol_in) == 1:
            heating_rate_tolerance = np.full(nband, hr_tol_in[0])
        elif len(hr_tol_in) == nband:
            heating_rate_tolerance = hr_tol_in
        else:
            raise ValueError("heating_rate_tolerance must have either 1 "
                             "element, or one per band")

        # ireorder: index that reorders arrays into rank order
        ireorder = np.empty(len(irank), np.int64)
        ireorder[irank] = np.arange(len(irank))
        sorting_variable = sorting_variable_orig[ireorder]
        ssi_reorder = ssi[ireorder] if do_sw else None

        # ---- g_split sub-band machinery (ref :788-870) ----
        nsubband = np.zeros(nband, np.int64)
        iupperindex = np.full(nband, -1, np.int64)
        nsub_max = len(subband_wavenumber_boundary) + 1
        isubband1 = np.full((nband, nsub_max), -1, np.int64)
        isubband2 = np.full((nband, nsub_max), -1, np.int64)
        wavenumber_cm_1 = None
        if have_g_split:
            wavenumber_orig = order.wavenumber
            wavenumber_cm_1 = wavenumber_orig[ireorder]
            for jband in range(nband):
                in_band = ((subband_wavenumber_boundary > band_bound1[jband])
                           & (subband_wavenumber_boundary
                              < band_bound2[jband]))
                if g_split[jband] > 0.0 and np.any(in_band):
                    ibandloc = np.nonzero(iband == jband)[0]
                    irank1 = ibandloc[0]
                    irank3 = ibandloc[-1]
                    irank2 = irank3
                    iupperindex[jband] = irank3
                    if g_split[jband] < 1.0:
                        irank2 = int(ibandloc[0]
                                     + g_split[jband] * (irank3 - irank1))
                    nsub = 1 + int(np.sum(in_band))
                    nsubband[jband] = nsub
                    wn_bound = np.empty(nsub + 1)
                    wn_bound[0] = band_bound1[jband]
                    wn_bound[-1] = band_bound2[jband] + 1.0
                    if nsub > 1:
                        wn_bound[1:-1] = subband_wavenumber_boundary[in_band]
                    logs.log(f"  Splitting optically thin part of band "
                             f"{jband} into {nsub} sub-bands")
                    irank_new = irank.copy()
                    isubband1[jband, 0] = irank1
                    for isub in range(nsub):
                        if isub > 0:
                            isubband1[jband, isub] = \
                                isubband2[jband, isub - 1] + 1
                        sel = ((wavenumber_cm_1 >= wn_bound[isub])
                               & (wavenumber_cm_1 < wn_bound[isub + 1])
                               & (irank[ireorder] >= irank1)
                               & (irank[ireorder] <= irank2))
                        idx = np.nonzero(sel)[0]
                        isubband2[jband, isub] = (isubband1[jband, isub]
                                                  + len(idx) - 1)
                        irank_new[ireorder[idx]] = np.arange(
                            isubband1[jband, isub],
                            isubband2[jband, isub] + 1)
                        logs.log(f"    Creating {wn_bound[isub]}-"
                                 f"{wn_bound[isub + 1]} cm-1 sub-band: "
                                 f"{len(idx)} spectral points")
                    if isubband2[jband, nsub - 1] != irank2:
                        raise ValueError("Failed to account for all "
                                         "wavenumbers in split")
                    irank = irank_new
                    ireorder[irank] = np.arange(len(irank))
                    sorting_variable = sorting_variable_orig[ireorder]
                    wavenumber_cm_1 = wavenumber_orig[ireorder]
                    if do_sw:
                        ssi_reorder = ssi[ireorder]

        # ---- Background + target spectra (streamed into rank order) ----
        block_wav = cfg.read_int("streaming_block_wav", default=1 << 20)
        if cfg.exist(f"{gas_str}.background_input"):
            logs.log("Generating background optical depth")
            with open_merged_spectrum_profile(
                    cfg, iprofile, f"{gas_str}.background_") as bgpb:
                bg_optical_depth = _read_reordered_od(bgpb, irank, block_wav)
                wavenumber_orig = bgpb.wavenumber
        else:
            # Kept as None (lazy zeros): a full zero array is ~2.4 GB at
            # CKDMIP scale; per-band zero slices are built where needed.
            bg_optical_depth = None

        logs.log("Generating target optical depth")
        pb = open_merged_spectrum_profile(cfg, iprofile, f"{gas_str}.")
        molecule = pb.molecule
        nwav = pb.nwav
        if wavenumber_orig is None:
            wavenumber_orig = pb.wavenumber

        albedo_orig = None
        if do_sw:
            albedo_orig = np.zeros(nwav)
            albedo_orig[pb.wavenumber < max_no_rayleigh_wavenumber] = \
                reference_albedo

        optical_depth = _read_reordered_od(pb, irank, block_wav)
        wavenumber_cm_1 = pb.wavenumber[ireorder]
        d_wavenumber_cm_1 = pb.d_wavenumber[ireorder]
        pressure_hl = pb.pressure_hl
        temperature_hl = pb.temperature_hl
        pb.close()
        nlay = len(pressure_hl) - 1
        logs.log(f"{nlay} layers\n{nwav} spectral points")

        albedo = albedo_orig[ireorder] if do_sw else None

        # ---- Truth fluxes (blockwise: full flux arrays never resident) --
        surf_emissivity = np.ones(nwav)
        extras = None
        if not do_sw:
            logs.log("Computing Planck function and longwave radiative "
                     "transfer")
            planck_hl, hr, flux_dn_surf, flux_up_toa = _lw_truth_blockwise(
                planck_function, rt_lw, hr_fn, temperature_hl, pressure_hl,
                wavenumber_cm_1, d_wavenumber_cm_1, optical_depth,
                bg_optical_depth, block_wav)
            surf_planck = planck_hl[-1].copy()
        else:
            planck_hl = surf_planck = None
            logs.log("Performing shortwave radiative transfer")
            tt = None
            if averaging_method == "total-transmission":
                tt = (min_scaling, max_scaling,
                      max_no_rayleigh_wavenumber > 0.0)
            hr, flux_dn_surf, extras = _sw_truth_blockwise(
                rt_direct_sw, rt_norayleigh_sw, hr_fn, cos_sza, pressure_hl,
                ssi_reorder, optical_depth, bg_optical_depth, albedo, tt,
                block_wav)
            flux_up_toa = np.zeros(nwav)
            if extras is not None:
                extras["min_scaling"] = min_scaling
                extras["max_scaling"] = max_scaling

        layer_weight = (np.sqrt(pressure_hl[1:])
                        - np.sqrt(pressure_hl[:-1]))
        pressure_fl = 0.5 * (pressure_hl[1:] + pressure_hl[:-1])
        layer_weight[pressure_fl < min_pressure] = 0.0
        layer_weight /= layer_weight.sum()

        # ---- Metric (ref :1119-1150) ----
        # Transformed IN PLACE in blocks: the od itself is not needed after
        # the truth fluxes above, and a second (nlay, nwav) array would
        # double peak memory at CKDMIP scale.
        if averaging_method in ("linear", "logarithmic",
                                "total-transmission"):
            metric = optical_depth
        elif averaging_method in ("transmission", "transmission-2",
                                  "square-root"):
            scale = LW_DIFFUSIVITY * (2.0 if averaging_method
                                      == "transmission-2" else 1.0)
            for i0 in range(0, nwav, block_wav):
                sl = slice(i0, min(i0 + block_wav, nwav))
                if averaging_method == "square-root":
                    np.sqrt(optical_depth[:, sl], out=optical_depth[:, sl])
                else:
                    blk = optical_depth[:, sl]
                    np.expm1(-scale * blk, out=blk)
                    np.negative(blk, out=blk)
            metric = optical_depth
        else:
            raise ValueError(f"Averaging method {averaging_method!r} not "
                             "understood")

        # ---- Per-band equipartition ----
        logs.log("Finding g points:")
        n_g_points_per_band = []
        rank1_l, rank2_l, band_l = [], [], []
        error_l, median_l = [], []

        def _band_range(jband):
            band_index = np.nonzero(iband == jband)[0]
            return int(band_index[0]), int(band_index[-1])

        def _make_kernel(sl, albedo_val):
            """Candidate-cost kernel over ``sl`` of the rank axis: one
            band (sequential mode, ref find_g_points.cpp:1152) or the
            whole gas (band_parallel gas-level kernel — bands are
            disjoint rank ranges, so band probes are global intervals)."""
            if bg_optical_depth is None:
                # Lazy zeros: a zero-stride broadcast view, materialized
                # on device only (a full host array would be ~GBs at
                # CKDMIP scale for the gas-level kernel).
                bg_band = np.broadcast_to(
                    np.zeros(1, dtype=np.asarray(metric).dtype),
                    metric[:, sl].shape)
            else:
                bg_band = bg_optical_depth[:, sl]
            if not do_sw:
                return CandidateCostLw(
                    averaging_method, flux_weight, layer_weight, pressure_hl,
                    surf_emissivity[sl], surf_planck[sl], flux_dn_surf[sl],
                    flux_up_toa[sl], planck_hl[:, sl],
                    bg_band, metric[:, sl], hr[:, sl],
                    use_pallas=use_pallas, mesh=mesh)
            band_extras = None
            if extras is not None:
                band_extras = dict(
                    flux_dn_surf_low=extras["flux_dn_surf_low"][sl],
                    flux_up_toa_low=extras["flux_up_toa_low"][sl],
                    flux_dn_surf_high=extras["flux_dn_surf_high"][sl],
                    flux_up_toa_high=extras["flux_up_toa_high"][sl],
                    min_scaling=min_scaling, max_scaling=max_scaling,
                    hr_low=extras["hr_low"][:, sl],
                    hr_high=extras["hr_high"][:, sl])
            return CandidateCostSw(
                averaging_method, flux_weight, layer_weight, cos_sza,
                pressure_hl, ssi_reorder[sl], albedo_val,
                flux_dn_surf[sl], flux_up_toa[sl],
                bg_band, metric[:, sl], hr[:, sl],
                extras=band_extras, use_pallas=use_pallas, mesh=mesh)

        def _search_band(jband, kernel_like):
            """One band's equipartition search (thread-safe: only its own
            eq and kernel view are touched).  Returns
            (istatus, bounds, error, ng, eq)."""
            eq = CkdEquipartition(kernel_like)
            eq.set_partition_max_iterations(max_iterations)
            eq.set_partition_tolerance(tolerance_tolerance)
            eq.set_verbose(False)

            if nsubband[jband] > 1:
                bounds_l2: List[float] = []
                error_l2: List[float] = []
                ng = 0
                denom = float(iupperindex[jband] - isubband1[jband, 0])
                for jsub in range(int(nsubband[jband])):
                    g_start = (isubband1[jband, jsub]
                               - isubband1[jband, 0]) / denom
                    g_end = (isubband2[jband, jsub]
                             - isubband1[jband, 0]) / denom
                    logs.log(f"  Subband {jsub}: g range {g_start}-{g_end}")
                    istatus, sb, se = eq.equipartition_e(
                        heating_rate_tolerance[jband], g_start, g_end)
                    if ng == 0:
                        bounds_l2 = list(sb)
                    else:
                        bounds_l2[ng:ng] = list(sb)
                    error_l2.extend(se)
                    ng += len(se)
                if g_split[jband] < 1.0:
                    g_start = (isubband2[jband, int(nsubband[jband]) - 1]
                               - isubband1[jband, 0]) / denom
                    logs.log(f"  Final overarching subband: g range "
                             f"{g_start}-1.0")
                    istatus, sb, se = eq.equipartition_e(
                        heating_rate_tolerance[jband], g_start, 1.0)
                    nsubg = len(se)
                    if ng + nsubg < min_g_points[jband]:
                        nsubg = int(min_g_points[jband]) - ng
                        sb = (g_split[jband] + (1.0 - g_split[jband])
                              * _sqrt_bounds(nsubg))
                        se = np.zeros(nsubg)
                        eq.invalidate()
                        istatus = eq.equipartition_n(sb, se)
                    bounds_l2[ng:ng] = list(sb)
                    error_l2.extend(se)
                    ng += nsubg
                bounds = np.asarray(bounds_l2[:ng + 1])
                error = np.asarray(error_l2)
            else:
                istatus, bounds, error = eq.equipartition_e(
                    heating_rate_tolerance[jband], 0.0, 1.0)
                ng = len(error)
                if ng < min_g_points[jband]:
                    logs.log(f"  {ng} intervals is fewer than minimum of "
                             f"{min_g_points[jband]}")
                    ng = int(min_g_points[jband])
                    bounds = _sqrt_bounds(ng)
                    error = np.zeros(ng)
                    eq.invalidate()
                    istatus = eq.equipartition_n(bounds, error)
                elif ng > max_g_points[jband]:
                    logs.log(f"  {ng} intervals is more than maximum of "
                             f"{max_g_points[jband]}")
                    ng = int(max_g_points[jband])
                    bounds = _sqrt_bounds(ng)
                    error = np.zeros(ng)
                    eq.invalidate()
                    istatus = eq.equipartition_n(bounds, error)

            return istatus, bounds, error, ng, eq

        # ---- Cross-band probe batching (band_parallel) ----
        # Bands are independent; the reference loops them serially only
        # because its C++ is serial (find_g_points.cpp:1152).  In
        # "parallel" mode each band's search runs on a thread against ONE
        # gas-level kernel and every device dispatch carries ALL bands'
        # pending probes (partition.band_parallel), dividing the serial
        # host->device decision latency by ~nband.  "serial" runs the same
        # gas-level kernel sequentially (bit-identical validation mode);
        # "auto" follows the execution policy (parallel on a GPU) and keeps
        # the per-band CPU path bit-stable.  debug_partition needs band-local
        # kernels, so it forces the sequential per-band path.
        bp_cfg = str(cfg.read_string("band_parallel",
                                     default="auto")).lower()
        if bp_cfg in ("1", "yes", "true", "parallel"):
            band_mode = "parallel"
        elif bp_cfg in ("serial", "serial_gas"):
            band_mode = "serial_gas"
        elif bp_cfg in ("0", "no", "false"):
            band_mode = "off"
        else:
            from ..policy import execution_policy
            band_mode = ("parallel" if execution_policy().band_parallel
                         else "off")
        if nband <= 1 or debug_partition:
            band_mode = "off"

        band_results = {}
        gas_kernel = None
        if band_mode != "off":
            from ..partition.band_parallel import (BandKernelView,
                                                   ProbeScheduler)
            gas_albedo = None
            if do_sw:
                gas_albedo = np.zeros(nwav)
                for jband in range(nband):
                    b1, b2 = _band_range(jband)
                    gas_albedo[b1:b2 + 1] = band_albedo[jband]
            gas_kernel = _make_kernel(slice(0, nwav), gas_albedo)
            offsets = [_band_range(j) for j in range(nband)]
            if band_mode == "parallel":
                import threading
                logs.log(f"Batching equipartition probes across {nband} "
                         "bands (band_parallel)")
                sched = ProbeScheduler(gas_kernel)
                Thread = threading.Thread

                def _run(jband):
                    b1, b2 = offsets[jband]
                    view = BandKernelView(gas_kernel, b1, b2 - b1 + 1,
                                          sched, jband)
                    try:
                        band_results[jband] = _search_band(jband, view)
                    except BaseException as e:   # noqa: BLE001
                        band_results[jband] = e
                    finally:
                        sched.done()

                # Register every thread BEFORE starting any: an early
                # starter must not trigger a dispatch at active=1.
                for _ in range(nband):
                    sched.register()
                threads = [Thread(target=_run, args=(j,),
                                  name=f"ecckd-band{j}")
                           for j in range(nband)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                for j in range(nband):
                    if isinstance(band_results.get(j), BaseException):
                        raise band_results[j]
                logs.log(f"  band_parallel: {sched.dispatches} merged "
                         "dispatches")
            else:
                for jband in range(nband):
                    b1, b2 = offsets[jband]
                    view = BandKernelView(gas_kernel, b1, b2 - b1 + 1)
                    band_results[jband] = _search_band(jband, view)

        for jband in range(nband):
            logs.log(f"Band {jband}")
            ibegin, iend = _band_range(jband)
            sl = slice(ibegin, iend + 1)
            if jband in band_results:
                istatus, bounds, error, ng, eq = band_results[jband]
                kernel = gas_kernel
            else:
                kernel = _make_kernel(sl, band_albedo[jband] if do_sw
                                      else None)
                istatus, bounds, error, ng, eq = _search_band(jband,
                                                              kernel)

            logs.log(f"  Equipartition status: {istatus.describe()}")
            logs.log(f"      computational cost = {eq.total_comp_cost:.2f}")

            # ---- base_split dissection (ref :1268-1383) ----
            bwb_in_band = (len(base_wavenumber_boundary) > 0
                           and np.any(
                               (base_wavenumber_boundary > band_bound1[jband])
                               & (base_wavenumber_boundary
                                  < band_bound2[jband])))
            if base_split[jband] != 1.0 or bwb_in_band:
                bounds = list(bounds)
                error = list(error)
                if base_split[jband] > 1.0:
                    nabssplit = int(base_split[jband])
                    if nabssplit == 1:
                        raise ValueError("Positive values of base_split "
                                         "must be at least 2")
                else:
                    nabssplit = 2 + int(base_split[jband] * ng)

                in_band = ((base_wavenumber_boundary > band_bound1[jband])
                           & (base_wavenumber_boundary < band_bound2[jband]))
                nwavsplit = 1 + int(np.sum(in_band))
                wn_bound = np.empty(nwavsplit + 1)
                wn_bound[0] = band_bound1[jband]
                wn_bound[-1] = band_bound2[jband] + 1.0
                if nwavsplit > 1:
                    wn_bound[1:-1] = base_wavenumber_boundary[in_band]

                nsplit = nwavsplit * nabssplit
                logs.log(f"  Splitting base interval into {nsplit} pieces: "
                         f"{nwavsplit} by wavenumber * {nabssplit} by "
                         "absorption")
                iwav1 = np.zeros(nwavsplit, np.int64)
                iwav2 = np.zeros(nwavsplit, np.int64)
                iwav1[0] = ibegin
                iwav2[-1] = iend

                if nwavsplit > 1:
                    ind1 = eq.lower_index(bounds[0]) + ibegin
                    ind2 = eq.upper_index(bounds[1]) + ibegin
                    iwav1[0] = 0
                    irank_new = irank.copy()
                    for iws in range(nwavsplit):
                        if iws > 0:
                            iwav1[iws] = iwav2[iws - 1] + 1
                        sel = ((wavenumber_cm_1 >= wn_bound[iws])
                               & (wavenumber_cm_1 < wn_bound[iws + 1])
                               & (irank[ireorder] <= ind2))
                        idx = np.nonzero(sel)[0]
                        iwav2[iws] = iwav1[iws] + len(idx) - 1
                        irank_new[ireorder[idx]] = np.arange(
                            iwav1[iws], iwav2[iws] + 1)
                        logs.log(f"    Creating {wn_bound[iws]}-"
                                 f"{wn_bound[iws + 1]} cm-1 sub-band: "
                                 f"{len(idx)} spectral points")
                    if iwav2[-1] != ind2:
                        raise ValueError("Failed to account for all "
                                         "wavenumbers in split")
                    irank = irank_new
                    ireorder[irank] = np.arange(len(irank))
                    sorting_variable = sorting_variable[ireorder]
                    wavenumber_cm_1 = wavenumber_cm_1[ireorder]
                    if do_sw:
                        ssi_reorder = ssi[ireorder]

                upper_bound = bounds[1]
                lower_bound_local = bounds[0]
                error[0] = -1.0
                ibnd = 0
                for iws in range(nwavsplit):
                    upper_bound_local = (upper_bound * iwav2[iws]
                                         / float(iwav2[-1]))
                    for iabs in range(nabssplit):
                        if iabs < nabssplit - 1 or iws < nwavsplit - 1:
                            bounds.insert(
                                ibnd + 1, lower_bound_local
                                + (upper_bound_local - lower_bound_local)
                                * (iabs + 1) / float(nabssplit))
                            error.insert(ibnd, -1.0)
                            ibnd += 1
                    lower_bound_local = upper_bound_local
                ng += nsplit - 1
                bounds = np.asarray(bounds)
                error = np.asarray(error)

            bounds = np.asarray(bounds, np.float64)
            error = np.asarray(error, np.float64)
            if np.any(np.diff(bounds) <= 0.0):
                raise ValueError("Bounds are not monotonically increasing")

            n_g_points_per_band.append(ng)
            weight_for_median = surf_planck if not do_sw else ssi_reorder
            for ig in range(ng):
                ind1 = eq.lower_index(bounds[ig]) + ibegin
                ind2 = eq.upper_index(bounds[ig + 1]) + ibegin
                rank1_l.append(ind1)
                rank2_l.append(ind2)
                error_l.append(float(error[ig]))
                band_l.append(jband)
                median_l.append(calc_median_sorting_variable(
                    sorting_variable, weight_for_median, ind1, ind2))

            if debug_partition:
                # Re-evaluate the final partition and dump per-g-point
                # cost components to stderr (ref find_g_points.cpp:
                # 1416-1423; only the SW cost function emits components,
                # calc_cost_function_sw.cpp:93-105 — LW prints the band
                # header alone, matching the reference).
                print(f"debug_partition_{Gas}_band = {jband}",
                      file=sys.stderr)
                if do_sw:
                    i1d = np.asarray([eq.lower_index(b)
                                      for b in bounds[:-1]], np.int32)
                    i2d = np.asarray([eq.upper_index(b)
                                      for b in bounds[1:]], np.int32)
                    i2d = np.maximum(i1d, i2d)
                    comps = kernel.components(i1d, i2d,
                                              eq._seg_of_wav(i1d))
                    fmt = lambda v: np.array2string(
                        np.atleast_1d(v), max_line_width=10 ** 9,
                        separator=" ")
                    for ig in range(len(i1d)):
                        for tag, c in comps.items():
                            if len(comps) > 1:
                                print(f"  debug_partition_{tag}",
                                      file=sys.stderr)
                            for key in ("flux_dn_surf_true",
                                        "flux_dn_surf_fit",
                                        "flux_up_toa_true",
                                        "flux_up_toa_fit", "hr_true",
                                        "hr_fit", "cf_hr", "cf_flux"):
                                print(f"    debug_partition.{key} = "
                                      f"{fmt(np.asarray(c[key])[..., ig])}",
                                      file=sys.stderr)

        gas_data = SingleGasData(
            molecule=gas_str,
            n_g_points=np.asarray(n_g_points_per_band, np.int64),
            band_number=np.asarray(band_l, np.int32),
            rank1=np.asarray(rank1_l, np.int64),
            rank2=np.asarray(rank2_l, np.int64),
            error=np.asarray(error_l),
            sorting_variable=np.asarray(median_l))
        gas_data.store_g_points(irank)
        gas_data.print()
        single_gas_data.append(gas_data)
        logs.log("")

    ngas = len(single_gas_data)

    logs.log("*** COMPUTING SPECTRAL OVERLAP OF GASES")
    band_number = overlap_g_points(single_gas_data)
    ng = len(band_number)
    g_point = merged_g_point_map(single_gas_data, ng, nwav)

    # ---- Output (ref :1485-1661) ----
    logs.log(f"Writing {output}")
    w = NcWriter(output)
    nband = len(band_bound1)
    w.define_dimension("band", nband)
    if ng > 0:
        w.define_dimension("g_point", ng)
    for g in single_gas_data:
        w.define_dimension(f"{g.molecule}_g_point", g.ng())
    if nwav > 0:
        w.define_dimension("wavenumber", nwav)

    w.define_variable("n_gases", "int")
    w.write_long_name("Number of gases treated", "n_gases")
    w.write_comment('The gases are listed in the global attribute '
                    '"constituent_id".', "n_gases")
    w.define_variable("wavenumber1_band", "float", "band")
    w.write_long_name("Lower wavenumber bound of band", "wavenumber1_band")
    w.write_units("cm-1", "wavenumber1_band")
    w.define_variable("wavenumber2_band", "float", "band")
    w.write_long_name("Upper wavenumber bound of band", "wavenumber2_band")
    w.write_units("cm-1", "wavenumber2_band")
    w.define_variable("band_number", "short", "g_point")
    w.write_long_name("Band number of each g point", "band_number")

    if do_sw:
        w.define_variable("solar_irradiance", "float", "g_point")
        w.write_long_name("Solar irradiance across each g point",
                          "solar_irradiance")
        w.write_units("W m-2", "solar_irradiance")

    for g in single_gas_data:
        m, M = g.molecule, g.Molecule
        dim = f"{m}_g_point"
        w.define_variable(f"{m}_n_g_points", "int", "band")
        w.write_long_name(f"Number of g points for {M}", f"{m}_n_g_points")
        w.define_variable(f"{m}_band_number", "short", dim)
        w.write_long_name(f"Band number of each {M} g point",
                          f"{m}_band_number")
        w.define_variable(f"{m}_rank1", "int", dim)
        w.write_long_name(f"Rank of first wavenumber for {M}", f"{m}_rank1")
        w.define_variable(f"{m}_rank2", "int", dim)
        w.write_long_name(f"Rank of last wavenumber for {M}", f"{m}_rank2")
        w.define_variable(f"{m}_error", "float", dim)
        w.write_long_name(f"Root-mean-square heating-rate error for {M}",
                          f"{m}_error")
        w.write_units("K d-1", f"{m}_error")
        w.define_variable(f"{m}_sorting_variable", "float", dim)
        w.write_long_name(f"Median in g-point of variable used to sort {M} "
                          "spectrum", f"{m}_sorting_variable")
        if ng > 0:
            w.define_variable(f"{m}_g_min", "int", "g_point")
            w.write_long_name(f"Minimum {M} g point contributing to merged "
                              "g points", f"{m}_g_min")
            w.define_variable(f"{m}_g_max", "int", "g_point")
            w.write_long_name(f"Maximum {M} g point contributing to merged "
                              "g points", f"{m}_g_max")

    if nwav > 0:
        w.define_variable("wavenumber", "double", "wavenumber")
        w.write_long_name("Wavenumber", "wavenumber")
        w.write_units("cm-1", "wavenumber")
        w.define_variable("g_point", "short", "wavenumber")
        w.write_long_name("G point", "g_point")
        for g in single_gas_data:
            w.define_variable(f"{g.molecule}_g_point", "short", "wavenumber")
            w.write_long_name(f"{g.Molecule} g point", f"{g.molecule}_g_point")

    title = ("Definition of the spectral intervals of a shortwave CKD model"
             if do_sw else
             "Definition of the spectral intervals of a longwave CKD model")
    write_standard_attributes(w, title)
    w.write_attribute(" ".join(g.molecule for g in single_gas_data),
                      "constituent_id")
    w.append_history(argv or sys.argv)
    w.write_attribute(cfg.sprint(), "config")

    w.write(ngas, "n_gases")
    w.write(band_bound1, "wavenumber1_band")
    w.write(band_bound2, "wavenumber2_band")
    w.write(band_number, "band_number")
    if do_sw:
        solar_irradiance = np.zeros(ng)
        for ig in range(ng):
            solar_irradiance[ig] = ssi[g_point == ig].sum()
        nbad = int(np.sum(solar_irradiance <= 0.0))
        if nbad:
            logs.warning(f"{nbad} shortwave g points have zero solar "
                         "irradiance")
        w.write(solar_irradiance, "solar_irradiance")

    for g in single_gas_data:
        m = g.molecule
        w.write(np.asarray(g.n_g_points, np.int32), f"{m}_n_g_points")
        w.write(np.asarray(g.band_number, np.int16), f"{m}_band_number")
        w.write(np.asarray(g.rank1, np.int32), f"{m}_rank1")
        w.write(np.asarray(g.rank2, np.int32), f"{m}_rank2")
        w.write(g.error, f"{m}_error")
        w.write(g.sorting_variable, f"{m}_sorting_variable")
        if ng > 0:
            w.write(np.asarray(g.g_min, np.int32), f"{m}_g_min")
            w.write(np.asarray(g.g_max, np.int32), f"{m}_g_max")

    if nwav > 0:
        w.write(wavenumber_orig, "wavenumber")
        w.write(np.asarray(g_point, np.int16), "g_point")
        for g in single_gas_data:
            w.write(np.asarray(g.g_point, np.int16), f"{g.molecule}_g_point")
    w.close()
    return output


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from ..errors import run_tool
    return run_tool(
        lambda: find_g_points(tool_prologue(argv), argv=["find_g_points"] + argv),
        name="find_g_points")


if __name__ == "__main__":
    sys.exit(main())
