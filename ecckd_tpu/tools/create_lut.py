"""create_lut: build a raw CKD look-up table from the Idealized dataset.

Equivalent of src/ecckd/create_look_up_table.cpp:27-606: average
line-by-line optical depths of each gas into each g-point (several averaging
methods) over a grid of temperature profiles and concentrations, producing a
ckd-definition file with min/max absorption bounds, the gpoint_fraction
spectral mapping, and the Planck LUT (LW) or per-g solar irradiance +
Rayleigh coefficients (SW).  The OpenMP-over-g loops (P2/P3) become matmul
segment reductions (ops.average.average_od_to_gpoints).
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np

from .. import logs
from ..config import Config
from ..io import NcFile
from ..io.spectrum import (open_merged_spectrum_profile,
                           open_spectrum_profile)
from ..models import CkdModel, GasData, ConcDependence
from ..ops.average import average_od_to_gpoints, od_to_molar_abs
from .common import tool_prologue, read_string_list, find_file, setup_jax

_CONC_DEPENDENCE = {
    "none": ConcDependence.NONE,
    "linear": ConcDependence.LINEAR,
    "lut": ConcDependence.LUT,
    "relative-linear": ConcDependence.RELATIVE_LINEAR,
}


class _Execution:
    """Per-run choice of averaging execution path.

    ``streaming``: "auto" streams wavenumber blocks from disk when one
    profile's od + weight exceeds ``streaming_memory_mb`` (the reference
    streams one profile at a time for the same reason,
    create_look_up_table.cpp:242-298; CKDMIP spectra are ~5.6M wavenumbers
    so the full array cannot be resident).  ``sharded``: "auto" engages the
    wavenumber-sharded mesh reduction (parallel.sharded_average) when more
    than one device is attached.  The two COMPOSE: with both engaged, each
    streamed block is sharded over the mesh and reduced with
    psum/pmin/pmax, and the tiny per-g partials accumulate on host
    (parallel.streaming_sharded_average_od_to_gpoints) — the execution for
    spectra too large even for a pod slice's combined HBM.
    """

    def __init__(self, cfg: Config):
        self.streaming = str(cfg.read_string("streaming",
                                             default="auto")).lower()
        self.block_wav = cfg.read_int("streaming_block_wav",
                                      default=1 << 20)
        self.memory_mb = cfg.read_float("streaming_memory_mb",
                                        default=1024.0)
        self.sharded = str(cfg.read_string("sharded",
                                           default="auto")).lower()
        self._mesh = None

    def use_streaming(self, nlay: int, nwav: int) -> bool:
        if self.streaming in ("1", "yes", "true"):
            return True
        if self.streaming in ("0", "no", "false"):
            return False
        return 2.0 * 8.0 * nlay * nwav > self.memory_mb * 1.0e6

    def mesh(self):
        """A spectral mesh over all devices, or None for 1 device/off."""
        if self.sharded in ("0", "no", "false"):
            return None
        if self._mesh is None:
            import jax
            if jax.device_count() < 2:
                return None
            from ..parallel import make_mesh
            self._mesh = make_mesh(data_parallel=1)
        return self._mesh


def _average_profile(ng, g_point, optical_depth, weight, averaging_method,
                     pressure_fl, pressure_hl, reference_surface_vmr,
                     mesh=None):
    """One temperature profile -> (molar_abs, min, max), each (nlay, ng)."""
    if mesh is not None:
        from ..parallel import sharded_average_od_to_gpoints
        fit, mn, mx = sharded_average_od_to_gpoints(
            mesh, ng, g_point, optical_depth, weight, averaging_method,
            pressure_fl=pressure_fl)
    else:
        fit, mn, mx = average_od_to_gpoints(
            ng, g_point, optical_depth, weight, averaging_method,
            pressure_fl=pressure_fl)
    k = od_to_molar_abs(fit, pressure_hl, reference_surface_vmr)
    kmin = od_to_molar_abs(mn, pressure_hl, reference_surface_vmr)
    kmax = od_to_molar_abs(mx, pressure_hl, reference_surface_vmr)
    return np.asarray(k), np.asarray(kmin), np.asarray(kmax)


def _average_profile_streaming(ng, g_point, blocks, weight_fn,
                               averaging_method, pressure_fl, pressure_hl,
                               reference_surface_vmr, block_wav, mesh=None):
    """Streaming form: blocks is a ProfileBlocks; weight_fn(iwav0, nb).
    With ``mesh`` the two execution axes compose: each streamed block is
    sharded over the mesh and psum-reduced (create_look_up_table.cpp:242-340
    is the host-streaming original; the mesh reduction is this framework's
    scaling axis on top of it)."""
    if mesh is not None:
        from ..parallel import streaming_sharded_average_od_to_gpoints
        fit, mn, mx = streaming_sharded_average_od_to_gpoints(
            mesh, blocks, ng, g_point, weight_fn, averaging_method,
            block_wav=block_wav, pressure_fl=pressure_fl)
    else:
        from ..ops.streaming import streaming_average_od_to_gpoints
        fit, mn, mx = streaming_average_od_to_gpoints(
            blocks, ng, g_point, weight_fn, averaging_method,
            block_wav=block_wav, pressure_fl=pressure_fl)
    k = od_to_molar_abs(fit, pressure_hl, reference_surface_vmr)
    kmin = od_to_molar_abs(mn, pressure_hl, reference_surface_vmr)
    kmax = od_to_molar_abs(mx, pressure_hl, reference_surface_vmr)
    return np.asarray(k), np.asarray(kmin), np.asarray(kmax)


def _planck_weight(temperature_fl, wavenumber, d_wavenumber):
    from ..ops import planck_function
    return np.asarray(planck_function(temperature_fl, wavenumber,
                                      d_wavenumber))


def _gpoint_fraction(ng, g_point, wavenumber, d_wavenumber, wavenumber1,
                     wavenumber2):
    """Fraction of each g-point's spectrum in fixed wavenumber intervals
    (ref create_look_up_table.cpp:516-548), via a 2-D histogram."""
    nint = len(wavenumber1)
    dwav = wavenumber1[1] - wavenumber1[0] if nint > 1 \
        else wavenumber2[0] - wavenumber1[0]
    # Interval such that wavenumber1 < wn <= wavenumber2
    ibin = np.ceil((wavenumber - wavenumber1[0]) / dwav).astype(np.int64) - 1
    ibin = np.clip(ibin, -1, nint - 1)
    valid = (g_point >= 0) & (ibin >= 0)
    frac = np.zeros((ng, nint))
    np.add.at(frac, (g_point[valid], ibin[valid]), d_wavenumber[valid])
    per_g = np.zeros(ng)
    np.add.at(per_g, g_point[valid], d_wavenumber[valid])
    per_g[per_g == 0.0] = 1.0
    return frac / per_g[:, None]


def create_lut(cfg: Config, argv=()) -> str:
    setup_jax(cfg)
    output = cfg.read_string("output")
    input_file = find_file(cfg.read_string("input"))
    base_wavenumber_boundary = np.asarray(
        cfg.read_floats("base_wavenumber_boundary", default=None) or [])

    ssi = tsi = None
    ssi_wavenumber = None
    do_sw = False
    ssi_file_name = cfg.read_string("ssi", default=None)
    if ssi_file_name:
        f = NcFile(find_file(ssi_file_name))
        ssi = np.asarray(f.read("solar_spectral_irradiance"), np.float64)
        tsi = float(f.read_scalar("total_solar_irradiance"))
        ssi_wavenumber = np.asarray(f.read("wavenumber"), np.float64)
        f.close()
        do_sw = True

    logs.log(f"Reading {input_file}")
    gf = NcFile(input_file)
    if not gf.exist("g_point"):
        raise ValueError(f'"g_point" not found in "{input_file}"')
    g_point = np.asarray(gf.read("g_point"), np.int64)
    band_wn1 = np.asarray(gf.read("wavenumber1_band"), np.float64)
    band_wn2 = np.asarray(gf.read("wavenumber2_band"), np.float64)
    band_number = np.asarray(gf.read("band_number"), np.int64)
    solar_irradiance = None
    is_sw = gf.exist("solar_irradiance")
    if is_sw:
        solar_irradiance = np.asarray(gf.read("solar_irradiance"),
                                      np.float64)
    input_history = gf.attribute("history", default="") or ""
    input_config = gf.attribute("config", default="") or ""
    wavenumber_hr = (np.asarray(gf.read("wavenumber"), np.float64)
                     if gf.exist("wavenumber") else None)
    gf.close()

    ng = int(g_point.max()) + 1

    # ---- Remove empty g-points (ref :111-160) ----
    counts = np.bincount(g_point[g_point >= 0], minlength=ng)
    bad = np.nonzero(counts == 0)[0]
    changed_g = False
    if len(bad) > 0:
        logs.log(f"Removing {len(bad)} g point(s) that occupy none of the "
                 "spectrum")
        keep = np.nonzero(counts > 0)[0]
        remap = np.full(ng, -1, np.int64)
        remap[keep] = np.arange(len(keep))
        new_g_point = np.where(g_point >= 0, remap[g_point], -1)
        if np.any(new_g_point < 0):
            raise ValueError("Some unassigned spectral points after mapping")
        g_point = new_g_point
        band_number = band_number[keep]
        if is_sw:
            solar_irradiance = solar_irradiance[keep]
        ng = len(keep)
        changed_g = True

    # ---- Optional base-g-point split by wavenumber (ref :162-224) ----
    if len(base_wavenumber_boundary) > 0:
        if wavenumber_hr is None:
            wavenumber_hr = ssi_wavenumber
        for iband in range(len(band_wn1)):
            in_band = ((base_wavenumber_boundary > band_wn1[iband])
                       & (base_wavenumber_boundary < band_wn2[iband]))
            nsplit = int(np.sum(in_band))
            if nsplit == 0:
                continue
            logs.log(f"Splitting base g-point of band {iband} into "
                     f"{nsplit + 1}")
            ig = int(np.nonzero(band_number == iband)[0].min())
            new_ng = ng + nsplit
            new_band_number = np.empty(new_ng, np.int64)
            new_band_number[:ig + 1] = band_number[:ig + 1]
            new_band_number[ig + 1:ig + nsplit + 1] = iband
            new_band_number[ig + nsplit + 1:] = band_number[ig + 1:]
            new_g_point = np.where(g_point > ig, g_point + nsplit, g_point)
            new_bounds = np.concatenate(
                [[band_wn1[iband]], base_wavenumber_boundary[in_band],
                 [band_wn2[iband]]])
            for k in range(nsplit + 1):
                sel = ((g_point == ig)
                       & (wavenumber_hr >= new_bounds[k])
                       & (wavenumber_hr < new_bounds[k + 1]))
                new_g_point[sel] = ig + k
            if is_sw:
                new_si = np.empty(new_ng)
                new_si[:max(ig, 0)] = solar_irradiance[:max(ig, 0)]
                new_si[ig + nsplit + 1:] = solar_irradiance[ig + 1:]
                for k in range(nsplit + 1):
                    new_si[ig + k] = ssi[new_g_point == ig + k].sum()
                solar_irradiance = new_si
            band_number = new_band_number
            g_point = new_g_point
            ng = new_ng
            changed_g = True

    temperature_stride = cfg.read_int("temperature_stride", default=1)
    averaging_method = cfg.read_string("averaging_method",
                                       default="transmission")
    execution = _Execution(cfg)

    single_gas_data: List[GasData] = []
    pressure_fl = None
    pressure_hl_save = None
    temperature_fl = None
    wavenumber_cm_1 = None
    d_wavenumber_cm_1 = None

    for gas_str in read_string_list(cfg, "gases"):
        Gas = gas_str.upper()
        logs.log(f"Creating look-up table for {Gas}")
        logs.log(f"  Averaging method = {averaging_method}")
        cd_str = cfg.read_string(f"{gas_str}.conc_dependence", default=None)
        if cd_str is None:
            raise ValueError(f"{gas_str}.conc_dependence not found in "
                             "configuration")
        if cd_str not in _CONC_DEPENDENCE:
            raise ValueError(f'conc_dependence "{cd_str}" not understood')
        gas = GasData(gas_str, _CONC_DEPENDENCE[cd_str])

        def process_profiles(open_one):
            """Loop over temperature profiles, averaging each to g-points.

            ``open_one(iprof)`` returns (ProfileBlocks, ref_vmr); the
            execution policy decides per profile whether to stream
            wavenumber blocks from disk, shard the dense reduction over a
            device mesh, or run the single-device dense path.
            """
            nonlocal pressure_fl, temperature_fl, wavenumber_cm_1, \
                d_wavenumber_cm_1, pressure_hl_save
            ncol = 1
            icol = 0
            k_l, kmin_l, kmax_l, t_l = [], [], [], []
            while icol < ncol:
                pb, ref_vmr = open_one(icol * temperature_stride)
                ncol = (pb.ncol + temperature_stride - 1) // temperature_stride
                pressure_hl = pb.pressure_hl
                if pressure_fl is None:
                    pressure_fl = 0.5 * (pressure_hl[:-1] + pressure_hl[1:])
                    pressure_hl_save = pressure_hl
                wavenumber_cm_1 = pb.wavenumber
                d_wavenumber_cm_1 = pb.d_wavenumber
                t_x_p = pb.temperature_hl * pressure_hl
                t_fl = 0.5 * (t_x_p[:-1] + t_x_p[1:]) / pressure_fl
                t_l.append(t_fl)
                if execution.use_streaming(pb.nlay, pb.nwav):
                    if icol == 0:
                        logs.log(f"  Streaming {pb.nwav} wavenumbers in "
                                 f"blocks of {execution.block_wav}")
                    if do_sw:
                        def weight_fn(i0, nb):
                            return ssi[i0:i0 + nb]
                    else:
                        def weight_fn(i0, nb):
                            return _planck_weight(
                                t_fl, pb.wavenumber[i0:i0 + nb],
                                pb.d_wavenumber[i0:i0 + nb])
                    k, kmin, kmax = _average_profile_streaming(
                        ng, g_point, pb, weight_fn, averaging_method,
                        pressure_fl, pressure_hl, ref_vmr,
                        execution.block_wav, mesh=execution.mesh())
                else:
                    sp = pb.materialize()
                    if not do_sw:
                        weight = _planck_weight(t_fl, sp.wavenumber,
                                                sp.d_wavenumber)
                    else:
                        weight = np.broadcast_to(ssi, sp.optical_depth.shape)
                    k, kmin, kmax = _average_profile(
                        ng, g_point, sp.optical_depth, weight,
                        averaging_method, pressure_fl, pressure_hl, ref_vmr,
                        mesh=execution.mesh())
                pb.close()
                k_l.append(k); kmin_l.append(kmin); kmax_l.append(kmax)
                icol += 1
            return (np.stack(k_l), np.stack(kmin_l), np.stack(kmax_l),
                    np.stack(t_l))

        if gas.conc_dependence == ConcDependence.NONE:
            def open_one(iprof):
                return open_merged_spectrum_profile(
                    cfg, iprof, f"{gas_str}."), 1.0
            k, kmin, kmax, t_fl = process_profiles(open_one)
            with open_merged_spectrum_profile(cfg, 0, f"{gas_str}.") as pb0:
                gas.composite_molecules = pb0.molecule
                gas.composite_vmr = pb0.vmr_fl
            gas.molar_abs, gas.min_molar_abs, gas.max_molar_abs = \
                k, kmin, kmax
            temperature_fl = t_fl
        elif gas.conc_dependence in (ConcDependence.LINEAR,
                                     ConcDependence.RELATIVE_LINEAR):
            file_name = find_file(cfg.read_string(f"{gas_str}.input"))
            if gas.conc_dependence == ConcDependence.RELATIVE_LINEAR:
                ref_conc = cfg.read_float(f"{gas_str}.reference_conc",
                                          default=None)
                if ref_conc is None:
                    raise ValueError(
                        f"{gas_str}.reference_conc must be provided if "
                        "conc_dependence is relative-linear")
                gas.reference_vmr = ref_conc

            def open_one(iprof):
                pb = open_spectrum_profile(file_name, iprof)
                return pb, pb.reference_surface_vmr
            k, kmin, kmax, t_fl = process_profiles(open_one)
            gas.molar_abs, gas.min_molar_abs, gas.max_molar_abs = \
                k, kmin, kmax
            temperature_fl = t_fl
        else:   # LUT over concentrations
            files = read_string_list(cfg, f"{gas_str}.input")
            k_c, kmin_c, kmax_c = [], [], []
            vmrs = []
            for file_name in files:
                file_name = find_file(file_name)

                def open_one(iprof):
                    pb = open_spectrum_profile(file_name, iprof)
                    if pb.reference_surface_vmr < 0.0:
                        raise ValueError(
                            "Invalid reference_surface_vmr for constructing "
                            "VMR-dependent look-up table")
                    return pb, pb.reference_surface_vmr
                k, kmin, kmax, t_fl = process_profiles(open_one)
                with open_spectrum_profile(file_name, 0) as pb0:
                    vmrs.append(pb0.reference_surface_vmr)
                k_c.append(k); kmin_c.append(kmin); kmax_c.append(kmax)
            gas.molar_abs = np.stack(k_c)
            gas.min_molar_abs = np.stack(kmin_c)
            gas.max_molar_abs = np.stack(kmax_c)
            gas.vmr = np.asarray(vmrs)
            temperature_fl = t_fl

        single_gas_data.append(gas)

    # ---- gpoint_fraction on the fixed interval grid (ref :507-548) ----
    logs.log("Computing fraction of spectrum contributing to each g-point")
    dwav = 50 if do_sw else 10
    startwav = int(np.floor(band_wn1.min() / dwav) * dwav)
    endwav = int(np.ceil(band_wn2.max() / dwav) * dwav)
    logs.log(f"  using wavenumber grid {startwav}-{endwav} cm-1 with "
             f"{dwav} cm-1 intervals")
    wavenumber1 = dwav * np.arange(startwav // dwav, endwav // dwav,
                                   dtype=np.float64)
    wavenumber2 = wavenumber1 + dwav
    gpoint_fraction = _gpoint_fraction(ng, g_point, wavenumber_cm_1,
                                       d_wavenumber_cm_1, wavenumber1,
                                       wavenumber2)

    logs.log(f"Writing {output}")
    config_str = cfg.sprint()
    argv = list(argv) or ["create_lut"] + list(sys.argv[1:])

    if is_sw:
        # Solar irradiance per fixed interval (ref :555-561)
        nint = len(wavenumber1)
        ibin = np.ceil((ssi_wavenumber - wavenumber1[0])
                       / dwav).astype(np.int64) - 1
        valid = (ibin >= 0) & (ibin < nint)
        ssi_intervals = np.zeros(nint)
        np.add.at(ssi_intervals, ibin[valid], ssi[valid])

        model = CkdModel(
            single_gas_data, pressure_fl, temperature_fl,
            wavenumber1, wavenumber2, gpoint_fraction,
            band_wn1, band_wn2, band_number,
            solar_irradiance=solar_irradiance, ssi=ssi_intervals,
            reference_total_solar_irradiance=tsi,
            history=input_history, config=input_config)
    else:
        logs.log("Generating Planck-function look-up table")
        from ..ops import planck_function
        import jax
        temperature_lut = np.arange(120.0, 351.0)
        nlut = len(temperature_lut)
        planck_lut = np.zeros((nlut, ng))
        # Chunk over temperatures to bound memory for large spectra
        # (~256 MB of f64 Planck values per chunk at CKDMIP scale)
        chunk = max(1, min(16, int(256.0e6 / (8 * len(wavenumber_cm_1)))))
        for i0 in range(0, nlut, chunk):
            t_chunk = temperature_lut[i0:i0 + chunk]
            pf = np.asarray(planck_function(t_chunk, wavenumber_cm_1,
                                            d_wavenumber_cm_1))
            seg = np.asarray(jax.ops.segment_sum(
                np.swapaxes(pf, 0, 1), g_point, num_segments=ng))
            planck_lut[i0:i0 + chunk] = np.swapaxes(seg, 0, 1)

        model = CkdModel(
            single_gas_data, pressure_fl, temperature_fl,
            wavenumber1, wavenumber2, gpoint_fraction,
            band_wn1, band_wn2, band_number,
            temperature_planck=temperature_lut, planck_function=planck_lut,
            history=input_history, config=input_config)

    if changed_g:
        model.wavenumber_hr = wavenumber_cm_1
        model.g_point = np.asarray(g_point, np.int32)
    model.write(output, argv=argv, config_str=config_str)
    return output


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from ..errors import run_tool
    return run_tool(
        lambda: create_lut(tool_prologue(argv), argv=["create_lut"] + argv),
        name="create_lut")


if __name__ == "__main__":
    sys.exit(main())
