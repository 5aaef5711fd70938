"""lw_spectra: generate LBL longwave benchmark fluxes.

Equivalent of src/ecckd/lw_spectra.cpp:25-272: for every profile
of a merged-spectra config, compute the Planck function and spectral LW
radiative transfer, writing fluxes at full spectral resolution or collapsed
to g-points; the column dimension is unlimited for concatenation.
"""

from __future__ import annotations

import sys

import numpy as np

from .. import logs
from ..config import Config
from ..io import NcFile, NcWriter
from ..io.spectrum import open_merged_spectrum_profile
from ..ops.average import gpoint_block_partials, finalize_gpoint_partials
from .common import tool_prologue, find_file, setup_jax


def _gpoint_profile_blockwise(pb, g_point, ng, planck_function, rt_lw,
                              block_wav):
    """One profile's broadband + g-point-collapsed fluxes and averaged od,
    streamed in wavenumber blocks (full spectral flux arrays never exist;
    the per-wavenumber RT is independent, so blocks reproduce the dense
    evaluation bitwise).  Reads run one block ahead (io.prefetch)."""
    import jax
    from ..io.prefetch import prefetch_iter
    from ..ops.streaming import _combine

    nlay = pb.nlay
    onehot_cols = np.arange(ng)
    flux_dn = np.zeros(nlay + 1)
    flux_up = np.zeros(nlay + 1)
    fd_g = np.zeros((nlay + 1, ng))
    fu_g = np.zeros((nlay + 1, ng))
    acc = None
    pressure_fl = 0.5 * (pb.pressure_hl[:-1] + pb.pressure_hl[1:])
    t_x_p = pb.temperature_hl * pb.pressure_hl
    temperature_fl = 0.5 * (t_x_p[:-1] + t_x_p[1:]) / pressure_fl
    for i0, od_blk in prefetch_iter(pb.iter_blocks(block_wav=block_wav),
                                    depth=2):
        nb = od_blk.shape[1]
        sl = slice(i0, i0 + nb)
        pblk = np.asarray(planck_function(
            pb.temperature_hl, pb.wavenumber[sl], pb.d_wavenumber[sl]))
        fd, fu = rt_lw(pblk, od_blk, np.ones(nb), pblk[-1])
        fd, fu = np.asarray(fd), np.asarray(fu)
        flux_dn += fd.sum(1)
        flux_up += fu.sum(1)
        onehot = (g_point[sl][:, None] == onehot_cols[None, :]).astype(
            np.float64)
        fd_g += fd @ onehot
        fu_g += fu @ onehot
        planck_fl = np.asarray(planck_function(
            temperature_fl, pb.wavenumber[sl], pb.d_wavenumber[sl]))
        part = jax.device_get(gpoint_block_partials(
            ng, g_point[sl], od_blk, planck_fl, "transmission"))
        acc = part if acc is None else _combine(acc, part)
    od_g, _, _ = finalize_gpoint_partials(acc, "transmission")
    return flux_dn, flux_up, fd_g, fu_g, np.asarray(od_g)


def lw_spectra(cfg: Config, argv=()) -> str:
    setup_jax(cfg)
    from ..ops import planck_function, rt_lw
    import jax

    output = cfg.read_string("output")
    g_point = None
    ng = -1
    gpoint_file = cfg.read_string("gpoints", default=None)
    if gpoint_file:
        f = NcFile(find_file(gpoint_file))
        g_point = np.asarray(f.read("g_point"), np.int64)
        ng = int(g_point.max()) + 1
        f.close()
    have_gpoints = g_point is not None

    iprofile = cfg.read_int("iprofile", default=None)
    do_one_profile = iprofile is not None
    block_wav = cfg.read_int("streaming_block_wav", default=1 << 20)

    ncol = 10000
    icol = iprofile if do_one_profile else 0
    is_first = True
    w = NcWriter(output)
    iout = 0

    while icol < ncol:
        logs.log(f"Profile {icol}")
        src = open_merged_spectrum_profile(cfg, icol, "")
        ncol = src.ncol
        nlay, nwav = src.nlay, src.nwav
        sp = src if have_gpoints else src.materialize()

        if is_first:
            is_first = False
            w.define_dimension("column", None)    # unlimited for ncrcat
            w.define_dimension("level", nlay)
            w.define_dimension("half_level", nlay + 1)
            if not have_gpoints:
                spec_name = "wavenumber"
                w.define_dimension(spec_name, nwav)
            else:
                spec_name = "g_point"
                w.define_dimension(spec_name, ng)
            ngas = sp.vmr_fl.shape[0]
            w.define_dimension("gas", ngas)

            w.define_variable("pressure_hl", "float", "column", "half_level")
            w.write_long_name("Pressure at half levels", "pressure_hl")
            w.write_units("Pa", "pressure_hl")
            w.define_variable("temperature_hl", "float", "column",
                              "half_level")
            w.write_long_name("Temperature at half levels", "temperature_hl")
            w.write_units("K", "temperature_hl")
            if not have_gpoints:
                w.define_variable("wavenumber", "double", "wavenumber")
                w.write_long_name("Wavenumber", "wavenumber")
                w.write_units("cm-1", "wavenumber")
            w.define_variable("vmr_fl", "float", "column", "gas", "level")
            w.write_long_name("Volume mixing ratio", "vmr_fl")
            w.write_units("mol mol-1", "vmr_fl")
            w.define_variable("flux_dn_lw", "float", "column", "half_level")
            w.write_long_name("Downwelling longwave flux", "flux_dn_lw")
            w.write_units("W m-2", "flux_dn_lw")
            w.define_variable("flux_up_lw", "float", "column", "half_level")
            w.write_long_name("Upwelling longwave flux", "flux_up_lw")
            w.write_units("W m-2", "flux_up_lw")
            w.define_variable("optical_depth", "float", "column", "level",
                              spec_name)
            w.write_long_name("Layer optical depth", "optical_depth")
            w.define_variable("spectral_flux_dn_lw", "float", "column",
                              "half_level", spec_name)
            w.write_long_name("Downwelling longwave spectral flux",
                              "spectral_flux_dn_lw")
            w.write_units("W m-2", "spectral_flux_dn_lw")
            w.define_variable("spectral_flux_up_lw", "float", "column",
                              "half_level", spec_name)
            w.write_long_name("Upwelling longwave spectral flux",
                              "spectral_flux_up_lw")
            w.write_units("W m-2", "spectral_flux_up_lw")
            w.append_history(argv or sys.argv)
            w.write_attribute(sp.molecule.replace(",", " "), "molecules")
            w.write_attribute(cfg.sprint(), "config")
            w.end_define()    # each column goes to disk as it is done
            if not have_gpoints:
                w.write(sp.wavenumber, "wavenumber")

        w.write(sp.pressure_hl, "pressure_hl", index=iout)
        w.write(sp.temperature_hl, "temperature_hl", index=iout)
        w.write(sp.vmr_fl, "vmr_fl", index=iout)

        if not have_gpoints:
            logs.log("  Computing Planck function")
            planck_hl = np.asarray(planck_function(
                sp.temperature_hl, sp.wavenumber, sp.d_wavenumber))
            logs.log("  Performing longwave radiative transfer")
            fd, fu = rt_lw(planck_hl, sp.optical_depth,
                           np.ones(nwav), planck_hl[-1])
            fd, fu = np.asarray(fd), np.asarray(fu)
            w.write(fd.sum(1), "flux_dn_lw", index=iout)
            w.write(fu.sum(1), "flux_up_lw", index=iout)
            w.write(sp.optical_depth, "optical_depth", index=iout)
            w.write(fd, "spectral_flux_dn_lw", index=iout)
            w.write(fu, "spectral_flux_up_lw", index=iout)
        else:
            # Blockwise: collapsing to g-points needs no full spectral
            # flux arrays (ref lw_spectra.cpp holds them dense; at CKDMIP
            # scale those are ~GBs per profile)
            logs.log("  Planck + longwave RT in wavenumber blocks")
            flux_dn, flux_up, fd_g, fu_g, od_g = _gpoint_profile_blockwise(
                src, g_point, ng, planck_function, rt_lw, block_wav)
            w.write(flux_dn, "flux_dn_lw", index=iout)
            w.write(flux_up, "flux_up_lw", index=iout)
            w.write(od_g, "optical_depth", index=iout)
            w.write(fd_g, "spectral_flux_dn_lw", index=iout)
            w.write(fu_g, "spectral_flux_up_lw", index=iout)
        src.close()

        if do_one_profile:
            break
        icol += 1
        iout += 1
    w.close()
    return output


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from ..errors import run_tool
    return run_tool(
        lambda: lw_spectra(tool_prologue(argv), argv=["lw_spectra"] + argv),
        name="lw_spectra")


if __name__ == "__main__":
    sys.exit(main())
