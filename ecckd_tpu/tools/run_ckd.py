"""run_ckd: evaluate a CKD model on scenario concentrations.

Equivalent of src/ecckd/run_ckd.cpp:26-373 — the "inference" path:
read a ckd-definition file and a scenario file of (temperature_hl,
pressure_hl, per-gas mole fractions), compute per-g-point optical depths by
LUT interpolation, run the two-stream RT, and write fluxes in the
CKDMIP-intercomparison format.  The per-column loop of the reference becomes
a single vmapped/jitted evaluation over all columns.

Usage: python -m ecckd_tpu.tools.run_ckd ckd_model=... input=... output=... \
       [gases="..."] [co2_scaling=X ...] [write_od_only=1] [tsi=1361] cfg
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from .. import logs
from ..config import Config
from ..constants import REFERENCE_COS_SZA
from ..io import NcFile, NcWriter, write_standard_attributes
from ..models import CkdModel, temperature_fl_from_hl
from .common import tool_prologue, read_string_list, find_file, setup_jax

SCALABLE_GASES = ("co2", "ch4", "n2o", "cfc11", "cfc12")


def run_ckd(cfg: Config, argv=()) -> str:
    jax = setup_jax(cfg)
    import jax.numpy as jnp
    from ..ops import rt_lw, rt_direct_sw

    ckd_file = find_file(cfg.read_string("ckd_model"))
    input_file = find_file(cfg.read_string("input"))
    output_file = cfg.read_string("output")
    gas_list = read_string_list(cfg, "gases")
    scalings = {g: cfg.read_float(f"{g}_scaling", default=-1.0)
                for g in SCALABLE_GASES}
    write_od_only = cfg.read_bool("write_od_only", default=False)
    tsi = cfg.read_float("tsi", default=1361.0)

    model = CkdModel.read(ckd_file)
    is_sw = model.is_sw()
    domain = "sw" if is_sw else "lw"
    tsi_scaling = tsi / model.solar_irradiance.sum() if is_sw else -1.0

    logs.log(f"Reading {input_file}")
    inp = NcFile(input_file)
    temperature_hl = np.asarray(inp.read("temperature_hl"), np.float64)
    pressure_hl = np.asarray(inp.read("pressure_hl"), np.float64)
    global_attrs = {k: inp.attribute(k, default="")
                    for k in ("experiment", "experiment_id",
                              "sub_experiment", "sub_experiment_id")}

    temperature_fl = np.asarray(
        temperature_fl_from_hl(pressure_hl, temperature_hl))
    temperature_surf = temperature_hl[:, -1]

    ncol, nlev1 = temperature_hl.shape
    nlay = nlev1 - 1
    ng = model.ng

    if not is_sw:
        planck_hl = np.asarray(model.calc_planck_function(temperature_hl))
        planck_surf = np.asarray(model.calc_planck_function(temperature_surf))

    logs.log(f"Writing {output_file}")
    w = NcWriter(output_file)
    w.define_dimension("column", ncol)
    w.define_dimension("level", nlay)
    w.define_dimension("half_level", nlay + 1)
    w.define_dimension("g_point", ng)

    w.define_variable("pressure_hl", "float", "column", "half_level")
    w.write_long_name("Pressure", "pressure_hl")
    w.write_units("Pa", "pressure_hl")

    w.define_variable("optical_depth", "float", "column", "level", "g_point")
    if is_sw:
        w.write_long_name("Layer optical depth due to molecular absorption",
                          "optical_depth")
    else:
        w.write_long_name("Layer optical depth", "optical_depth")

    if not write_od_only:
        for molecule in model.molecules:
            w.define_variable(f"{molecule}_optical_depth", "float",
                              "column", "level", "g_point")
            w.write_long_name(f"{molecule} optical depth",
                              f"{molecule}_optical_depth")

    if not is_sw:
        w.define_variable("planck_hl", "float", "column", "half_level",
                          "g_point")
        w.write_long_name("Planck function", "planck_hl")
        w.write_units("W m-2", "planck_hl")
    else:
        w.define_variable("incoming_sw", "float", "column", "g_point")
        w.write_long_name("Incoming shortwave flux at top-of-atmosphere in "
                          "direction of sun", "incoming_sw")
        w.write_units("W m-2", "incoming_sw")
        w.define_variable("rayleigh_optical_depth", "float", "column",
                          "level", "g_point")
        w.write_long_name("Layer optical depth due to Rayleigh scattering",
                          "rayleigh_optical_depth")

    if not write_od_only:
        if not is_sw:
            w.define_variable("planck_surf", "float", "column", "g_point")
            w.write_long_name("Planck function at surface", "planck_surf")
            w.write_units("W m-2", "planck_surf")
            w.define_variable(f"spectral_flux_up_{domain}", "float",
                              "column", "half_level", "g_point")
            w.write_long_name("Spectral upwelling longwave flux",
                              f"spectral_flux_up_{domain}")
            w.write_units("W m-2", f"spectral_flux_up_{domain}")
            w.define_variable(f"spectral_flux_dn_{domain}", "float",
                              "column", "half_level", "g_point")
            w.write_long_name("Spectral downwelling longwave flux",
                              f"spectral_flux_dn_{domain}")
            w.write_units("W m-2", f"spectral_flux_dn_{domain}")
            w.define_variable(f"flux_up_{domain}", "float", "column",
                              "half_level")
            w.write_long_name("Upwelling longwave flux", f"flux_up_{domain}")
            w.write_units("W m-2", f"flux_up_{domain}")
            w.define_variable(f"flux_dn_{domain}", "float", "column",
                              "half_level")
            w.write_long_name("Downwelling longwave flux",
                              f"flux_dn_{domain}")
            w.write_units("W m-2", f"flux_dn_{domain}")
        else:
            w.define_variable(f"spectral_flux_dn_direct_{domain}", "float",
                              "column", "half_level", "g_point")
            w.write_long_name("Spectral downwelling direct shortwave flux",
                              f"spectral_flux_dn_direct_{domain}")
            w.write_units("W m-2", f"spectral_flux_dn_direct_{domain}")
            w.define_variable(f"flux_dn_direct_{domain}", "float", "column",
                              "half_level")
            w.write_long_name("Downwelling direct shortwave flux",
                              f"flux_dn_direct_{domain}")
            w.write_units("W m-2", f"flux_dn_direct_{domain}")

    write_standard_attributes(
        w, "Spectral optical depth from ecCKD gas optics scheme")
    if model.model_id:
        w.write_attribute(model.model_id, "model_id")
    w.append_history(argv or sys.argv)
    for k, v in global_attrs.items():
        if v:
            w.write_attribute(v, k)

    w.write(pressure_hl, "pressure_hl")

    # Accumulate od over gases (jit-compiled interpolation per gas)
    od = np.zeros((ncol, nlay, ng))
    for igas, molecule in enumerate(model.molecules):
        if gas_list and molecule not in gas_list:
            logs.log(f"  Skipping {molecule}")
            continue
        var_name = f"{molecule}_mole_fraction_fl"
        if not inp.exist(var_name):
            logs.log(f"  Computing optical depth of {molecule} assuming no "
                     "concentration dependence")
            od_gas = np.asarray(model.calc_optical_depth(
                igas, pressure_hl, temperature_fl))
        else:
            vmr = np.asarray(inp.read(var_name), np.float64)
            scale = scalings.get(molecule, -1.0)
            if scale is not None and scale >= 0.0:
                vmr = vmr * scale
                logs.log(f"  Computing optical depth of {molecule} from "
                         f"concentration scaled by {scale}")
            else:
                logs.log(f"  Computing optical depth of {molecule}")
            od_gas = np.asarray(model.calc_optical_depth(
                igas, pressure_hl, temperature_fl, vmr))
        od += od_gas
        if not write_od_only:
            w.write(od_gas, f"{molecule}_optical_depth")

    od = np.maximum(od, 0.0)
    w.write(od, "optical_depth")

    if is_sw:
        rayleigh_od = np.asarray(
            model.calc_rayleigh_optical_depth(pressure_hl))
        w.write(rayleigh_od, "rayleigh_optical_depth")
        w.write(np.broadcast_to(model.solar_irradiance * tsi_scaling,
                                (ncol, ng)), "incoming_sw")
    else:
        w.write(planck_hl, "planck_hl")
        if not write_od_only:
            w.write(planck_surf, "planck_surf")

    if not write_od_only:
        if not is_sw:
            surf_emissivity = jnp.ones(ng)

            @jax.jit
            def all_fluxes(planck_hl_, od_, planck_surf_):
                return jax.vmap(
                    lambda p, o, s: rt_lw(p, o, surf_emissivity, s)
                )(planck_hl_, od_, planck_surf_)

            flux_dn, flux_up = all_fluxes(
                jnp.asarray(planck_hl), jnp.asarray(od),
                jnp.asarray(planck_surf))
            flux_dn, flux_up = np.asarray(flux_dn), np.asarray(flux_up)
            w.write(flux_up, f"spectral_flux_up_{domain}")
            w.write(flux_dn, f"spectral_flux_dn_{domain}")
            w.write(flux_up.sum(-1), f"flux_up_{domain}")
            w.write(flux_dn.sum(-1), f"flux_dn_{domain}")
        else:
            ssi_g = jnp.asarray(tsi_scaling * model.solar_irradiance)

            @jax.jit
            def all_fluxes(od_):
                return jax.vmap(
                    lambda o: rt_direct_sw(REFERENCE_COS_SZA, ssi_g, o)
                )(od_)

            flux_dn = np.asarray(all_fluxes(jnp.asarray(od + rayleigh_od)))
            w.write(flux_dn, f"spectral_flux_dn_direct_{domain}")
            w.write(flux_dn.sum(-1), f"flux_dn_direct_{domain}")

    inp.close()
    w.close()
    return output_file


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from ..errors import run_tool
    return run_tool(
        lambda: run_ckd(tool_prologue(argv), argv=["run_ckd"] + argv),
        name="run_ckd")


if __name__ == "__main__":
    sys.exit(main())
