"""optimize_lut: refine LUT coefficients by autodiff L-BFGS.

Equivalent of src/ecckd/optimize_lut.cpp:24-325, the north-star
workload: minimize a flux/heating-rate cost against line-by-line training
fluxes, with gradients from ``jax.value_and_grad`` through the two-stream
radiative transfer (replacing the Adept tape), a Markov-correlation prior,
bounded log-space minimization, and optional forcing (relative-to) mode.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

from .. import logs
from ..config import Config
from ..io import NcFile
from ..io.lbl_fluxes import LblFluxes
from ..models import CkdModel
from ..optimize import solve, MinimizerStatus
from ..optimize.cost_fn import make_total_od_fn, build_scene, MIN_X
from .common import (tool_prologue, read_string_list, find_file,
                     setup_jax, maybe_profile)


def _prepare_lbl(fluxes: LblFluxes, model: CkdModel,
                 max_no_rayleigh_wavenumber: float):
    """Shared per-scene setup (ref optimize_lut.cpp:204-288)."""
    fluxes.make_gas_mapping(model.molecules)
    if not model.is_sw():
        fluxes.planck_hl = np.asarray(
            model.calc_planck_function(fluxes.temperature_hl))
        fluxes.surf_planck = np.asarray(
            model.calc_planck_function(fluxes.temperature_hl[:, -1]))
    else:
        fluxes.solar_irradiance = model.solar_irradiance
    if fluxes.have_band_fluxes:
        fluxes.iband_per_g = model.iband_per_g(fluxes.band_wavenumber1,
                                               fluxes.band_wavenumber2)
    if model.is_sw():
        fluxes.mask_rayleigh_up(max_no_rayleigh_wavenumber)
    return fluxes


def _reference_od(model, lbl):
    """Optical depth of the current model for a scene (host-side helper
    used for relative-to fluxes)."""
    import jax.numpy as jnp
    scene, meta = build_scene(model, lbl)
    od_fn = make_total_od_fn(model, meta)
    from ..optimize.solver import log_state_tree
    tree = {k: jnp.asarray(v) for k, v in log_state_tree(model).items()}
    return np.asarray(od_fn(tree, scene))


def optimize_lut(cfg: Config, argv=()) -> int:
    setup_jax(cfg)
    input_file = find_file(cfg.read_string("input"))
    output_file = cfg.read_string("output")

    gas_list = read_string_list(cfg, "gases")
    logs.log("Optimizing coefficients of: "
             + (" ".join(gas_list) if gas_list else "ALL GASES"))

    flux_weight = cfg.read_float("flux_weight", default=0.02)
    flux_profile_weight = cfg.read_float("flux_profile_weight", default=0.0)
    broadband_weight = cfg.read_float("broadband_weight", default=0.5)
    spectral_boundary_weight = cfg.read_float("spectral_boundary_weight",
                                              default=0.0)
    erythemal_weight = cfg.read_float("erythemal_weight", default=0.0)
    pressure_weight_power = cfg.read_float("pressure_weight_power",
                                           default=0.5)
    prior_error = cfg.read_float("prior_error", default=-1.0)
    min_prior_error = cfg.read_float("min_prior_error", default=-1.0)
    max_prior_error = cfg.read_float("max_prior_error", default=-1.0)
    prior_error_scaling = cfg.read_float("prior_error_scaling", default=1.0)
    rayleigh_prior_error = cfg.read_float("rayleigh_prior_error",
                                          default=0.0)
    if rayleigh_prior_error > 0.0:
        logs.log("Optimizing Rayleigh scattering coefficients with prior "
                 f"error of {rayleigh_prior_error}")
        gas_list = gas_list + ["rayleigh"]
    temperature_corr = cfg.read_float("temperature_corr", default=0.5)
    pressure_corr = cfg.read_float("pressure_corr", default=0.5)
    conc_corr = cfg.read_float("conc_corr", default=0.5)
    convergence_criterion = cfg.read_float("convergence_criterion",
                                           default=0.02)
    model_id = cfg.read_string("model_id", default="")
    max_no_rayleigh_wavenumber = cfg.read_float(
        "max_no_rayleigh_wavenumber", default=10000.0)
    max_iterations = cfg.read_int("max_iterations", default=3000)
    negative_od_penalty = cfg.read_float("negative_od_penalty", default=1e4)
    is_bounded = cfg.read_bool("bounded_minimization", default=True)
    band_mapping = cfg.read_ints("band_mapping", default=None)
    if band_mapping is not None:
        band_mapping = np.asarray(band_mapping)
    remove_min_max = cfg.read_bool("remove_min_max", default=False)
    data_parallel = cfg.read_bool("data_parallel", default=True)

    model = CkdModel.read(input_file, active_gas_list=gas_list)
    model.model_id = model_id

    # g-point map for high-res boundary fluxes (ref :167-183)
    g_point = model.g_point
    if g_point is None:
        gpoint_filename = cfg.read_string("gpointfile", default=None)
        if gpoint_filename:
            f = NcFile(find_file(gpoint_filename))
            g_point = np.asarray(f.read("g_point"), np.int64)
            f.close()
            if model.ng != int(g_point.max()) + 1:
                raise ValueError(
                    f"Number of g-points in {input_file} does not match "
                    f"number in {gpoint_filename}")

    model.cap_relative_linear_coeffts(0.8)
    model.create_error_covariances(
        prior_error, min_prior_error, max_prior_error, prior_error_scaling,
        pressure_corr, temperature_corr, conc_corr, rayleigh_prior_error)

    # Forcing (relative-to) mode (ref :195-237)
    relative_to_file = cfg.read_string("relative_to", default=None)
    relative_to_fluxes = None
    rel_ckd = None
    if relative_to_file:
        logs.log("Errors evaluated relative to the following file:")
        relative_to_fluxes = LblFluxes.read(find_file(relative_to_file),
                                            band_mapping)
        _prepare_lbl(relative_to_fluxes, model, max_no_rayleigh_wavenumber)
        od = _reference_od(model, relative_to_fluxes)
        rel_ckd_dn, rel_ckd_up = relative_to_fluxes.calc_ckd_fluxes(od)
        rel_ckd = (rel_ckd_dn, rel_ckd_up)

    training_data: List[LblFluxes] = []
    relative_list = None
    for training_file in read_string_list(cfg, "training_input"):
        fluxes = LblFluxes.read(find_file(training_file), band_mapping,
                                g_point)
        if relative_to_fluxes is not None:
            logs.log("  Subtracting reference fluxes")
            fluxes.subtract(relative_to_fluxes)
        _prepare_lbl(fluxes, model, max_no_rayleigh_wavenumber)
        if band_mapping is None and fluxes.nspec() != model.ng:
            raise ValueError(
                "band_mapping not provided, so number of g-points must "
                "match between LBL and CKD models")
        training_data.append(fluxes)
    if not training_data:
        raise ValueError('"training_input" not specified')
    if rel_ckd is not None:
        relative_list = [rel_ckd] * len(training_data)

    with maybe_profile(cfg):
        result = solve(
            model, training_data, flux_weight=flux_weight,
            flux_profile_weight=flux_profile_weight,
            broadband_weight=broadband_weight,
            spectral_boundary_weight=spectral_boundary_weight,
            erythemal_weight=erythemal_weight, prior_error=prior_error,
            max_iterations=max_iterations,
            convergence_criterion=convergence_criterion,
            negative_od_penalty=negative_od_penalty,
            pressure_weight_power=pressure_weight_power,
            is_bounded=is_bounded,
            relative_fluxes=relative_list, data_parallel=data_parallel,
            solver=cfg.read_string("solver", default="auto"),
            checkpoint_file=cfg.read_string("checkpoint_file",
                                            default=None),
            checkpoint_every=cfg.read_int("checkpoint_every", default=0))

    logs.log(f"Convergence status: {result.status.describe()}")

    if remove_min_max:
        model.save_min_max = False
    model.write(output_file, argv=argv or sys.argv,
                config_str=cfg.sprint())

    if result.status == MinimizerStatus.INVALID_COST_FUNCTION:
        return 1
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from ..errors import run_tool
    return run_tool(
        lambda: optimize_lut(tool_prologue(argv), argv=["optimize_lut"] + argv),
        name="optimize_lut")


if __name__ == "__main__":
    sys.exit(main())
