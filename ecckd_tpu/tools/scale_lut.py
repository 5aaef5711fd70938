"""scale_lut: SW exactness correction for the median profile.

Equivalent of src/ecckd/scale_lut.cpp:22-192: derive per-(layer,
g-point) optimal optical depths from LBL direct-flux ratios
(od = -mu0 log(F_below/F_above)), run the CKD model for the same profile,
and scale the LUT coefficients by od_best/od_total (clamped to 1 where
od_best <= 0 and to the min/max bounds).
"""

from __future__ import annotations

import sys

import numpy as np

from .. import logs
from ..config import Config
from ..io import NcFile
from ..models import CkdModel
from .common import tool_prologue, find_file, setup_jax


def scale_lut(cfg: Config, argv=()) -> str:
    setup_jax(cfg)
    input_file = find_file(cfg.read_string("input"))
    output_file = cfg.read_string("output")

    model = CkdModel.read(input_file)
    ng = model.ng

    g_point = model.g_point
    if g_point is None:
        gpoint_filename = cfg.read_string("gpointfile", default=None)
        if not gpoint_filename:
            raise ValueError("gpointfile not provided")
        f = NcFile(find_file(gpoint_filename))
        g_point = np.asarray(f.read("g_point"), np.int64)
        f.close()
        if ng != int(g_point.max()) + 1:
            raise ValueError(f"Number of g-points in {input_file} does not "
                             f"match number in {gpoint_filename}")
    else:
        g_point = np.asarray(g_point, np.int64)

    lbl_filename = cfg.read_string("lblfile")
    imu0 = 0
    logs.log(f"Reading {lbl_filename}")
    f = NcFile(find_file(lbl_filename))
    mu0 = float(np.asarray(f.read("mu0")).reshape(-1)[imu0])
    molecules_str = f.attribute("constituent_id", default="") or ""
    pressure_hl = np.asarray(f.read("pressure_hl", index=imu0), np.float64)
    temperature_hl = np.asarray(f.read("temperature_hl", index=imu0),
                                np.float64)
    temperature_fl = 0.5 * (temperature_hl[:-1] + temperature_hl[1:])
    mole_fraction = np.asarray(f.read("mole_fraction_fl", index=imu0),
                               np.float64)
    spectral_flux_dn = np.asarray(
        f.read("spectral_flux_dn_direct_sw", index=imu0), np.float64)
    f.close()

    nz = spectral_flux_dn.shape[0] - 1
    ngas = mole_fraction.shape[0]

    logs.log("Computing optimal layer optical depths in each g point")
    onehot = (g_point[:, None] == np.arange(ng)[None, :]).astype(np.float64)
    flux_g = spectral_flux_dn @ onehot                  # (nz+1, ng)
    od_best = np.empty((nz, ng))
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = flux_g[1:] / np.where(flux_g[:-1] > 0, flux_g[:-1], 1.0)
        od_best = np.where(flux_g[1:] > 0.0, -mu0 * np.log(
            np.where(ratio > 0, ratio, 1.0)), -1.0)

    logs.log("Running CKD model")
    od_total = np.zeros((nz, ng))
    molecules = []
    for molecule in molecules_str.split():
        if "-" in molecule:
            molecule = molecule.split("-", 1)[0]
        molecules.append(molecule)
    for igas in range(-1, ngas):
        molecule = "composite" if igas == -1 else molecules[igas]
        gas_index = model.get_gas_index(molecule)
        if gas_index < 0:
            logs.log(f"  Gas {igas}: {molecule} not found")
            continue
        logs.log(f"  Gas {igas}: {molecule}")
        if igas == -1:
            od = model.calc_optical_depth(
                gas_index, pressure_hl[None, :], temperature_fl[None, :])
        else:
            od = model.calc_optical_depth(
                gas_index, pressure_hl[None, :], temperature_fl[None, :],
                mole_fraction[igas][None, :])
        od_total += np.asarray(od)[0]

    logs.log("Scaling coefficients in CKD look-up tables")
    with np.errstate(divide="ignore", invalid="ignore"):
        scaling = np.where(od_best > 0.0,
                           od_best / np.where(od_total > 0, od_total, 1.0),
                           1.0)
    pressure_fl = 0.5 * (pressure_hl[:-1] + pressure_hl[1:])
    model.scale_optical_depth(pressure_fl, scaling)
    model.write(output_file, argv=argv or sys.argv,
                config_str=cfg.sprint())
    return output_file


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from ..errors import run_tool
    return run_tool(
        lambda: scale_lut(tool_prologue(argv), argv=["scale_lut"] + argv),
        name="scale_lut")


if __name__ == "__main__":
    sys.exit(main())
