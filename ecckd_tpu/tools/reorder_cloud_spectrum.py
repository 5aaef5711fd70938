"""reorder_cloud_spectrum: rank wavenumbers by cloud absorptance.

Equivalent of src/ecckd/reorder_cloud_spectrum.cpp:30-201: the
sorting variable is the approximate cloud absorptance in the optically thick
limit from delta-Eddington-scaled single-scattering albedo and asymmetry
factor, interpolated onto the gas wavenumber grid.
"""

from __future__ import annotations

import sys

import numpy as np

from .. import logs
from ..config import Config
from ..io import NcFile
from ..io.order import write_order
from ..io.spectrum import _d_wavenumber_from_grid
from .common import tool_prologue, find_file


def reorder_cloud_spectrum(cfg: Config, argv=()) -> str:
    input_file = find_file(cfg.read_string("input"))
    isize = cfg.read_int("isize")
    wavenumber_input = find_file(cfg.read_string("wavenumber_input"))
    output = cfg.read_string("output")

    logs.log(f"Reading {wavenumber_input}")
    f = NcFile(wavenumber_input)
    wavenumber = np.asarray(f.read("wavenumber"), np.float64)
    f.close()
    nwav = len(wavenumber)
    d_wavenumber = _d_wavenumber_from_grid(wavenumber)

    logs.log(f"Reading {input_file}")
    f = NcFile(input_file)
    cloud_wavenumber = np.asarray(f.read("wavenumber"), np.float64)
    ssa = np.asarray(f.read("single_scattering_albedo"),
                     np.float64)[isize]
    asymmetry = np.asarray(f.read("asymmetry_factor"), np.float64)[isize]
    f.close()

    # Absorptance in the thick limit with delta-Eddington scaling
    # (ref reorder_cloud_spectrum.cpp:113-123)
    fsc = asymmetry * asymmetry
    asymmetry_de = 1.0 / (1.0 + asymmetry)
    ssa_de = ssa * (1.0 - fsc) / (1.0 - ssa * fsc)
    abs_inf_c = np.sqrt((1.0 - ssa_de) / (1.0 - ssa_de * asymmetry_de))
    abs_inf_c = 1.0 - (1.0 - abs_inf_c) / (1.0 + abs_inf_c)
    abs_inf = np.interp(wavenumber, cloud_wavenumber, abs_inf_c)

    if cfg.exist("wavenumber1"):
        band1 = np.asarray(cfg.read_floats("wavenumber1"))
        band2 = np.asarray(cfg.read_floats("wavenumber2"))
    else:
        band1 = np.array([max(0.0, wavenumber[0] - d_wavenumber[0])])
        band2 = np.array([wavenumber[-1] + d_wavenumber[-1]])
    nband = len(band1)
    logs.log("Treating the entire spectrum as one band" if nband == 1
             else f"Splitting the spectrum into {nband} bands")

    band_clamp1 = band1.copy()
    band_clamp2 = band2.copy()
    band_clamp1[0] = max(wavenumber[0], band1[0])
    band_clamp2[-1] = min(wavenumber[-1], band2[-1])

    iband = np.full(nwav, -1, np.int32)
    g_index = np.arange(nwav)
    for jband in range(nband):
        if jband < nband - 1:
            sel = (wavenumber >= band1[jband]) & (wavenumber < band2[jband])
        else:
            sel = (wavenumber >= band1[jband]) & (wavenumber <= band2[jband])
        idx = np.nonzero(sel)[0]
        if len(idx) == 0:
            continue
        iband[idx] = jband
        i1, i2 = idx[0], idx[-1]
        sub = g_index[i1:i2 + 1]
        order = np.argsort(abs_inf[sub], kind="stable")
        g_index[i1:i2 + 1] = sub[order]

    rank = np.empty(nwav, np.int32)
    rank[g_index] = np.arange(nwav)

    logs.log(f"Writing {output}")
    write_order(output, argv or sys.argv, "cloud", cfg.sprint(),
                band_clamp1, band_clamp2, wavenumber, d_wavenumber,
                iband, rank, None, abs_inf)
    return output


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from ..errors import run_tool
    return run_tool(
        lambda: reorder_cloud_spectrum(tool_prologue(argv), argv=["reorder_cloud_spectrum"] + argv),
        name="reorder_cloud_spectrum")


if __name__ == "__main__":
    sys.exit(main())
