"""merge_spectra: sum the optical depths of several gases into a hybrid file.

Equivalent of src/ecckd/merge_spectra.cpp:19-156: loops
read_merged_spectrum over all profiles, writing a hybrid
spectrum file.
"""

from __future__ import annotations

import sys

import numpy as np

from .. import logs
from ..config import Config
from ..io import NcWriter
from ..io.spectrum import read_merged_spectrum
from .common import tool_prologue, setup_jax


def merge_spectra(cfg: Config, argv=()) -> str:
    output = cfg.read_string("output")

    icol = 0
    logs.log(f"Merging profile {icol}")
    sp = read_merged_spectrum(cfg, icol, "")
    nlay, nwav = sp.optical_depth.shape
    ncol = sp.ncol

    logs.log(f"Writing {output}")
    w = NcWriter(output)
    w.define_dimension("column", ncol)
    w.define_dimension("level", nlay)
    w.define_dimension("half_level", nlay + 1)
    w.define_dimension("wavenumber", nwav)

    w.define_variable("pressure_hl", "float", "column", "half_level")
    w.write_long_name("Pressure at half levels", "pressure_hl")
    w.write_units("Pa", "pressure_hl")
    w.define_variable("temperature_hl", "float", "column", "half_level")
    w.write_long_name("Temperature at half levels", "temperature_hl")
    w.write_units("K", "temperature_hl")
    w.define_variable("wavenumber", "double", "wavenumber")
    w.write_long_name("Wavenumber", "wavenumber")
    w.write_units("cm-1", "wavenumber")
    w.define_variable("optical_depth", "float", "column", "level",
                      "wavenumber")
    w.write_long_name("Layer optical depth", "optical_depth")

    molecules = sp.molecule
    title = ("Merged spectral optical depth profiles of "
             + molecules.upper().replace(" ", ", "))
    w.write_attribute(title, "title")
    w.write_attribute("hybrid:" + molecules, "molecule")
    w.append_history(argv or sys.argv)
    w.write_attribute(cfg.sprint(), "config")
    w.end_define()    # each column goes to disk as it is merged

    w.write(sp.pressure_hl, "pressure_hl", index=icol)
    w.write(sp.temperature_hl, "temperature_hl", index=icol)
    w.write(sp.wavenumber, "wavenumber")
    w.write(sp.optical_depth.astype(np.float32), "optical_depth", index=icol)

    for icol in range(1, ncol):
        logs.log(f"Merging profile {icol}")
        sp = read_merged_spectrum(cfg, icol, "")
        w.write(sp.pressure_hl, "pressure_hl", index=icol)
        w.write(sp.temperature_hl, "temperature_hl", index=icol)
        w.write(sp.optical_depth.astype(np.float32), "optical_depth",
                index=icol)
    w.close()
    return output


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from ..errors import run_tool
    return run_tool(
        lambda: merge_spectra(tool_prologue(argv), argv=["merge_spectra"] + argv),
        name="merge_spectra")


if __name__ == "__main__":
    sys.exit(main())
