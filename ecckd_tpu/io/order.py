"""Reader/writer for spectral-ordering files.

Equivalent of write_order (src/ecckd/write_order.cpp:23-143) and
the ordering reads in find_g_points (find_g_points.cpp:676-684).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .ncio import NcFile, NcWriter


@dataclasses.dataclass
class SpectralOrder:
    wavenumber1_band: np.ndarray       # (nband,)
    wavenumber2_band: np.ndarray       # (nband,)
    wavenumber: np.ndarray             # (nwav,)
    d_wavenumber: np.ndarray           # (nwav,)
    band_number: np.ndarray            # (nwav,) int, -1 = not considered
    rank: np.ndarray                   # (nwav,) int
    column_optical_depth: Optional[np.ndarray]
    sorting_variable: np.ndarray       # (nwav,)
    molecule: str = ""


def write_order(file_name: str, argv: Sequence[str], molecule: str,
                config_str: str, band_bound1, band_bound2, wavenumber,
                d_wavenumber, iband, rank, column_optical_depth,
                sorting_variable):
    """Write an ordering NetCDF file with the reference's exact schema."""
    nband = len(band_bound1)
    nwav = len(wavenumber)
    w = NcWriter(file_name)
    w.define_dimension("band", nband)
    w.define_dimension("wavenumber", nwav)

    w.define_variable("wavenumber1_band", "float", "band")
    w.write_long_name("Lower wavenumber bound of band", "wavenumber1_band")
    w.write_units("cm-1", "wavenumber1_band")
    w.define_variable("wavenumber2_band", "float", "band")
    w.write_long_name("Upper wavenumber bound of band", "wavenumber2_band")
    w.write_units("cm-1", "wavenumber2_band")

    w.define_variable("wavenumber", "double", "wavenumber")
    w.write_long_name("Wavenumber", "wavenumber")
    w.write_units("cm-1", "wavenumber")
    w.define_variable("d_wavenumber", "float", "wavenumber")
    w.write_long_name("Wavenumber interval", "d_wavenumber")
    w.write_units("cm-1", "d_wavenumber")

    w.define_variable("band_number", "short", "wavenumber")
    w.write_long_name("Band number", "band_number")
    w.write_comment(
        "This variable indicates the number of the band (0 based) that each "
        "wavenumber is in, with -1 indicating a wavenumber not considered.",
        "band_number")

    w.define_variable("rank", "int", "wavenumber")
    w.write_long_name("Rank when reordered", "rank")
    w.write_comment(
        "This variable indicates the place of each wavenumber after "
        "reordering, with 0 indicating the least optically thick.\n"
        "rank(i) provides the rank of wavenumber i.", "rank")

    if column_optical_depth is not None:
        w.define_variable("column_optical_depth", "float", "wavenumber")
        w.write_long_name("Column optical depth", "column_optical_depth")

    w.define_variable("sorting_variable", "float", "wavenumber")
    w.write_long_name("Variable used to sort spectrum", "sorting_variable")
    if molecule == "cloud":
        w.write_comment(
            "This variable is equal to the approximate cloud absorptance in "
            "the optically thick limit.", "sorting_variable")
    else:
        w.write_comment(
            "This variable is equal to log(surface pressure) minus "
            "log(pressure of peak heating/cooling),\nbut for column optical "
            "depths less than a threshold, set to column optical depth minus "
            "the threshold.", "sorting_variable")

    if molecule:
        title = ("Optimal reordering of the absorption spectrum of "
                 + molecule.upper())
        w.write_attribute(title, "title")
        w.write_attribute(molecule, "molecule")
    else:
        w.write_attribute("Optimal reordering of the absorption spectrum of "
                          "a gas", "title")
    w.append_history(argv)
    w.write_attribute(config_str, "config")

    w.write(np.asarray(band_bound1), "wavenumber1_band")
    w.write(np.asarray(band_bound2), "wavenumber2_band")
    w.write(np.asarray(wavenumber), "wavenumber")
    w.write(np.asarray(d_wavenumber), "d_wavenumber")
    w.write(np.asarray(iband, np.int16), "band_number")
    w.write(np.asarray(rank, np.int32), "rank")
    if column_optical_depth is not None:
        w.write(np.asarray(column_optical_depth), "column_optical_depth")
    w.write(np.asarray(sorting_variable), "sorting_variable")
    w.close()


def read_order(file_name: str) -> SpectralOrder:
    f = NcFile(file_name)
    order = SpectralOrder(
        wavenumber1_band=np.asarray(f.read("wavenumber1_band"), np.float64),
        wavenumber2_band=np.asarray(f.read("wavenumber2_band"), np.float64),
        wavenumber=np.asarray(f.read("wavenumber"), np.float64),
        d_wavenumber=np.asarray(f.read("d_wavenumber"), np.float64),
        band_number=np.asarray(f.read("band_number"), np.int32),
        rank=np.asarray(f.read("rank"), np.int32),
        column_optical_depth=(np.asarray(f.read("column_optical_depth"),
                                         np.float64)
                              if f.exist("column_optical_depth") else None),
        sorting_variable=np.asarray(f.read("sorting_variable"), np.float64),
        molecule=f.attribute("molecule", default="") or "")
    f.close()
    return order
