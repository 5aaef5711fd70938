"""NetCDF on-disk convention checks for every pipeline artifact.

The reference writes classic/NetCDF-4 via libnetcdf (OutputDataFile.h:
47-193); this framework writes NetCDF-3 64-bit-offset files through
``scipy.io.netcdf_file``, the format every netCDF reader opens.  No
independent libnetcdf binding exists in this image (netCDF4/h5netcdf/
xarray/ncdump all absent — see PARITY.md), so consumability is validated
two ways:

1. Structural checks of the NetCDF-3 64-bit-offset layout, read back with
   scipy independently of the writer: the ``CDF\x02`` magic, every
   variable's dimensions defined with lengths matching its shape, at most
   one unlimited dimension and only as a leading axis, and the
   ``history`` provenance attribute.
2. If the real netCDF4 binding is importable (richer images), every
   artifact is read back through it outright.
"""

import numpy as np
import pytest
from scipy.io import netcdf_file

from ecckd_tpu.config import Config
from ecckd_tpu.tools.reorder_spectrum import reorder_spectrum
from ecckd_tpu.tools.find_g_points import find_g_points
from ecckd_tpu.tools.create_lut import create_lut
from ecckd_tpu.tools.optimize_lut import optimize_lut
from synth import synth_spectrum_file, synth_lbl_flux_file

try:
    import netCDF4
    HAVE_NETCDF4 = True
except ImportError:
    HAVE_NETCDF4 = False


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ncconv")
    h2o = synth_spectrum_file(str(d / "h2o.nc"), nwav=512, ncol=4)
    order = str(d / "order.nc")
    reorder_spectrum(Config({"input": h2o, "output": order}), argv=["r"])
    gp = str(d / "gp.nc")
    find_g_points(Config({
        "output": gp, "gases": "h2o", "heating_rate_tolerance": "0.4",
        "averaging_method": "transmission",
        "h2o.reordering_input": order, "h2o.input": h2o}), argv=["f"])
    lut = str(d / "lut.nc")
    create_lut(Config({
        "input": gp, "output": lut, "gases": "h2o",
        "averaging_method": "transmission",
        "h2o.conc_dependence": "linear", "h2o.input": h2o}), argv=["c"])
    training = str(d / "tr.nc")
    synth_lbl_flux_file(training, [h2o], gp, ["h2o"], iprofiles=(0, 1))
    out = str(d / "opt.nc")
    optimize_lut(Config({
        "input": lut, "output": out, "gases": "h2o",
        "training_input": training, "max_iterations": "2",
        "prior_error": "4.0"}), argv=["o"])
    return [order, gp, lut, out]


def check_netcdf3_conventions(path):
    with open(path, "rb") as fh:
        assert fh.read(4) == b"CDF\x02", f"{path}: not 64-bit-offset CDF"
    f = netcdf_file(path, "r", mmap=False)
    try:
        unlimited = [d for d, n in f.dimensions.items() if n is None]
        assert len(unlimited) <= 1, (path, unlimited)
        assert f.variables, f"{path}: no variables"
        for name, var in f.variables.items():
            for axis, dim in enumerate(var.dimensions):
                assert dim in f.dimensions, (path, name, dim)
                if f.dimensions[dim] is None:
                    assert axis == 0, (path, name, "unlimited not leading")
                else:
                    assert var.data.shape[axis] == f.dimensions[dim], \
                        (path, name, axis)
        assert b"history" in [k.encode() for k in f._attributes], path
    finally:
        f.close()


def test_all_artifacts_follow_netcdf4_conventions(artifacts):
    # Name kept from the NetCDF-4 writer; the artifacts are NetCDF-3 now
    for path in artifacts:
        check_netcdf3_conventions(path)


@pytest.mark.skipif(not HAVE_NETCDF4, reason="netCDF4 binding unavailable "
                    "in this image (see PARITY.md)")
def test_readback_with_libnetcdf(artifacts):
    for path in artifacts:
        with netCDF4.Dataset(path) as ds:
            assert ds.dimensions, path
            for vname, var in ds.variables.items():
                arr = var[...]
                assert np.asarray(arr).size >= 0
            assert "history" in ds.ncattrs()
