"""NetCDF I/O on packages every installation has: NetCDF-3 64-bit-offset
files written and read through scipy, HDF5-based NetCDF-4 inputs read
through h5py only when a file carries the HDF5 signature, and the main
path importable without h5py or matplotlib."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from ecckd_tpu.io import NcFile, NcWriter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_scalars_beside_record_variables(tmp_path):
    """A scalar variable in a file with an unlimited dimension must not
    land inside the record section (it overwrote the first record)."""
    path = str(tmp_path / "rec.nc")
    with NcWriter(path) as w:
        w.define_dimension("column", None)
        w.define_dimension("level", 3)
        w.define_variable("od", "float", "column", "level")
        w.define_variable("vmr", "double")
        w.write(0.01, "vmr")
        w.write(7, "n_things")
        for i in range(3):
            w.write(np.arange(3.0) + 10 * i, "od", index=i)
    with NcFile(path) as f:
        np.testing.assert_array_equal(
            f.read("od"), np.arange(3.0)[None, :] + 10 * np.arange(3)[:, None])
        assert f.read_scalar("vmr") == 0.01
        assert f.read_scalar("n_things") == 7
        assert f.read("od").dtype == np.float32   # native byte order
        assert f.read("od").dtype.byteorder in ("=", "|", "<")


def test_strings_and_utf8_attributes(tmp_path):
    path = str(tmp_path / "text.nc")
    history = "2026-01-01: find_g_points — key=välue"
    with NcWriter(path) as w:
        w.define_dimension("g", 2)
        w.define_variable("x", "short", "g")
        w.write(np.array([1, 2]), "x")
        w.write("h2o o3 ch4", "constituent_id")
        w.write_attribute(history, "history")
        w.write_attribute(np.array([1.5, 2.5]), "bounds", "x")
        w.write_attribute(np.array([3, 4], ">i4"), "read_back", "x")
        w.write_attribute(True, "flag")
    with NcFile(path) as f:
        assert f.read_string("constituent_id") == "h2o o3 ch4"
        assert f.attribute("history") == history
        np.testing.assert_array_equal(f.attribute("bounds", "x"),
                                      [1.5, 2.5])
        np.testing.assert_array_equal(f.attribute("read_back", "x"), [3, 4])
        assert f.attribute("missing", default="d") == "d"
        assert "history" in f.global_attributes()
        assert f.names() and f.exist("x") and not f.exist("y")
        np.testing.assert_array_equal(f.read_slice("x", None, 1, 2), [2])


def test_netcdf3_rules_enforced(tmp_path):
    w = NcWriter(str(tmp_path / "rules.nc"))
    w.define_dimension("column", None)
    with pytest.raises(ValueError, match="one unlimited"):
        w.define_dimension("time", None)
    w.define_dimension("level", 2)
    with pytest.raises(ValueError, match="must come first"):
        w.define_variable("bad", "float", "level", "column")
    with pytest.raises(ValueError, match="not defined"):
        w.define_variable("worse", "float", "nowhere")
    w.close()


def _vsize_fields(path):
    """Each variable's 32-bit size field, parsed with scipy's header
    reader (the field is unsigned in the format)."""
    from ecckd_tpu.io.ncio import _Nc3Reader
    sizes = {}

    class Probe(_Nc3Reader):
        def _true_vsize(self, var):
            sizes[var[0]] = int(var[8]) & 0xFFFFFFFF
            return super()._true_vsize(var)

    Probe(path, "r", mmap=False).close()
    return sizes


@pytest.mark.parametrize("nwav,field", [
    (1 << 29, 1 << 31),          # over 2 GiB: scipy's signed field overflows
    (1 << 30, 2 ** 32 - 1),      # over 4 GiB: the format's 2^32 - 1 marker
])
def test_variable_over_2gib(tmp_path, nwav, field):
    """A spectrum-sized variable gets its true size field (or the large
    marker) and reads back at its full shape.  Nothing is written, so the
    file is sparse."""
    path = str(tmp_path / "big.nc")
    with NcWriter(path) as w:
        w.define_dimension("wavenumber", nwav)
        w.define_variable("optical_depth", "float", "wavenumber")
        w.end_define()
        assert not w._pending
    assert _vsize_fields(path)["optical_depth"] == field
    with NcFile(path) as f:
        assert f.size("optical_depth") == (nwav,)
        np.testing.assert_array_equal(
            f.read_slice("optical_depth", None, nwav - 4, nwav), 0.0)


def test_oversize_variables_go_last_or_are_refused(tmp_path, monkeypatch):
    """Over the 32-bit size limit (lowered here to 64 bytes) a variable is
    placed last in its section and carries the large marker; two of them,
    or a large fixed-size variable beside record variables, are refused
    with the size named."""
    from ecckd_tpu.io import ncio
    monkeypatch.setattr(ncio, "_VSIZE_MAX", 64)
    big = np.arange(40.0).reshape(2, 20)       # 160 bytes as float
    rec = np.arange(90.0).reshape(3, 30)       # 120 bytes per record

    fixed = str(tmp_path / "fixed.nc")
    with NcWriter(fixed) as w:
        w.define_dimension("x", 2)
        w.define_dimension("y", 20)
        w.define_variable("big", "float", "x", "y")
        w.define_variable("small", "double", "x")
        w.write(big, "big")
        w.write([1.5, 2.5], "small")
    records = str(tmp_path / "records.nc")
    with NcWriter(records) as w:
        w.define_dimension("t", None)
        w.define_dimension("z", 30)
        w.define_variable("small", "double")
        w.define_variable("rec_big", "float", "t", "z")
        w.define_variable("rec_small", "int", "t")
        w.end_define()
        w.write(0.25, "small")
        for i in range(3):
            w.write(rec[i], "rec_big", index=i)
            w.write(i * 10, "rec_small", index=i)
    with NcFile(fixed) as f:
        np.testing.assert_array_equal(f.read("big"), big)
        np.testing.assert_array_equal(f.read("small"), [1.5, 2.5])
        assert f.names() == ["small", "big"]
    with NcFile(records) as f:
        np.testing.assert_array_equal(f.read("rec_big"), rec)
        np.testing.assert_array_equal(f.read("rec_small"), [0, 10, 20])
        assert f.read_scalar("small") == 0.25
        assert f.names() == ["small", "rec_small", "rec_big"]
    assert _vsize_fields(fixed)["big"] == 2 ** 32 - 1
    assert _vsize_fields(records)["rec_big"] == 2 ** 32 - 1

    for extra in ("big2", "rec"):
        w = NcWriter(str(tmp_path / f"refused_{extra}.nc"))
        w.define_dimension("x", 2)
        w.define_dimension("y", 20)
        w.define_dimension("t", None)
        w.define_variable("big", "float", "x", "y")
        if extra == "big2":
            w.define_variable("big2", "float", "x", "y")
        else:
            w.define_variable("rec", "float", "t")
        with pytest.raises(ValueError, match="160 bytes"):
            w.close()


def test_lone_record_variable_is_not_padded(tmp_path):
    """The format packs a lone record variable's records without padding
    (3 shorts = 6 bytes per record, not 8)."""
    path = str(tmp_path / "lone.nc")
    with NcWriter(path) as w:
        w.define_dimension("t", None)
        w.define_dimension("k", 3)
        w.define_variable("v", "short", "t", "k")
        w.end_define()
        header = w._fp.tell()
        for i in range(4):
            w.write(np.arange(3) + 3 * i, "v", index=i)
    assert os.path.getsize(path) == header + 4 * 6
    with NcFile(path) as f:
        np.testing.assert_array_equal(f.read("v"),
                                      np.arange(12).reshape(4, 3))


def test_writes_stream_after_end_define(tmp_path):
    """After end_define each write is on disk before the next one and no
    column is held in memory: 16 columns of 1 MiB peak under 3 MiB of
    Python allocations (the column and its converted copy)."""
    import tracemalloc
    path = str(tmp_path / "stream.nc")
    ncol, nwav = 16, 1 << 18
    with NcWriter(path) as w:
        w.define_dimension("column", None)
        w.define_dimension("wavenumber", nwav)
        w.define_variable("optical_depth", "float", "column", "wavenumber")
        w.define_variable("col", "int", "column")
        w.end_define()
        tracemalloc.start()
        for i in range(ncol):
            w.write(np.full(nwav, float(i), np.float32), "optical_depth",
                    index=i)
            w.write(i, "col", index=i)
            w._fp.flush()
            assert os.path.getsize(path) > (i + 1) * nwav * 4
            assert not w._pending
        peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
    assert peak < 3 * nwav * 4, peak
    with NcFile(path) as f:
        np.testing.assert_array_equal(f.read("col"), np.arange(ncol))
        np.testing.assert_array_equal(f.read("optical_depth", 7),
                                      np.full(nwav, 7.0))


def test_definitions_end_at_end_define(tmp_path):
    w = NcWriter(str(tmp_path / "closed.nc"))
    w.define_dimension("x", 2)
    w.end_define()
    with pytest.raises(ValueError, match="after end_define"):
        w.define_variable("v", "float", "x")
    with pytest.raises(ValueError, match="after end_define"):
        w.write_attribute("t", "title")
    with pytest.raises(ValueError, match="after end_define"):
        w.write(1.0, "scalar")
    w.close()


@pytest.mark.parametrize("tool", ["merge_spectra", "lw_spectra"])
def test_spectrum_tools_write_each_column_to_disk(tmp_path, monkeypatch,
                                                  tool):
    """merge_spectra and lw_spectra write every column's spectra in data
    mode: none is kept in memory until the file closes."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth import synth_spectrum_file
    from ecckd_tpu.config import Config
    from ecckd_tpu.tools.merge_spectra import merge_spectra
    from ecckd_tpu.tools.lw_spectra import lw_spectra

    spec = synth_spectrum_file(str(tmp_path / "h2o.nc"), nwav=256, ncol=3)
    held = []
    orig = NcWriter.write

    def spy(self, data, name, index=None):
        if np.size(data) >= 256:
            held.append((name, index, self._defining))
        return orig(self, data, name, index)

    monkeypatch.setattr(NcWriter, "write", spy)
    run = merge_spectra if tool == "merge_spectra" else lw_spectra
    out = str(tmp_path / "out.nc")
    run(Config({"output": out, "input": spec}), argv=[tool])
    cols = [h for h in held if h[1] is not None]
    assert len({h[1] for h in cols}) == 3
    assert not any(h[2] for h in held), held
    with NcFile(out) as f:
        assert f.size("optical_depth")[0] == 3


def test_hdf5_netcdf4_inputs_read_through_h5py(tmp_path):
    h5py = pytest.importorskip("h5py")
    path = str(tmp_path / "ckdmip.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("wavenumber", data=np.arange(4.0))
        f.create_dataset("_nc4_non_coord_g_point",
                         data=np.array([0, 0, 1, 1], np.int16))
        f.create_dataset("optical_depth",
                         data=np.arange(24.0).reshape(2, 3, 4))
        f.attrs["constituent_id"] = np.bytes_(b"h2o")
    with NcFile(path) as f:
        np.testing.assert_array_equal(f.read("g_point"), [0, 0, 1, 1])
        np.testing.assert_array_equal(f.read_slice("optical_depth", 1, 1, 3),
                                      np.arange(24.0).reshape(2, 3, 4)[1, :,
                                                                       1:3])
        assert f.attribute("constituent_id") == "h2o"


def test_hdf5_input_without_h5py_names_package_and_file(tmp_path):
    path = tmp_path / "ckdmip.h5"
    path.write_bytes(b"\x89HDF\r\n\x1a\n" + b"\0" * 64)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["h5py"] = None
        from ecckd_tpu.io import NcFile
        try:
            NcFile({str(path)!r})
        except ImportError as e:
            print("ERR", e)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert "ERR" in out.stdout and "h5py" in out.stdout \
        and str(path) in out.stdout, out.stdout + out.stderr


def test_unknown_format_rejected(tmp_path):
    path = tmp_path / "junk.nc"
    path.write_bytes(b"not a netcdf file")
    with pytest.raises(ValueError, match="not a NetCDF"):
        NcFile(str(path))


_MASKED_CHAIN = """
import os, sys, importlib, pkgutil
sys.modules["h5py"] = None
sys.modules["matplotlib"] = None
sys.path.insert(0, os.path.join({root!r}, "tests"))
import jax
jax.config.update("jax_platforms", "cpu")
import ecckd_tpu.tools as tools
names = [m.name for m in pkgutil.iter_modules(tools.__path__)
         if m.name != "plot_ckd"]
for name in names:
    importlib.import_module("ecckd_tpu.tools." + name)
from synth import synth_spectrum_file
from ecckd_tpu.config import Config
from ecckd_tpu.tools.reorder_spectrum import reorder_spectrum
from ecckd_tpu.tools.find_g_points import find_g_points
from ecckd_tpu.tools.create_lut import create_lut
d = {work!r}
h2o = synth_spectrum_file(os.path.join(d, "h2o.nc"), nwav=512, ncol=3)
order = os.path.join(d, "order.nc")
reorder_spectrum(Config({{"input": h2o, "output": order}}), argv=["r"])
gp = os.path.join(d, "gp.nc")
find_g_points(Config({{"output": gp, "gases": "h2o",
    "heating_rate_tolerance": "0.4", "averaging_method": "transmission",
    "h2o.reordering_input": order, "h2o.input": h2o}}), argv=["f"])
create_lut(Config({{"input": gp, "output": os.path.join(d, "lut.nc"),
    "gases": "h2o", "averaging_method": "transmission",
    "h2o.conc_dependence": "linear", "h2o.input": h2o}}), argv=["c"])
assert "h5py" not in [m for m in sys.modules if sys.modules[m] is not None]
print("CHAIN_OK", len(names))
"""


def test_main_path_without_h5py_or_matplotlib(tmp_path):
    """Every tool except plot_ckd imports, and the LW chain runs, with
    h5py and matplotlib masked out of sys.modules."""
    code = _MASKED_CHAIN.format(root=ROOT, work=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert "CHAIN_OK" in out.stdout, out.stdout[-2000:] + out.stderr[-4000:]


def test_plots_module_is_off_the_main_path():
    code = ("import sys; import ecckd_tpu.tools.find_g_points, "
            "ecckd_tpu.tools.create_lut, ecckd_tpu.tools.optimize_lut, "
            "ecckd_tpu.tools.run_ckd, ecckd_tpu.pipeline.orchestrator; "
            "print('matplotlib' in sys.modules, 'h5py' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.stdout.strip() == "False False", out.stdout + out.stderr
