"""Tests for the readconfig-compatible config language and NetCDF-4 I/O."""

import numpy as np
import pytest

from ecckd_tpu.config import Config, ConfigError
from ecckd_tpu.io import NcFile, NcWriter


SAMPLE = """
# General configuration options
iprofile 0
averaging_method "transmission"
tolerance_tolerance 0.015
flux_weight 0.0
min_pressure 2.0
max_iterations 60

# List of gases to treat
gases composite h2o o3

\\begin h2o
  input ckdmip_mmm_lw_spectra_h2o_median.h5
  reordering_input lw_order_h2o.h5
  background_input "ckdmip_mmm_lw_spectra_composite_present.h5
            ckdmip_mmm_lw_spectra_o3_minimum.h5"
\\end h2o

\\begin o3
  input o3_median.h5
\\end o3

vector_value 1.0 2.5 -3.0
"""


class TestConfig:
    def setup_method(self):
        self.cfg = Config.from_text(SAMPLE)

    def test_scalars(self):
        assert self.cfg.read_int("iprofile") == 0
        assert self.cfg.read_float("tolerance_tolerance") == 0.015
        assert self.cfg.read_string("averaging_method") == "transmission"

    def test_string_list_indexed(self):
        # The reference iterates lists by index until None
        # (e.g. optimize_lut.cpp:248)
        gases = []
        i = 0
        while True:
            g = self.cfg.read_string("gases", i)
            if g is None:
                break
            gases.append(g)
            i += 1
        assert gases == ["composite", "h2o", "o3"]

    def test_sections(self):
        assert (self.cfg.read_string("h2o.input")
                == "ckdmip_mmm_lw_spectra_h2o_median.h5")
        bg = self.cfg.read_strings("h2o.background_input")
        assert len(bg) == 2
        assert bg[1] == "ckdmip_mmm_lw_spectra_o3_minimum.h5"
        sub = self.cfg.section("o3")
        assert sub.read_string("input") == "o3_median.h5"

    def test_vector(self):
        assert self.cfg.read_floats("vector_value") == [1.0, 2.5, -3.0]

    def test_missing_key(self):
        with pytest.raises(ConfigError):
            self.cfg.read_string("nonexistent")
        assert self.cfg.read_string("nonexistent", default=None) is None

    def test_cli_overrides(self, tmp_path):
        p = tmp_path / "test.cfg"
        p.write_text(SAMPLE)
        cfg = Config.from_args(["gases=h2o o3", "o3.input=alt.h5", str(p)])
        assert cfg.read_strings("gases") == ["h2o", "o3"]
        assert cfg.read_string("o3.input") == "alt.h5"
        assert cfg.read_int("iprofile") == 0  # from file

    def test_serialize_roundtrip(self):
        text = self.cfg.serialize()
        cfg2 = Config.from_text(text)
        assert cfg2.read_strings("gases") == ["composite", "h2o", "o3"]
        assert cfg2.read_float("min_pressure") == 2.0

    def test_xml_engine(self, tmp_path):
        """XML configs via the DataFile extension dispatch (ref
        src/tools/DataFile.cpp:76-110; XML engine semantics of
        DataFileEngineXml.cpp without the GMV dependency): nesting maps
        to dotted sections, element text to (list) values."""
        p = tmp_path / "conf.xml"
        p.write_text("""<config>
  <iprofile>0</iprofile>
  <gases>composite h2o o3</gases>
  <h2o>
    <input>h2o_median.h5</input>
    <conc_dependence>lut</conc_dependence>
  </h2o>
</config>""")
        cfg = Config.from_file(str(p))
        assert cfg.read_int("iprofile") == 0
        assert cfg.read_strings("gases") == ["composite", "h2o", "o3"]
        assert cfg.read_string("h2o.input") == "h2o_median.h5"
        # CLI overrides still beat XML file values
        cfg2 = Config.from_args(["h2o.input=alt.h5", str(p)])
        assert cfg2.read_string("h2o.input") == "alt.h5"
        assert cfg2.read_string("h2o.conc_dependence") == "lut"

    def test_xml_gmv_dialect(self, tmp_path):
        """GMV-dialect name mapping (DataFileEngineXml.cpp:82-113
        translate_varname): unsectioned names live under <main>
        ("x" -> main/x), dotted names nest ("a.b" -> a/b, "a.b.c" ->
        a/b/c), and beyond two levels the dot is literal in the element
        tag ("a.b.c.d" -> a/b/<c.d>).  Vectors are whitespace-separated
        element text read up to the requested index (PARTIAL_CHECK,
        DataFileEngineXml.cpp:63-81)."""
        p = tmp_path / "gmv.xml"
        p.write_text("""<Earth_Explorer_File>
  <main>
    <iprofile>2</iprofile>
    <wavenumber>100.0 250.5 400.0</wavenumber>
  </main>
  <h2o>
    <input>h2o_median.h5</input>
    <lut>
      <temperature.stride>4</temperature.stride>
    </lut>
  </h2o>
</Earth_Explorer_File>""")
        cfg = Config.from_file(str(p))
        # "x" -> main/x: unsectioned scope
        assert cfg.read_int("iprofile") == 2
        assert cfg.read_floats("wavenumber") == [100.0, 250.5, 400.0]
        # element-index read of a vector value (read(x, varname, j))
        assert cfg.read_float("wavenumber", index=1) == 250.5
        # "a.b" -> a/b
        assert cfg.read_string("h2o.input") == "h2o_median.h5"
        # "a.b.c.d" -> a/b/<c.d>: third dot literal in the tag
        assert cfg.read_int("h2o.lut.temperature.stride") == 4
        assert cfg.exist("h2o.input") and not cfg.exist("o3.input")


class TestNcio:
    def test_roundtrip(self, tmp_path):
        path = str(tmp_path / "test.nc")
        data2d = np.arange(12.0).reshape(3, 4)
        with NcWriter(path) as w:
            w.define_dimension("temperature", 3)
            w.define_dimension("pressure", 4)
            w.define_variable("temperature", "float", "temperature")
            w.define_variable("molar_abs", "double", "temperature", "pressure")
            w.write_units("m2 mol-1", "molar_abs")
            w.write_long_name("Molar absorption", "molar_abs")
            w.write(np.array([200.0, 250.0, 300.0]), "temperature")
            w.write(data2d, "molar_abs")
            w.write("h2o o3", "constituent_id")
            w.write(3, "n_gases")
            w.write_attribute("test history", "history")
            w.append_history(["prog", "key=value", "file.cfg"])
        with NcFile(path) as f:
            assert f.exist("molar_abs")
            assert not f.exist("nothing")
            assert f.size("molar_abs") == (3, 4)
            np.testing.assert_allclose(f.read("molar_abs"), data2d)
            np.testing.assert_allclose(f.read("temperature"),
                                       [200.0, 250.0, 300.0])
            assert f.read_string("constituent_id") == "h2o o3"
            assert f.read_scalar("n_gases") == 3
            assert f.attribute("units", "molar_abs") == "m2 mol-1"
            hist = f.attribute("history")
            assert hist.startswith("test history\n")
            assert "prog key=value file.cfg" in hist

    def test_slice_read_write(self, tmp_path):
        path = str(tmp_path / "slices.nc")
        with NcWriter(path) as w:
            w.define_dimension("conc", 2)
            w.define_dimension("g", 5)
            w.define_variable("k", "float", "conc", "g")
            w.write(np.arange(5.0), "k", index=0)
            w.write(np.arange(5.0) * 2, "k", index=1)
        with NcFile(path) as f:
            np.testing.assert_allclose(f.read("k", index=1),
                                       np.arange(5.0) * 2)

    def test_unlimited_dimension(self, tmp_path):
        path = str(tmp_path / "unlim.nc")
        with NcWriter(path) as w:
            w.define_dimension("column", None)
            w.define_dimension("level", 3)
            w.define_variable("flux", "double", "column", "level")
            for i in range(4):
                w.write(np.full(3, float(i)), "flux", index=i)
        with NcFile(path) as f:
            assert f.size("flux") == (4, 3)
            np.testing.assert_allclose(f.read("flux")[2], 2.0)

    def test_netcdf4_dimension_scales(self, tmp_path):
        # Name kept from the NetCDF-4 writer: the output is a NetCDF-3
        # 64-bit-offset file whose variables name their dimensions
        from scipy.io import netcdf_file
        path = str(tmp_path / "dims.nc")
        with NcWriter(path) as w:
            w.define_dimension("g_point", 4)
            w.define_variable("solar_irradiance", "float", "g_point")
            w.write(np.ones(4), "solar_irradiance")
        with open(path, "rb") as fh:
            assert fh.read(4) == b"CDF\x02"
        f = netcdf_file(path, "r", mmap=False)
        assert f.dimensions["g_point"] == 4
        assert f.variables["solar_irradiance"].dimensions == ("g_point",)
        f.close()
