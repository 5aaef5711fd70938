"""End-to-end test: reorder -> find_g_points -> create_lut -> run_ckd.

This is the minimum full LW chain on synthetic spectra (SURVEY.md §7 build
step 6): it validates that the generated ckd-definition file reproduces the
line-by-line fluxes it was built from.
"""

import numpy as np
import pytest

from ecckd_tpu.config import Config
from ecckd_tpu.io import NcFile, NcWriter, read_spectrum
from ecckd_tpu.models import CkdModel
from ecckd_tpu.tools.reorder_spectrum import reorder_spectrum
from ecckd_tpu.tools.find_g_points import find_g_points
from ecckd_tpu.tools.create_lut import create_lut
from synth import synth_spectrum_file


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    d = tmp_path_factory.mktemp("chain")
    h2o = synth_spectrum_file(str(d / "h2o.h5"), molecule="h2o",
                              nwav=1024, ncol=6, seed=3)
    order = str(d / "h2o_order.h5")
    reorder_spectrum(Config({"input": h2o, "output": order}), argv=["r"])
    gpoints = str(d / "gpoints.h5")
    find_g_points(Config({
        "output": gpoints, "gases": "h2o",
        "heating_rate_tolerance": "0.4",
        "averaging_method": "transmission",
        "h2o.reordering_input": order,
        "h2o.input": h2o,
    }), argv=["find_g_points"])
    lut = str(d / "lut.nc")
    create_lut(Config({
        "input": gpoints, "output": lut,
        "gases": "h2o",
        "averaging_method": "transmission",
        "h2o.conc_dependence": "linear",
        "h2o.input": h2o,
    }), argv=["create_lut"])
    return dict(d=d, h2o=h2o, order=order, gpoints=gpoints, lut=lut)


class TestCreateLut:
    def test_model_structure(self, chain):
        model = CkdModel.read(chain["lut"])
        assert model.molecules == ["h2o"]
        assert not model.is_sw()
        g = model.gas("h2o")
        # nt = number of temperature profiles in the synthetic file
        assert g.molar_abs.shape[0] == 6
        assert g.molar_abs.shape[2] == model.ng
        assert np.all(g.molar_abs >= 0)
        assert np.all(g.min_molar_abs <= g.molar_abs + 1e-30)
        assert np.all(g.molar_abs <= g.max_molar_abs + 1e-30)
        # Planck LUT covers 120..350 K
        assert model.temperature_planck[0] == 120.0
        assert model.temperature_planck[-1] == 350.0
        # gpoint_fraction rows sum to ~1 over the full grid
        np.testing.assert_allclose(model.gpoint_fraction.sum(1),
                                   1.0, rtol=1e-6)
        # provenance chains from the g-point file
        f = NcFile(chain["lut"])
        assert "find_g_points" in f.attribute("history")
        f.close()

    def test_lut_reproduces_lbl_fluxes(self, chain):
        """run_ckd with the generated LUT should approximate the LBL fluxes
        of the training profile."""
        import jax
        from ecckd_tpu.ops import planck_function, rt_lw, heating_rate
        from ecckd_tpu.models import temperature_fl_from_hl

        sp = read_spectrum(chain["h2o"], 0)
        nlay = len(sp.pressure_hl) - 1

        # LBL truth
        planck_hl = np.asarray(planck_function(
            sp.temperature_hl, sp.wavenumber, sp.d_wavenumber))
        fd_lbl, fu_lbl = rt_lw(planck_hl, sp.optical_depth,
                               np.ones_like(sp.wavenumber), planck_hl[-1])
        fd_lbl = np.asarray(fd_lbl).sum(-1)
        fu_lbl = np.asarray(fu_lbl).sum(-1)

        # CKD evaluation
        model = CkdModel.read(chain["lut"])
        p_hl = sp.pressure_hl[None, :]
        t_hl = sp.temperature_hl[None, :]
        t_fl = np.asarray(temperature_fl_from_hl(p_hl, t_hl))
        vmr = sp.vmr_fl[None, :]
        od = np.asarray(model.calc_optical_depth("h2o", p_hl, t_fl, vmr))[0]
        pl_hl = np.asarray(model.calc_planck_function(t_hl))[0]
        pl_surf = np.asarray(model.calc_planck_function(
            t_hl[:, -1]))[0]
        fd, fu = rt_lw(pl_hl, od, np.ones(model.ng), pl_surf)
        fd_ckd = np.asarray(fd).sum(-1)
        fu_ckd = np.asarray(fu).sum(-1)

        # Broadband fluxes should agree within a few W/m2 (transmission
        # averaging on a coarse synthetic spectrum)
        err_dn = np.abs(fd_ckd - fd_lbl).max()
        err_up = np.abs(fu_ckd - fu_lbl).max()
        assert err_dn < 0.05 * fd_lbl.max()
        assert err_up < 0.05 * fu_lbl.max()

    def test_streaming_and_sharded_match_dense(self, chain, tmp_path):
        """create_lut run in streaming mode (blocked
        hyperslab reads through ops.streaming) and in mesh-sharded mode
        must reproduce the dense in-memory result, including for the
        logarithmic methods the LW production configs select.

        Uses a non-saturating spectrum (od <~ 6): saturated transmission
        means (1 - mean ~ 1e-16) amplify summation-order noise through the
        -log1p(-mean) inversion, which would test float noise rather than
        the execution paths.
        """
        h2o = synth_spectrum_file(str(tmp_path / "h2o_small.h5"),
                                  molecule="h2o", nwav=1024, ncol=6,
                                  seed=3, od_scale=1e-3)
        for method in ("transmission", "logarithmic",
                       "hybrid-logarithmic-transmission-3"):
            base = {"input": chain["gpoints"], "gases": "h2o",
                    "averaging_method": method,
                    "h2o.conc_dependence": "linear",
                    "h2o.input": h2o}
            out_d = str(tmp_path / f"dense_{method}.nc")
            create_lut(Config({**base, "output": out_d, "streaming": "0",
                               "sharded": "0"}), argv=["c"])
            out_s = str(tmp_path / f"stream_{method}.nc")
            create_lut(Config({**base, "output": out_s, "streaming": "1",
                               "sharded": "0",
                               "streaming_block_wav": "300"}), argv=["c"])
            out_m = str(tmp_path / f"shard_{method}.nc")
            create_lut(Config({**base, "output": out_m, "streaming": "0",
                               "sharded": "1"}), argv=["c"])
            # Streaming AND sharding COMPOSED: blocks
            # streamed from disk, each psum-reduced over the mesh
            out_sm = str(tmp_path / f"stream_shard_{method}.nc")
            create_lut(Config({**base, "output": out_sm, "streaming": "1",
                               "sharded": "1",
                               "streaming_block_wav": "300"}), argv=["c"])
            ref = CkdModel.read(out_d).gas("h2o")
            for path in (out_s, out_m, out_sm):
                g = CkdModel.read(path).gas("h2o")
                np.testing.assert_allclose(g.molar_abs, ref.molar_abs,
                                           rtol=1e-6)
                np.testing.assert_allclose(g.min_molar_abs,
                                           ref.min_molar_abs, rtol=1e-9)
                np.testing.assert_allclose(g.max_molar_abs,
                                           ref.max_molar_abs, rtol=1e-9)

    def test_streaming_auto_triggers_on_memory_budget(self):
        from ecckd_tpu.tools.create_lut import _Execution
        ex = _Execution(Config({"streaming_memory_mb": "0.001"}))
        assert ex.use_streaming(15, 1024)
        ex = _Execution(Config({}))           # default 1 GB budget
        assert not ex.use_streaming(15, 1024)
        assert ex.use_streaming(50, 5_600_000)   # CKDMIP scale
        ex = _Execution(Config({"streaming": "1"}))
        assert ex.use_streaming(2, 2)

    def test_empty_gpoint_removal(self, chain, tmp_path):
        """Manually damage the g-point map so one g-point is empty and check
        create_lut removes it with a remap."""
        import shutil
        from scipy.io import netcdf_file
        damaged = str(tmp_path / "damaged.nc")
        shutil.copy(chain["gpoints"], damaged)
        f = netcdf_file(damaged, "a", mmap=False)
        var = f.variables["g_point"]
        gp = var.data.copy()
        ng = int(gp.max()) + 1
        # Reassign all wavenumbers of the middle g point to the previous
        # (keeping g_point.max() unchanged so the empty-g detection runs)
        gp[gp == ng - 2] = max(ng - 3, 0)
        var[:] = gp
        f.close()
        out = str(tmp_path / "lut2.nc")
        create_lut(Config({
            "input": damaged, "output": out, "gases": "h2o",
            "averaging_method": "linear",
            "h2o.conc_dependence": "linear",
            "h2o.input": chain["h2o"],
        }), argv=["create_lut"])
        model = CkdModel.read(out)
        f = NcFile(chain["gpoints"])
        ng_orig = f.size("band_number")[0]
        f.close()
        assert model.ng == ng_orig - 1
        # g-point mapping saved for scale_lut
        assert model.g_point is not None
