"""End-to-end optimize_lut test: the full LW pipeline on synthetic spectra.

reorder -> find_g_points -> create_lut -> (synthetic LBL training fluxes)
-> optimize_lut, checking that optimization reduces the flux/heating-rate
errors of the CKD model against the line-by-line truth.
"""

import numpy as np
import pytest

from ecckd_tpu.config import Config
from ecckd_tpu.io import NcFile
from ecckd_tpu.io.lbl_fluxes import LblFluxes
from ecckd_tpu.models import CkdModel
from ecckd_tpu.tools.reorder_spectrum import reorder_spectrum
from ecckd_tpu.tools.find_g_points import find_g_points
from ecckd_tpu.tools.create_lut import create_lut
from ecckd_tpu.tools.optimize_lut import optimize_lut
from synth import synth_spectrum_file, synth_lbl_flux_file


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    d = tmp_path_factory.mktemp("opt")
    h2o = synth_spectrum_file(str(d / "h2o.h5"), molecule="h2o",
                              nwav=1024, ncol=6, seed=3)
    order = str(d / "order.h5")
    reorder_spectrum(Config({"input": h2o, "output": order}), argv=["r"])
    gpoints = str(d / "gpoints.h5")
    find_g_points(Config({
        "output": gpoints, "gases": "h2o",
        "heating_rate_tolerance": "0.2",
        "averaging_method": "transmission",
        "h2o.reordering_input": order, "h2o.input": h2o,
    }), argv=["find_g_points"])
    lut = str(d / "lut_raw.nc")
    create_lut(Config({
        "input": gpoints, "output": lut, "gases": "h2o",
        "averaging_method": "transmission",
        "h2o.conc_dependence": "linear", "h2o.input": h2o,
    }), argv=["create_lut"])
    training = str(d / "training.nc")
    synth_lbl_flux_file(training, [h2o], gpoints, ["h2o"],
                        iprofiles=(0, 2, 4))
    return dict(d=d, h2o=h2o, gpoints=gpoints, lut=lut, training=training)


def ckd_flux_errors(model_path, training_path):
    """RMS broadband flux error of a CKD model vs LBL truth."""
    from ecckd_tpu.optimize.cost_fn import build_scene, make_total_od_fn
    from ecckd_tpu.optimize.solver import log_state_tree
    import jax.numpy as jnp

    model = CkdModel.read(model_path, active_gas_list=["h2o"])
    lbl = LblFluxes.read(training_path)
    lbl.make_gas_mapping(model.molecules)
    lbl.planck_hl = np.asarray(
        model.calc_planck_function(lbl.temperature_hl))
    lbl.surf_planck = np.asarray(
        model.calc_planck_function(lbl.temperature_hl[:, -1]))
    scene, meta = build_scene(model, lbl)
    od_fn = make_total_od_fn(model, meta)
    tree = {k: jnp.asarray(v) for k, v in log_state_tree(model).items()}
    od = np.asarray(od_fn(tree, scene))
    lbl.iband_per_g = None
    fd, fu = lbl.calc_ckd_fluxes(od)
    err_dn = np.sqrt(np.mean((fd.sum(-1) - lbl.flux_dn) ** 2))
    err_up = np.sqrt(np.mean((fu.sum(-1) - lbl.flux_up) ** 2))
    # Broadband heating-rate RMS error in K/day
    from ecckd_tpu import constants as c
    conv = (-(c.ACCEL_GRAVITY / c.SPECIFIC_HEAT_AIR)
            / np.diff(lbl.pressure_hl, axis=1)) * c.HR_WEIGHT
    hr_ckd = conv * (np.diff(fd.sum(-1), axis=1)
                     - np.diff(fu.sum(-1), axis=1))
    err_hr = np.sqrt(np.mean((hr_ckd - lbl.heating_rate * c.HR_WEIGHT) ** 2))
    return err_dn, err_up, err_hr


class TestLblFluxes:
    def test_read(self, pipeline):
        lbl = LblFluxes.read(pipeline["training"])
        assert not lbl.is_sw
        assert lbl.have_spectral_fluxes and not lbl.have_band_fluxes
        assert lbl.molecules == ["h2o"]
        assert lbl.ncol == 3
        # hr consistency: spectral heating rates sum to broadband
        np.testing.assert_allclose(lbl.spectral_heating_rate.sum(-1),
                                   lbl.heating_rate, rtol=1e-6)

    def test_gas_mapping(self, pipeline):
        lbl = LblFluxes.read(pipeline["training"])
        lbl.make_gas_mapping(["co2", "h2o", "o3"])
        np.testing.assert_array_equal(lbl.gas_mapping, [-1, 0, -1])


class TestOptimizeLut:
    def test_optimization_improves_fluxes(self, pipeline, tmp_path):
        out = str(tmp_path / "lut_opt.nc")
        rc = optimize_lut(Config({
            "input": pipeline["lut"], "output": out,
            "gases": "h2o",
            "training_input": pipeline["training"],
            "max_iterations": "60",
            "convergence_criterion": "0.002",
            "prior_error": "4.0",
            "flux_weight": "0.02",
            "broadband_weight": "0.5",
        }), argv=["optimize_lut"])
        assert rc == 0

        err_before = ckd_flux_errors(pipeline["lut"], pipeline["training"])
        err_after = ckd_flux_errors(out, pipeline["training"])
        # The cost function minimizes heating-rate + boundary-flux errors:
        # downwelling and heating-rate errors must improve substantially,
        # upwelling (already near-optimal from the averaging) must not
        # degrade appreciably
        assert err_after[0] < 0.7 * err_before[0]   # surface/boundary dn
        assert err_after[2] < 0.7 * err_before[2]   # heating rate
        assert err_after[1] < err_before[1] * 1.25 + 0.05

        # Output model is a valid ckd-definition file with provenance
        f = NcFile(out)
        assert "optimize_lut" in f.attribute("history")
        assert "create_lut" in f.attribute("history")
        f.close()

    def test_bounds_respected(self, pipeline, tmp_path):
        out = str(tmp_path / "lut_opt_b.nc")
        optimize_lut(Config({
            "input": pipeline["lut"], "output": out, "gases": "h2o",
            "training_input": pipeline["training"],
            "max_iterations": "20", "prior_error": "4.0",
            "bounded_minimization": "1",
        }), argv=["optimize_lut"])
        before = CkdModel.read(pipeline["lut"])
        after = CkdModel.read(out)
        g0 = before.gas("h2o")
        g1 = after.gas("h2o")
        pos = g0.molar_abs > 0
        assert np.all(g1.molar_abs[pos] <= g0.max_molar_abs[pos] * (1 + 1e-9))
        assert np.all(g1.molar_abs[pos] >= g0.min_molar_abs[pos]
                      * np.where(g0.min_molar_abs[pos] > 0, 1 - 1e-9, 0.0))
        # Exact zeros stay zero
        assert np.all(g1.molar_abs[~pos] == 0.0)

    def test_remove_min_max(self, pipeline, tmp_path):
        out = str(tmp_path / "lut_final.nc")
        optimize_lut(Config({
            "input": pipeline["lut"], "output": out, "gases": "h2o",
            "training_input": pipeline["training"],
            "max_iterations": "3", "prior_error": "4.0",
            "remove_min_max": "1",
        }), argv=["optimize_lut"])
        f = NcFile(out)
        assert not f.exist("h2o_molar_absorption_coeff_min")
        f.close()


    def test_device_scipy_final_cost_parity(self, pipeline):
        """The projected on-device L-BFGS must reach a final cost
        comparable to scipy's bounded L-BFGS-B on a problem with zero-k
        sentinels and active min/max bounds, so either may be the
        execution policy's solver=auto."""
        from ecckd_tpu.io.lbl_fluxes import LblFluxes
        from ecckd_tpu.optimize.solver import solve
        from ecckd_tpu.tools.optimize_lut import _prepare_lbl

        costs = {}
        for sv in ("scipy", "device"):
            model = CkdModel.read(pipeline["lut"], active_gas_list=["h2o"])
            lbl = LblFluxes.read(pipeline["training"])
            _prepare_lbl(lbl, model, 1e4)
            res = solve(model, [lbl], prior_error=4.0, flux_weight=0.02,
                        broadband_weight=0.5, max_iterations=400,
                        convergence_criterion=1e-4, solver=sv)
            costs[sv] = res.cost
            assert np.isfinite(res.cost)
        # Projection-after-update is not an active-set method, so exact
        # equality is not expected — but the minima must agree closely
        assert costs["device"] <= costs["scipy"] * 1.05 + 1e-12
        assert costs["scipy"] <= costs["device"] * 1.05 + 1e-12

    def test_device_solver_matches_scipy(self, pipeline, tmp_path):
        """solver=device: the whole L-BFGS loop runs on device (optax,
        chunked lax.while_loop).  It must improve the fluxes like the scipy
        L-BFGS-B path and respect bounds (projection) and zero sentinels."""
        out = str(tmp_path / "lut_opt_dev.nc")
        rc = optimize_lut(Config({
            "input": pipeline["lut"], "output": out, "gases": "h2o",
            "training_input": pipeline["training"],
            "max_iterations": "60", "convergence_criterion": "0.002",
            "prior_error": "4.0", "flux_weight": "0.02",
            "broadband_weight": "0.5", "bounded_minimization": "1",
            "solver": "device",
        }), argv=["optimize_lut"])
        assert rc == 0

        err_before = ckd_flux_errors(pipeline["lut"], pipeline["training"])
        err_after = ckd_flux_errors(out, pipeline["training"])
        assert err_after[0] < 0.7 * err_before[0]
        assert err_after[2] < 0.7 * err_before[2]

        before = CkdModel.read(pipeline["lut"])
        after = CkdModel.read(out)
        g0 = before.gas("h2o")
        g1 = after.gas("h2o")
        pos = g0.molar_abs > 0
        assert np.all(g1.molar_abs[pos] <= g0.max_molar_abs[pos]
                      * (1 + 1e-9))
        assert np.all(g1.molar_abs[pos] >= g0.min_molar_abs[pos]
                      * np.where(g0.min_molar_abs[pos] > 0, 1 - 1e-9, 0.0))
        assert np.all(g1.molar_abs[~pos] == 0.0)
