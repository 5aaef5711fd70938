"""Cross-check the native OpenMP sweep baseline against the JAX kernel.

Two independent implementations of the LW candidate cost (transmission
method): csrc/sweep_baseline.cpp and partition/cost_kernel.CandidateCostLw.
Agreement on random inputs validates both (the native one feeds bench.py's
vs_baseline; the JAX one drives find_g_points).
"""

import numpy as np
import pytest

from ecckd_tpu.partition import cost_kernel
from ecckd_tpu.partition import native_baseline

needs_native = pytest.mark.skipif(not native_baseline.available(),
                                  reason="native baseline unavailable")


def build_problem(nlay=9, nwav=257, nseg=7, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    pressure_hl = np.exp(np.linspace(np.log(100.0), np.log(1.0e5), nlay + 1))
    k = np.sort(10.0 ** rng.uniform(-3, 1.5, nwav))
    col = (pressure_hl[1:] - pressure_hl[:-1]) / pressure_hl[-1]
    od = np.outer(col, k)
    bg_od = 0.05 * col[:, None] * np.ones((1, nwav))
    planck_hl = np.abs(rng.normal(0.3, 0.05, (nlay + 1, nwav))) + 0.05
    surf_planck = planck_hl[-1] * 1.05
    emis = np.full(nwav, 0.98)
    metric = -np.expm1(-1.66 * od)
    hr = rng.normal(0.0, 1e-5, (nlay, nwav))
    layer_weight = np.sqrt(pressure_hl[1:]) - np.sqrt(pressure_hl[:-1])
    layer_weight /= layer_weight.sum()
    flux_dn_surf = np.abs(rng.normal(0.2, 0.02, nwav))
    flux_up_toa = np.abs(rng.normal(0.25, 0.02, nwav))
    edges = np.sort(rng.choice(np.arange(1, nwav), nseg - 1,
                               replace=False))
    i1 = np.concatenate([[0], edges]).astype(np.int32)
    i2 = np.concatenate([edges - 1, [nwav - 1]]).astype(np.int32)
    seg_of_wav = np.repeat(np.arange(nseg, dtype=np.int32), i2 - i1 + 1)
    cast = lambda a: np.asarray(a, dtype)
    return dict(layer_weight=cast(layer_weight),
                pressure_hl=np.asarray(pressure_hl, np.float64),
                surf_emissivity=cast(emis), surf_planck=cast(surf_planck),
                flux_dn_surf=cast(flux_dn_surf),
                flux_up_toa=cast(flux_up_toa), planck_hl=cast(planck_hl),
                bg_od=cast(bg_od), metric=cast(metric), hr=cast(hr),
                i1=i1, i2=i2, seg_of_wav=seg_of_wav)


@needs_native
class TestNativeBaseline:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_jax_kernel(self, seed):
        p = build_problem(seed=seed)
        kernel = cost_kernel.CandidateCostLw(
            "transmission", 0.02, p["layer_weight"], p["pressure_hl"],
            p["surf_emissivity"], p["surf_planck"], p["flux_dn_surf"],
            p["flux_up_toa"], p["planck_hl"], p["bg_od"], p["metric"],
            p["hr"], use_pallas=False)
        jax_costs = kernel.costs(p["i1"], p["i2"], p["seg_of_wav"])
        native_costs = native_baseline.sweep_lw_cost_transmission(
            p["layer_weight"], p["pressure_hl"], p["surf_emissivity"],
            p["surf_planck"], p["flux_dn_surf"], p["flux_up_toa"],
            p["planck_hl"], p["bg_od"], p["metric"], p["hr"],
            p["i1"], p["i2"], 0.02)
        # Two f32 implementations with different reduction orders; the
        # pytest CPU path runs the JAX kernel in f64 via conftest x64, so
        # compare at f32-accumulation tolerance.
        np.testing.assert_allclose(native_costs, jax_costs, rtol=2e-4,
                                   atol=1e-7)

    def test_out_of_range_bounds_raise(self):
        p = build_problem()
        i1 = np.array([0], np.int32)
        i2 = np.array([10 ** 6], np.int32)
        with pytest.raises(ValueError, match="out of range"):
            native_baseline.sweep_lw_cost_transmission(
                p["layer_weight"], p["pressure_hl"], p["surf_emissivity"],
                p["surf_planck"], p["flux_dn_surf"], p["flux_up_toa"],
                p["planck_hl"], p["bg_od"], p["metric"], p["hr"],
                i1, i2, 0.02)


@needs_native
class TestSwCrossCheck:
    """Independent f64 C++ implementations of the SW candidate costs
    (csrc/crosscheck.cpp) vs the JAX kernels — the second-implementation
    oracle for math the compiled-reference oracles cannot reach (the
    reference's SW cost TUs depend on Adept)."""

    @pytest.mark.parametrize("seed", [0, 3])
    @pytest.mark.parametrize("albedo", [0.0, 0.15])
    def test_sw_transmission(self, seed, albedo):
        from test_sharded_sweep import sw_args, probe_batches
        args, _, p = sw_args("transmission", 311, seed=seed, albedo=albedo)
        kernel = cost_kernel.CandidateCostSw(*args, use_pallas=False)
        for i1, i2 in probe_batches(311, seed=seed + 1):
            seg = cost_kernel.CkdEquipartition(kernel)._seg_of_wav(i1)
            jax_costs = kernel.costs(i1, i2, seg)
            native = native_baseline.sw_cost_transmission(
                args[3], args[2], args[4], args[5], args[6], args[7],
                args[8], args[9], args[10], args[11], i1, i2, args[1])
            np.testing.assert_allclose(native, jax_costs, rtol=1e-12)

    @pytest.mark.parametrize("seed", [1, 4])
    def test_sw_total_transmission(self, seed):
        from test_sharded_sweep import sw_args, probe_batches
        args, extras, p = sw_args("total-transmission", 311, seed=seed)
        kernel = cost_kernel.CandidateCostSw(*args, extras=extras,
                                             use_pallas=False)
        for i1, i2 in probe_batches(311, seed=seed + 2):
            seg = cost_kernel.CkdEquipartition(kernel)._seg_of_wav(i1)
            jax_costs = kernel.costs(i1, i2, seg)
            native = native_baseline.sw_cost_total_transmission(
                args[3], args[2], args[4], args[5], args[6], args[9],
                args[10], extras, i1, i2, args[1])
            np.testing.assert_allclose(native, jax_costs, rtol=1e-12)

    def test_sw_vector_albedo(self):
        from test_sharded_sweep import sw_args, probe_batches
        args, _, p = sw_args("transmission", 200, seed=6, albedo=0.0)
        albedo_wav = np.zeros(200)
        albedo_wav[:90] = 0.2
        gas_args = list(args)
        gas_args[6] = albedo_wav
        kernel = cost_kernel.CandidateCostSw(*gas_args, use_pallas=False)
        i1, i2 = probe_batches(200, nseg=4, seed=9)[0]
        seg = cost_kernel.CkdEquipartition(kernel)._seg_of_wav(i1)
        native = native_baseline.sw_cost_transmission(
            args[3], args[2], args[4], args[5], albedo_wav, args[7],
            args[8], args[9], args[10], args[11], i1, i2, args[1])
        np.testing.assert_allclose(native, kernel.costs(i1, i2, seg),
                                   rtol=1e-12)


@needs_native
class TestGpointAverageCrossCheck:
    """All 8 g-point LUT averaging methods vs an independent f64 C++
    implementation (ref average_optical_depth.cpp:120-197 semantics)."""

    def _problem(self, nz=7, nwav=501, ng=6, seed=0):
        rng = np.random.default_rng(seed)
        od = rng.gamma(0.5, 0.4, (nz, nwav))
        od[od < 0.02] = 0.0          # exercise the logarithmic zero branch
        w = np.abs(rng.normal(1.0, 0.2, (nz, nwav)))
        gp = rng.integers(-1, ng, nwav).astype(np.int32)  # incl. unassigned
        pressure_fl = np.exp(np.linspace(np.log(20e2), np.log(900e2), nz))
        return od, w, gp, pressure_fl

    @pytest.mark.parametrize("method", [
        "linear", "transmission", "transmission-2", "transmission-3",
        "transmission-10", "square-root", "logarithmic",
        "hybrid-logarithmic-transmission-3"])
    def test_matches_jax(self, method):
        from ecckd_tpu.ops.average import average_od_to_gpoints
        od, w, gp, pf = self._problem()
        ng = 6
        kw = dict(pressure_fl=pf) if method.startswith("hybrid") else {}
        fit_j, mn_j, mx_j = (np.asarray(a) for a in
                             average_od_to_gpoints(ng, gp, od, w, method,
                                                   **kw))
        fit_n, mn_n, mx_n = native_baseline.gpoint_average(
            ng, gp, od, w, method,
            pressure_fl=pf if method.startswith("hybrid") else None)
        np.testing.assert_allclose(fit_n, fit_j, rtol=1e-12, atol=1e-300)
        np.testing.assert_allclose(mn_n, mn_j, rtol=1e-13)
        np.testing.assert_allclose(mx_n, mx_j, rtol=1e-13)

    def test_empty_gpoint(self):
        from ecckd_tpu.ops.average import average_od_to_gpoints
        od, w, gp, _ = self._problem(seed=2)
        gp[gp == 3] = 2              # g-point 3 empty
        fit_j, mn_j, mx_j = (np.asarray(a) for a in
                             average_od_to_gpoints(6, gp, od, w, "linear"))
        fit_n, mn_n, mx_n = native_baseline.gpoint_average(
            6, gp, od, w, "linear")
        assert np.all(fit_n[:, 3] == 0) and np.all(fit_j[:, 3] == 0)
        np.testing.assert_allclose(fit_n, fit_j, rtol=1e-12)
