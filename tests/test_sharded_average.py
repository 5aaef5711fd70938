"""Mesh-sharded g-point averaging vs streaming vs dense in-memory.

Validates the psum/pmin/pmax-combined wavenumber-sharded reduction
(parallel/sharded_average.py) on the 8-virtual-device CPU mesh against the
single-host streaming path AND the dense ops.average path, for ALL 8
averaging methods of average_optical_depth.cpp:120-197 (including the
logarithmic zero-counting and pressure-switched hybrid forms the LW
production configs select — create_lut_lw.sh:26-31).
"""

import numpy as np
import pytest

from ecckd_tpu.ops.average import (GPOINT_AVERAGING_METHODS,
                                   average_od_to_gpoints)
from ecckd_tpu.ops.streaming import (_block_accumulate,  # noqa: F401
                                     streaming_average_od_to_gpoints)
from ecckd_tpu.parallel import (make_mesh, sharded_average_od_to_gpoints,
                                streaming_sharded_average_od_to_gpoints)

NZ = 7
ALL_METHODS = list(GPOINT_AVERAGING_METHODS)
# Full-level pressures straddling the hybrid method's 100 hPa switch
PRESSURE_FL = np.linspace(20.0e2, 900.0e2, NZ)


def build_problem(nz=NZ, nwav=1000, ng=5, seed=0, zeros=True):
    rng = np.random.default_rng(seed)
    # Moderate od range: saturated transmissions make the -log(1-mean)
    # inversion ill-conditioned, which would only test float noise
    od = 10.0 ** rng.uniform(-4, 0.2, (nz, nwav))
    if zeros:
        # Exact zeros exercise the logarithmic method's nonzero counting
        od[:, rng.integers(0, nwav, 40)] = 0.0
    weight = np.abs(rng.normal(1.0, 0.2, (nz, nwav)))
    g_point = rng.integers(-1, ng, nwav).astype(np.int32)  # -1 = unassigned
    return od, weight, g_point


def streaming_result(od, weight, g_point, ng, method, block_wav=256):
    class FakeReader:
        def iter_blocks(self, block_wav):
            for i0 in range(0, od.shape[1], block_wav):
                yield i0, od[:, i0:i0 + block_wav]

    return streaming_average_od_to_gpoints(
        FakeReader(), ng, g_point,
        lambda i0, nb: weight[:, i0:i0 + nb], method, block_wav=block_wav,
        pressure_fl=PRESSURE_FL)


class TestAllPathsAgree:
    """In-memory, streaming, sharded, and
    streamed+sharded (composed) paths must agree for all 8 methods."""

    @pytest.mark.parametrize("method", ALL_METHODS)
    def test_four_paths(self, method):
        od, weight, g_point = build_problem()
        ng = 5
        fit_d, min_d, max_d = average_od_to_gpoints(
            ng, g_point, od, weight, method, pressure_fl=PRESSURE_FL)
        fit_s, min_s, max_s = streaming_result(od, weight, g_point, ng,
                                               method)
        mesh = make_mesh(data_parallel=1)
        assert mesh.shape["spectral"] > 1   # conftest provides 8 devices
        fit_m, min_m, max_m = sharded_average_od_to_gpoints(
            mesh, ng, g_point, od, weight, method,
            pressure_fl=PRESSURE_FL)

        # Composed: stream blocks, psum-reduce each over the mesh
        # (the 700 GB multi-chip execution)
        class FakeReader:
            def iter_blocks(self, block_wav):
                for i0 in range(0, od.shape[1], block_wav):
                    yield i0, od[:, i0:i0 + block_wav]

        fit_c, min_c, max_c = streaming_sharded_average_od_to_gpoints(
            mesh, FakeReader(), ng, g_point,
            lambda i0, nb: weight[:, i0:i0 + nb], method,
            block_wav=256, pressure_fl=PRESSURE_FL)

        fit_d, min_d, max_d = map(np.asarray, (fit_d, min_d, max_d))
        for fit, mn, mx in ((fit_s, min_s, max_s), (fit_m, min_m, max_m),
                            (fit_c, min_c, max_c)):
            np.testing.assert_allclose(fit, fit_d, rtol=1e-8)
            np.testing.assert_allclose(mn, min_d, rtol=1e-12)
            np.testing.assert_allclose(mx, max_d, rtol=1e-12)

    def test_log_all_zero_gpoint(self):
        """A g-point whose member wavenumbers are ALL zero od must fit 0
        (average_optical_depth.cpp:137-141)."""
        od, weight, g_point = build_problem(zeros=False)
        od[:, g_point == 2] = 0.0
        fit_d, _, _ = average_od_to_gpoints(5, g_point, od, weight,
                                            "logarithmic")
        fit_s, _, _ = streaming_result(od, weight, g_point, 5,
                                       "logarithmic")
        mesh = make_mesh(data_parallel=1)
        fit_m, _, _ = sharded_average_od_to_gpoints(
            mesh, 5, g_point, od, weight, "logarithmic")
        assert np.all(np.asarray(fit_d)[:, 2] == 0.0)
        assert np.all(fit_s[:, 2] == 0.0)
        assert np.all(fit_m[:, 2] == 0.0)


class TestShardedAverage:
    def test_unpadded_divisible(self):
        # nwav divisible by the mesh: no padding branch
        od, weight, g_point = build_problem(nwav=1024)
        mesh = make_mesh(data_parallel=1)
        fit_s, _, _ = sharded_average_od_to_gpoints(
            mesh, 5, g_point, od, weight, "linear")
        fit_r, _, _ = streaming_result(od, weight, g_point, 5, "linear")
        np.testing.assert_allclose(fit_s, fit_r, rtol=1e-10)

    def test_unsupported_method_raises(self):
        od, weight, g_point = build_problem()
        mesh = make_mesh(data_parallel=1)
        with pytest.raises(ValueError, match="does not support"):
            sharded_average_od_to_gpoints(mesh, 5, g_point, od, weight,
                                          "geometric")

    def test_hybrid_requires_pressure(self):
        od, weight, g_point = build_problem()
        mesh = make_mesh(data_parallel=1)
        with pytest.raises(ValueError, match="pressure_fl"):
            sharded_average_od_to_gpoints(
                mesh, 5, g_point, od, weight,
                "hybrid-logarithmic-transmission-3")

    def test_empty_gpoint(self):
        od, weight, g_point = build_problem()
        g_point[g_point == 3] = 0   # g-point 3 gets no wavenumbers
        mesh = make_mesh(data_parallel=1)
        fit_s, min_s, max_s = sharded_average_od_to_gpoints(
            mesh, 5, g_point, od, weight, "transmission")
        assert np.all(fit_s[:, 3] == 0.0)
        assert np.all(min_s[:, 3] == 0.0)
        assert np.all(max_s[:, 3] == 0.0)
