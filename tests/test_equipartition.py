"""Equipartition solver tests on the reference's synthetic exponential ramp.

Mirrors src/ecckd/test_equipartition.cpp:23-113 (values = exp(linspace(-2,10))
with error = |interval sum - width * midpoint value|), but with actual
assertions: convergence status, monotone bounds, and a small fractional
range; plus a target-error (equipartition_e) round trip.
"""

import numpy as np
import pytest

from ecckd_tpu.partition import Equipartition, EpStatus, ep_stats


class RampEquipartition(Equipartition):
    """Synthetic error function from test_equipartition.cpp:24-37."""

    def __init__(self, npoints):
        super().__init__()
        self.npoints = npoints
        self.values = np.exp(np.linspace(-2.0, 10.0, npoints))
        self.total_comp_cost = 0.0

    def calc_error(self, bound1, bound2):
        self.total_comp_cost += bound2 - bound1
        i1 = int(np.ceil(bound1 * (self.npoints - 1)))
        i2 = int(np.floor(bound2 * (self.npoints - 1)))
        return abs(self.values[i1:i2 + 1].sum()
                   - (i2 - i1 + 1) * self.values[(i1 + i2) // 2])


@pytest.fixture
def ramp():
    te = RampEquipartition(100000)
    te.set_partition_max_iterations(200)
    te.set_line_search_max_iterations(15)
    # The reference uses 1e6 points with tolerance 0.001; at 1e5 points the
    # discrete resolution floor is ~0.005, so target 0.01.
    te.set_partition_tolerance(0.01)
    te.set_resolution(1.0 / te.npoints)
    return te


class TestEquipartitionN:
    def test_converges_16_intervals(self, ramp):
        ni = 16
        bounds = np.linspace(0.0, 1.0, ni + 1)
        error = np.zeros(ni)
        status = ramp.equipartition_n(bounds, error)
        assert status in (EpStatus.SUCCESS, EpStatus.RESOLUTION_LIMIT_REACHED,
                          EpStatus.MAX_ITERATIONS_REACHED)
        assert np.all(np.diff(bounds) > 0)
        assert bounds[0] == 0.0 and bounds[-1] == 1.0
        mean, chi2, frac_std, frac_range = ep_stats(error)
        # The reference reaches frac_range ~1e-3 on this problem; allow some
        # slack for the discrete resolution limit.
        assert frac_range < 0.05
        # Errors should be far more equal than the initial uniform partition
        init_err = ramp.calc_error_all(np.linspace(0, 1, ni + 1))
        _, _, _, init_range = ep_stats(init_err)
        assert frac_range < init_range / 50

    def test_two_intervals(self, ramp):
        bounds = np.array([0.0, 0.5, 1.0])
        error = np.zeros(2)
        status = ramp.equipartition_n(bounds, error)
        assert status in (EpStatus.SUCCESS, EpStatus.RESOLUTION_LIMIT_REACHED,
                          EpStatus.MAX_ITERATIONS_REACHED)
        assert abs(error[0] - error[1]) / (error[0] + error[1]) < 0.05

    def test_input_error_on_nonmonotonic(self, ramp):
        bounds = np.array([0.0, 0.6, 0.4, 1.0])
        error = np.zeros(3)
        assert ramp.equipartition_n(bounds, error) == EpStatus.INPUT_ERROR


class TestEquipartitionE:
    def test_target_error_partition(self, ramp):
        # First find the error level of a 16-interval partition, then ask
        # equipartition_e to hit that per-interval error
        ni = 16
        bounds = np.linspace(0.0, 1.0, ni + 1)
        error = np.zeros(ni)
        ramp.equipartition_n(bounds, error)
        target = error[0]

        te2 = RampEquipartition(100000)
        te2.set_partition_max_iterations(200)
        te2.set_partition_tolerance(0.001)
        te2.set_resolution(1.0 / te2.npoints)
        status, bounds2, error2 = te2.equipartition_e(target, 0.0, 1.0)
        # The bound search is conservative (approaches the target error from
        # below), so it may produce more intervals than strictly needed, but
        # never fewer; the mean per-interval error must not exceed the target.
        assert len(error2) >= ni
        assert np.all(np.diff(bounds2) > 0)
        assert bounds2[0] == 0.0 and bounds2[-1] == 1.0
        assert error2.mean() <= target * 1.05

    def test_single_interval_when_error_small(self, ramp):
        big_target = 1e12
        status, bounds, error = ramp.equipartition_e(big_target, 0.0, 1.0)
        assert status == EpStatus.SUCCESS
        assert len(error) == 1


class TestInvalidate:
    def test_repartition_after_external_reinit_recomputes_errors(self, ramp):
        """find_g_points' sqrt-spaced re-initialization
        overwrites bounds/error from outside the solver (min/max g-point
        overrides, find_g_points.cpp:1221-1248).  After invalidate(), the
        next equipartition_n must recompute errors for the NEW bounds
        rather than optimizing against the stale cached ones."""
        ni = 8
        bounds = np.linspace(0.0, 1.0, ni + 1)
        error = np.zeros(ni)
        ramp.equipartition_n(bounds, error)
        # Simulate the solver state after a successful line search (the
        # flag's final state after equipartition_n is not guaranteed)
        ramp._errors_up_to_date = True

        # External re-initialization, as the tool does after a sqrt re-init
        new_bounds = np.sqrt(np.arange(ni + 1) / ni)
        new_error = np.zeros(ni)     # wrong (stale) errors on purpose
        ramp.invalidate()
        assert not ramp._errors_up_to_date
        ramp.equipartition_n(new_bounds, new_error)
        # The solver evaluated the fresh bounds: the reported errors match
        # a direct evaluation and are not the stale zeros
        np.testing.assert_allclose(
            new_error, ramp.calc_error_all(new_bounds), rtol=1e-12)
        assert np.any(new_error != 0.0)
