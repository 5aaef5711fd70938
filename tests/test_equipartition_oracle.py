"""Cross-validate the equipartition port against the REFERENCE C++ algorithm.

Compiles /root/reference/src/ecckd/equipartition.cpp (standard-library-only)
at test time with an original driver (oracle_equipartition_driver.cpp) and
compares partitions over a sweep of {npoints, ni, tolerance, ramp shape,
cubic interpolation} and equipartition_e target errors.  This directly
tests the 'equipartition fidelity' risk called out in SURVEY.md §7 (small
numeric drift changes g-point counts discretely); see PARITY.md for why
equipartition.cpp is the only reference TU an oracle can be built from in
this environment.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

from ecckd_tpu.partition.equipartition import Equipartition

REF_DIR = "/root/reference/src/ecckd"
HERE = os.path.dirname(os.path.abspath(__file__))


def build_oracle(tmp_dir):
    exe = os.path.join(tmp_dir, "oracle")
    src = os.path.join(HERE, "oracle_equipartition_driver.cpp")
    ref = os.path.join(REF_DIR, "equipartition.cpp")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", f"-I{REF_DIR}", "-o", exe, src, ref],
        check=True, capture_output=True, timeout=120)
    return exe


def run_oracle(exe, npoints, ni, tol, shape=0, cubic=0, target_scale=1.0):
    out = subprocess.run(
        [exe, str(npoints), str(ni), str(tol), str(shape), str(cubic),
         str(target_scale)],
        capture_output=True, text=True, check=True, timeout=300).stdout
    # The reference prints unguarded progress lines (e.g. "Shuffle"), so
    # keep only the driver's own key-value lines
    keys = ("status", "bounds", "error", "status_e", "bounds_e")
    lines = {}
    for l in out.splitlines():
        parts = l.split()
        if parts and parts[0] in keys:
            lines[parts[0]] = parts[1:]
    return lines


class PyRamp(Equipartition):
    """Mirror of the oracle driver's synthetic error functions (formulas
    must match oracle_equipartition_driver.cpp exactly)."""

    def __init__(self, npoints, shape=0):
        super().__init__()
        self.npoints = npoints
        x = np.arange(npoints) / (npoints - 1)
        if shape == 1:
            self.values = np.exp(-2.0 + 12.0 * x) * (1.5 + np.sin(40.0 * x))
        elif shape == 2:
            self.values = np.exp(12.0 * np.minimum(x, 0.6)) + 0.1 * x
        else:
            self.values = np.exp(-2.0 + 12.0 * x)
        self.total_comp_cost = 0.0

    def calc_error(self, bound1, bound2):
        self.total_comp_cost += bound2 - bound1
        i1 = int(np.ceil(bound1 * (self.npoints - 1)))
        i2 = int(np.floor(bound2 * (self.npoints - 1)))
        return abs(self.values[i1:i2 + 1].sum()
                   - (i2 - i1 + 1) * self.values[(i1 + i2) // 2])


def run_python(npoints, ni, tol, shape=0, cubic=0):
    te = PyRamp(npoints, shape)
    te.set_partition_max_iterations(200)
    te.set_line_search_max_iterations(15)
    te.set_partition_tolerance(tol)
    te.set_resolution(1.0 / npoints)
    te.set_cubic_interpolation(bool(cubic))
    bounds = np.linspace(0.0, 1.0, ni + 1)
    error = np.zeros(ni)
    status = te.equipartition_n(bounds, error)
    return status, bounds, error, te


needs_reference = pytest.mark.skipif(
    not os.path.exists(os.path.join(REF_DIR, "equipartition.cpp"))
    or shutil.which("g++") is None,
    reason="reference source or g++ unavailable")

# {npoints, ni, tolerance, ramp shape, cubic} sweep.
CASES = [
    # npoints, ni, tol, shape, cubic
    (100000, 16, 0.01, 0, 0),     # round-1 case
    (100000, 16, 0.05, 0, 0),     # looser tolerance
    (30000, 8, 0.02, 0, 0),       # smaller problem
    (100000, 16, 0.01, 1, 0),     # bumpy (sin-modulated) ramp
    (100000, 12, 0.02, 2, 0),     # plateau ramp (stresses line search)
    (100000, 16, 0.01, 0, 1),     # cubic interpolation
]


@needs_reference
class TestOracle:
    @pytest.fixture(scope="class")
    def exe(self, tmp_path_factory):
        return build_oracle(str(tmp_path_factory.mktemp("oracle")))

    @pytest.mark.parametrize("npoints,ni,tol,shape,cubic", CASES)
    def test_partition_matches_reference(self, exe, npoints, ni, tol,
                                         shape, cubic):
        oracle = run_oracle(exe, npoints, ni, tol, shape, cubic)
        status, bounds, error, te = run_python(npoints, ni, tol, shape,
                                               cubic)
        ref_status = int(oracle["status"][0])
        ref_bounds = np.array([float(x) for x in oracle["bounds"]])
        ref_error = np.array([float(x) for x in oracle["error"]])
        if ref_status == 0 and status.value == 0:
            # Both converged: SURVEY §7 demands the same partition (to
            # tolerance, not bitwise)
            np.testing.assert_allclose(bounds, ref_bounds, atol=2e-3)
            np.testing.assert_allclose(error, ref_error, rtol=0.1)
        else:
            # Non-converged multimodal cases stop mid-trajectory, where
            # bound positions legitimately diverge; the achieved
            # equalization quality must still be comparable (port no more
            # than 20% worse than the reference)
            fr_py = (error.max() - error.min()) / error.mean()
            fr_ref = (ref_error.max() - ref_error.min()) / ref_error.mean()
            assert fr_py <= fr_ref * 1.2 + 1e-12, (fr_py, fr_ref)

    @pytest.mark.parametrize("target_scale", [0.5, 1.0, 2.0])
    def test_target_error_interval_count_matches(self, exe, target_scale):
        """equipartition_e must find the same number of intervals as the
        reference across a range of target errors (g-point counts are the
        discretely-drifting quantity SURVEY §7 flags)."""
        npoints, ni, tol = 100000, 16, 0.01
        oracle = run_oracle(exe, npoints, ni, tol,
                            target_scale=target_scale)
        _, bounds, error, te = run_python(npoints, ni, tol)
        target = target_scale * error[0]
        status, bounds_e, error_e = te.equipartition_e(target, 0.0, 1.0)
        ref_ne = int(oracle["status_e"][2])   # line: "status_e <s> ne <n>"
        assert abs(len(error_e) - ref_ne) <= 1
        ref_status_e = int(oracle["status_e"][0])
        ref_bounds_e = np.array([float(x) for x in oracle["bounds_e"]])
        # Bound positions are only comparable when both sides converged;
        # the interval COUNT (asserted above) is the discretely-drifting
        # quantity that matters for g-point parity
        if (status.value == 0 and ref_status_e == 0
                and len(bounds_e) == len(ref_bounds_e)):
            np.testing.assert_allclose(bounds_e, ref_bounds_e, atol=5e-3)

    @pytest.mark.parametrize("shape", [1, 2])
    def test_target_error_other_ramps(self, exe, shape):
        npoints, ni, tol = 100000, 12, 0.02
        oracle = run_oracle(exe, npoints, ni, tol, shape=shape)
        _, bounds, error, te = run_python(npoints, ni, tol, shape=shape)
        status, bounds_e, error_e = te.equipartition_e(error[0], 0.0, 1.0)
        ref_ne = int(oracle["status_e"][2])
        assert abs(len(error_e) - ref_ne) <= 1
