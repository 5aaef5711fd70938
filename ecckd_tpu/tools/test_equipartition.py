"""test_equipartition: standalone exercise of the equipartition algorithm.

Equivalent of src/ecckd/test_equipartition.cpp:23-113: partitions
a synthetic exponential ramp (values = exp(linspace(-2, 10, n))) into N
intervals with the error |interval sum - width * midpoint value|, printing
bounds, errors, and convergence statistics.  Unlike the reference, exits
nonzero if the partition fails to reduce the fractional range.
"""

from __future__ import annotations

import sys

import numpy as np

from ..config import Config
from ..partition import Equipartition, EpStatus, ep_stats
from .common import tool_prologue


class RampEquipartition(Equipartition):
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


def test_equipartition(cfg: Config) -> int:
    npoints = cfg.read_int("npoints", default=1000000)
    ni = cfg.read_int("n_intervals", default=16)
    tolerance = cfg.read_float("partition_tolerance", default=0.001)

    rc = 0
    for cubic in (False, True):
        te = RampEquipartition(npoints)
        te.set_partition_max_iterations(200)
        te.set_line_search_max_iterations(15)
        te.set_partition_tolerance(tolerance)
        te.set_resolution(1.0 / npoints)
        te.set_cubic_interpolation(cubic)
        print("TESTING EQUIPARTITION SPECIFYING N"
              + (" (cubic interpolation)" if cubic else ""))
        bounds = np.linspace(0.0, 1.0, ni + 1)
        error = np.zeros(ni)
        init_range = ep_stats(te.calc_error_all(bounds))[3]
        te.invalidate()
        status = te.equipartition_n(bounds, error)
        print(f"***STATUS*** {status.describe()}")
        print(f"bounds = {np.array2string(bounds, precision=6)}")
        print(f"error  = {np.array2string(error, precision=4)}")
        print(f"  computational cost = {te.total_comp_cost:.2f}")
        mean, chi2, frac_std, frac_range = ep_stats(error)
        print(f"  mean error = {mean:.6g}\n  cost function = {chi2:.6g}\n"
              f"  frac std = {frac_std:.6g}\n  frac range = {frac_range:.6g}")
        if frac_range > init_range / 10:
            print("*** FAILED: fractional range not reduced 10x")
            rc = 1
    return rc


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cfg = tool_prologue(argv)
    sys.exit(test_equipartition(cfg))


if __name__ == "__main__":
    main()
