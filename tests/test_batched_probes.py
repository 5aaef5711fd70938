"""Adversarial batched-probe tests for CkdEquipartition.calc_error_many.

Each kernel evaluation can carry only one interval's fitted od per
wavenumber, so overlapping probe batches must be split into
non-overlapping groups.  These tests feed random overlapping, unsorted,
duplicated and gappy probe batches and assert exact equality with
one-probe-at-a-time evaluation, LW and SW, across averaging methods.
"""

import numpy as np
import pytest

from ecckd_tpu.partition.cost_kernel import (CandidateCostLw,
                                             CandidateCostSw,
                                             CkdEquipartition)
from test_native_baseline import build_problem

LW_METHODS = ["linear", "transmission", "transmission-2", "square-root",
              "logarithmic"]
SW_METHODS = ["linear", "transmission", "square-root", "logarithmic"]


def make_lw(method, seed=0):
    p = build_problem(seed=seed, dtype=np.float64)
    return CandidateCostLw(
        method, 0.02, p["layer_weight"], p["pressure_hl"],
        p["surf_emissivity"], p["surf_planck"], p["flux_dn_surf"],
        p["flux_up_toa"], p["planck_hl"], p["bg_od"],
        np.sqrt(p["metric"]) if method == "square-root" else p["metric"],
        p["hr"], use_pallas=False)


def make_sw(method, seed=0):
    p = build_problem(seed=seed, dtype=np.float64)
    rng = np.random.default_rng(seed + 100)
    ssi = np.abs(rng.normal(1.0, 0.1, p["metric"].shape[1]))
    return CandidateCostSw(
        method, 0.02, p["layer_weight"], 0.5, p["pressure_hl"], ssi,
        0.15, p["flux_dn_surf"], p["flux_up_toa"], p["bg_od"],
        np.sqrt(p["metric"]) if method == "square-root" else p["metric"],
        p["hr"], use_pallas=False)


def random_probes(npoints, n, seed, overlapping=True):
    """Random unsorted probe bounds in [0, 1]; with ``overlapping`` the
    intervals deliberately overlap and duplicate."""
    rng = np.random.default_rng(seed)
    if overlapping:
        b1 = rng.uniform(0.0, 0.9, n)
        b2 = b1 + rng.uniform(0.01, 0.5, n)
        b2 = np.minimum(b2, 1.0)
        # A couple of exact duplicates and a full-range probe
        b1[0], b2[0] = b1[1], b2[1]
        b1[-1], b2[-1] = 0.0, 1.0
    else:
        edges = np.sort(rng.uniform(0.0, 1.0, 2 * n))
        b1, b2 = edges[0::2], edges[1::2]
        perm = rng.permutation(n)     # unsorted order
        b1, b2 = b1[perm], b2[perm]
    return list(zip(b1, b2))


@pytest.mark.parametrize("method", LW_METHODS)
@pytest.mark.parametrize("overlapping", [True, False])
def test_lw_batched_equals_sequential(method, overlapping):
    eq = CkdEquipartition(make_lw(method))
    probes = random_probes(eq.npoints, 9, seed=3, overlapping=overlapping)
    batched = eq.calc_error_many(probes)
    single = np.array([eq.calc_error(b1, b2) for b1, b2 in probes])
    np.testing.assert_allclose(batched, single, rtol=1e-12)


@pytest.mark.parametrize("method", SW_METHODS)
def test_sw_batched_equals_sequential(method):
    eq = CkdEquipartition(make_sw(method))
    probes = random_probes(eq.npoints, 9, seed=5, overlapping=True)
    batched = eq.calc_error_many(probes)
    single = np.array([eq.calc_error(b1, b2) for b1, b2 in probes])
    np.testing.assert_allclose(batched, single, rtol=1e-12)


def test_partition_sweep_single_group():
    """The hot path — a non-overlapping partition batch — must stay a
    single kernel call (one group).  Bounds are chosen strictly between
    rank points: when bound*(npoints-1) is an exact integer, adjacent
    partition intervals share that rank under the reference's ceil/floor
    mapping (find_g_points.cpp:282-287) and are genuinely overlapping."""
    eq = CkdEquipartition(make_lw("transmission"))
    calls = []
    orig = eq.kernel.costs
    eq.kernel.costs = lambda i1, i2, seg=None: (calls.append(len(i1)),
                                                orig(i1, i2, seg))[1]
    n1 = eq.npoints - 1
    interior = (np.arange(1, 8) * (n1 // 8) + 0.5) / n1
    bounds = np.concatenate([[0.0], interior, [1.0]])
    eq.calc_error_many(list(zip(bounds[:-1], bounds[1:])))
    assert calls == [8], calls


def test_shared_rank_partition_splits_groups():
    """Exact-integer boundaries make adjacent intervals share one rank;
    the batch must split so each interval's flux uses its OWN fit for the
    shared rank (the round-1 single-pass assignment silently gave it the
    later interval's fit)."""
    eq = CkdEquipartition(make_lw("transmission"))
    n1 = eq.npoints - 1
    bounds = np.arange(0, n1 + 1, n1 // 4) / n1   # integer rank products
    probes = list(zip(bounds[:-1], bounds[1:]))
    batched = eq.calc_error_many(probes)
    single = np.array([eq.calc_error(b1, b2) for b1, b2 in probes])
    np.testing.assert_allclose(batched, single, rtol=1e-12)


def test_out_of_order_bounds_raise():
    eq = CkdEquipartition(make_lw("transmission"))
    with pytest.raises(ValueError, match="out of order"):
        eq.calc_error_many([(0.5, 0.2)])
