"""Double-float prefix-sum fast path for repeated interval reductions.

The r5 production sweep path: the fit/truth interval
sums of the candidate-cost kernels are precomputed ONCE per band as
double-float prefix sums and each sweep gathers interval differences,
eliminating the per-sweep spectral reduction pass entirely.  These tests
assert (a) the prefix interval sums match the membership-matmul form,
(b) the f32 double-float representation beats plain-f32 cumsum error by
orders of magnitude, and (c) the candidate-cost kernels give identical
partitions/costs with and without the fast path.
"""

import numpy as np
import pytest

from ecckd_tpu.ops.segments import (build_prefix_sums,
                                    interval_sum_from_prefix,
                                    interval_sum_fused, part_of)
from ecckd_tpu.partition.cost_kernel import (CandidateCostLw,
                                             CandidateCostSw,
                                             CkdEquipartition)
from test_native_baseline import build_problem
from test_sharded_sweep import lw_args, sw_args, probe_batches


def _inputs(nlay=7, nwav=3001, nseg=5, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a2 = np.abs(rng.normal(1.0, 0.3, (nlay, nwav))).astype(dtype)
    b2 = np.abs(rng.normal(2.0, 0.5, (nlay, nwav))).astype(dtype)
    v1 = rng.normal(0.0, 1.0, nwav).astype(dtype)
    edges = np.linspace(0, nwav, nseg + 1).astype(np.int32)
    return a2, b2, v1, edges[:-1], edges[1:] - 1


class TestPrefixIntervalSums:
    def test_matches_fused_f64(self):
        a2, b2, v1, i1, i2 = _inputs()
        parts = [part_of(a2, b2), part_of(b2), part_of(v1)]
        ref = np.asarray(interval_sum_fused(parts, a2.shape[-1], i1, i2,
                                            dtype=a2.dtype))
        hi, lo = build_prefix_sums(parts, a2.shape[-1])
        got = np.asarray(interval_sum_from_prefix(hi, lo, i1, i2))
        np.testing.assert_allclose(got, ref, rtol=1e-12)

    def test_overlapping_and_shared_boundaries(self):
        a2, _, v1, _, _ = _inputs(nwav=2000, seed=3)
        i1 = np.array([0, 500, 500, 1999], np.int32)
        i2 = np.array([500, 1999, 1200, 1999], np.int32)
        parts = [part_of(a2), part_of(v1)]
        ref = np.asarray(interval_sum_fused(parts, 2000, i1, i2,
                                            dtype=a2.dtype))
        hi, lo = build_prefix_sums(parts, 2000)
        got = np.asarray(interval_sum_from_prefix(hi, lo, i1, i2))
        np.testing.assert_allclose(got, ref, rtol=1e-12)

    def test_row_chunking_and_bucket_padding(self):
        """Rows beyond one chunk and a non-power-of-two column count (the
        bucketed scan shape) must reduce identically."""
        a2, b2, v1, i1, i2 = _inputs(nlay=9, nwav=777, seed=5)
        parts = [part_of(a2, b2), part_of(b2), part_of(v1, a2)]
        ref = np.asarray(interval_sum_fused(parts, 777, i1, i2,
                                            dtype=a2.dtype))
        hi, lo = build_prefix_sums(parts, 777, row_chunk=4)
        assert hi.shape == (27, 778)   # 9 + 9 + 9 (v1 broadcasts over a2)
        got = np.asarray(interval_sum_from_prefix(hi, lo, i1, i2))
        np.testing.assert_allclose(got, ref, rtol=1e-12)

    def test_f32_double_float_precision(self):
        """f32 double-float prefix differences must stay within ~1e-6 of
        the f64 truth even for a small interval at the END of a large
        prefix (the cancellation-amplified case a plain f32 cumsum fails:
        its error there is ~n*eps relative to the interval sum)."""
        rng = np.random.default_rng(7)
        n = 1 << 17
        v64 = np.abs(rng.normal(1.0, 0.3, (2, n)))
        v32 = v64.astype(np.float32)
        i1 = np.array([0, n - 64, n // 2], np.int32)
        i2 = np.array([n - 1, n - 1, n // 2 + 9], np.int32)
        truth = np.stack([v64[:, a:b + 1].sum(-1)
                          for a, b in zip(i1, i2)], -1)
        hi, lo = build_prefix_sums([part_of(v32)], n)
        got = np.asarray(interval_sum_from_prefix(hi, lo, i1, i2),
                         np.float64)
        rel = np.abs(got - truth) / truth
        assert rel.max() < 1e-6, rel.max()
        # Plain f32 cumsum difference on the same tail interval is
        # orders of magnitude worse — the double-float split is load-
        # bearing, not decorative.
        c32 = np.concatenate([np.zeros((2, 1), np.float32),
                              np.cumsum(v32, -1, dtype=np.float32)], -1)
        naive = (c32[:, i2[1] + 1] - c32[:, i1[1]]).astype(np.float64)
        naive_rel = np.abs(naive - truth[:, 1]) / truth[:, 1]
        assert naive_rel.max() > 100 * rel.max()

    def test_custom_callable_parts(self):
        """Non-part_of parts (the logarithmic fit's masked-log producer)
        materialize through the same builder."""
        import jax
        a2, _, _, i1, i2 = _inputs(nwav=1500, seed=9)

        def custom(start, size):
            sl = jax.lax.dynamic_slice_in_dim(a2, start, size, axis=1)
            return np.float64(2.0) * sl

        parts = [custom, part_of(a2)]
        ref = np.asarray(interval_sum_fused(parts, 1500, i1, i2,
                                            dtype=a2.dtype))
        hi, lo = build_prefix_sums(parts, 1500)
        got = np.asarray(interval_sum_from_prefix(hi, lo, i1, i2))
        np.testing.assert_allclose(got, ref, rtol=1e-12)


LW_METHODS = ["linear", "transmission", "logarithmic", "square-root"]
SW_METHODS = ["linear", "transmission", "logarithmic", "total-transmission"]


def assert_prefix_matches(make_plain, make_prefix, rtol=1e-9):
    plain = make_plain()
    fast = make_prefix()
    assert fast.use_prefix and not plain.use_prefix
    eq = CkdEquipartition(plain)
    for i1, i2 in probe_batches(plain.npoints):
        seg = eq._seg_of_wav(i1)
        np.testing.assert_allclose(fast.costs(i1, i2, seg),
                                   plain.costs(i1, i2, seg), rtol=rtol)


@pytest.mark.parametrize("method", LW_METHODS)
def test_lw_prefix_equals_plain(method):
    args, _ = lw_args(method, 257)
    assert_prefix_matches(
        lambda: CandidateCostLw(*args, use_pallas=False, use_prefix=False),
        lambda: CandidateCostLw(*args, use_pallas=False, use_prefix=True))


@pytest.mark.parametrize("method", SW_METHODS)
def test_sw_prefix_equals_plain(method):
    args, extras, _ = sw_args(method, 256)
    assert_prefix_matches(
        lambda: CandidateCostSw(*args, extras=extras, use_pallas=False,
                                use_prefix=False),
        lambda: CandidateCostSw(*args, extras=extras, use_pallas=False,
                                use_prefix=True))


def test_lw_prefix_with_pallas_interpret():
    """The production GPU combination: prefix fit/truth gathers + the
    fused Pallas sweep kernel (interpret mode on CPU)."""
    args, _ = lw_args("transmission", 300)
    plain = CandidateCostLw(*args, use_pallas=False, use_prefix=False)
    fast = CandidateCostLw(*args, use_pallas=True, pallas_interpret=True,
                           use_prefix=True)
    eq = CkdEquipartition(plain)
    i1, i2 = probe_batches(plain.npoints)[0]
    seg = eq._seg_of_wav(i1)
    np.testing.assert_allclose(fast.costs(i1, i2, seg),
                               plain.costs(i1, i2, seg), rtol=1e-6)


def test_equipartition_identical_partition():
    """Partition refinement decisions (the determinism-sensitive iterative
    search, bounded by max_iterations) must not move between the plain and
    prefix paths in f64."""
    from ecckd_tpu.tools.find_g_points import _sqrt_bounds
    args, _ = lw_args("transmission", 512, seed=2)
    out = {}
    for tag, up in (("plain", False), ("prefix", True)):
        kern = CandidateCostLw(*args, use_pallas=False, use_prefix=up)
        eq = CkdEquipartition(kern)
        eq.set_verbose(False)
        eq.set_partition_max_iterations(8)
        bounds = _sqrt_bounds(6)
        errors = np.zeros(6)
        eq.equipartition_n(bounds, errors)
        out[tag] = (np.asarray(bounds), np.asarray(errors))
    np.testing.assert_allclose(out["plain"][0], out["prefix"][0],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(out["plain"][1], out["prefix"][1],
                               rtol=1e-9)


def test_chained_bench_fn_matches_costs():
    """bench.py's single-dispatch chained harness must produce the same
    cost sum as eager per-call evaluation, on both paths."""
    import jax.numpy as jnp
    args, _ = lw_args("transmission", 256, seed=4)
    for up in (False, True):
        kern = CandidateCostLw(*args, use_pallas=False, use_prefix=up)
        eq = CkdEquipartition(kern)
        i1, i2 = probe_batches(kern.npoints)[0]
        seg = eq._seg_of_wav(i1)
        expect = np.sum(kern.costs(i1, i2, seg)) * 1e-30
        got = kern.chained_bench_fn()(
            kern._bound_arrays, jnp.asarray(i1), jnp.asarray(i2), 1)
        # The harness carry is f32 (kernels may be f64 in tests)
        np.testing.assert_allclose(float(got), expect, rtol=1e-6)


def test_pad_to_bucket_powers_of_two():
    """Probe batches pad to power-of-two buckets, so a band's hundreds of
    probes compile at most log2(batch) sweep kernels, and padded columns
    do not change the real ones' costs."""
    from ecckd_tpu.partition import cost_kernel as ck
    assert [ck._pad_to_bucket(n) for n in (0, 1, 2, 3, 5, 64, 65)] == \
        [1, 1, 2, 4, 8, 64, 128]
    args, _ = lw_args("transmission", 256, seed=8)
    kern = CandidateCostLw(*args, use_pallas=False)
    eq = CkdEquipartition(kern)
    i1, i2 = probe_batches(kern.npoints)[0]
    seg = eq._seg_of_wav(i1)
    base = kern.costs(i1, i2, seg)
    one = [kern.costs(i1[k:k + 1], i2[k:k + 1], seg)[0]
           for k in range(len(i1))]
    np.testing.assert_allclose(one, base, rtol=1e-13)
