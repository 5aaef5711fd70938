"""Every f32 matrix product on the device path names its precision: at the
default precision a GPU may run an f32 dot in TF32 (a 10-bit mantissa on
the data operand), which would silently break the parity bounds.  Each
site must trace to ``Precision.HIGHEST`` and agree with a float64
reference."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

HIGHEST = jax.lax.Precision.HIGHEST


def _dot_precisions(fn, *args):
    """Precision config of every dot_general in ``fn``'s jaxpr."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def _data(seed=0, rows=7, n=3000, ng=6):
    rng = np.random.default_rng(seed)
    v = (10.0 ** rng.uniform(-3, 3, (rows, n))).astype(np.float32)
    gp = rng.integers(0, ng, n)
    onehot = (gp[:, None] == np.arange(ng)[None, :])
    ref = v.astype(np.float64) @ onehot.astype(np.float64)
    return v, onehot, ref


def _sites():
    from ecckd_tpu.ops.segments import _member_dot, segment_matmul
    from ecckd_tpu.ops.cost import _band_sum
    return {
        "member_dot": lambda v, m: _member_dot(v, m),
        "segment_matmul": lambda v, m: segment_matmul(
            v, m.astype(v.dtype)),
        "band_sum": lambda v, m: _band_sum(v, m.astype(v.dtype)),
    }


@pytest.mark.parametrize("site", ["member_dot", "segment_matmul",
                                  "band_sum"])
def test_membership_dots_are_highest_and_match_f64(site):
    v, onehot, ref = _data()
    fn = _sites()[site]
    precs = _dot_precisions(fn, jnp.asarray(v), jnp.asarray(onehot))
    assert precs and all(p == (HIGHEST, HIGHEST) for p in precs), precs
    got = np.asarray(fn(jnp.asarray(v), jnp.asarray(onehot)))
    np.testing.assert_allclose(got, ref, rtol=2e-6)


def test_interval_sum_fused_is_highest():
    from ecckd_tpu.ops.segments import interval_sum_fused, part_of
    v, _, _ = _data(rows=4, n=20000)
    i1 = np.array([0, 9000], np.int32)
    i2 = np.array([8999, 19999], np.int32)
    fn = lambda a: interval_sum_fused([part_of(a)], a.shape[-1], i1, i2,
                                      dtype=a.dtype, tile=8192)
    precs = _dot_precisions(fn, jnp.asarray(v))
    assert precs and all(p == (HIGHEST, HIGHEST) for p in precs), precs
    ref = np.stack([v[:, :9000].astype(np.float64).sum(1),
                    v[:, 9000:].astype(np.float64).sum(1)], axis=1)
    np.testing.assert_allclose(np.asarray(fn(jnp.asarray(v))), ref,
                               rtol=2e-6)


def test_sweep_chunk_reduction_is_highest():
    from ecckd_tpu.ops.pallas.sweep_lw import reduce_chunks
    rng = np.random.default_rng(3)
    partial = rng.normal(size=(40, 16)).astype(np.float32)
    seg = rng.integers(-1, 5, 40).astype(np.int32)
    precs = _dot_precisions(lambda p, s: reduce_chunks(p, s, 5),
                            jnp.asarray(partial), jnp.asarray(seg))
    assert precs == [(HIGHEST, HIGHEST)]
    got = np.asarray(reduce_chunks(jnp.asarray(partial), jnp.asarray(seg),
                                   5))
    ref = np.stack([partial[seg == s].astype(np.float64).sum(0)
                    for s in range(5)])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_prior_cost_dot_is_highest():
    import bench
    from ecckd_tpu.optimize import make_prior_fn, log_state_tree
    model, _ = bench.build_optimize_problem(ng=8, nt=3, npress=5, ncol=2,
                                            nlay=4)
    for g in model.single_gas_data:
        if g.is_active:
            g.inv_background_shape = np.eye(
                int(np.prod(g.molar_abs.shape[:-1])))
            g.background_error = np.full(g.molar_abs.shape[-1], 2.0)
    prior = make_prior_fn(model)
    tree = {k: jnp.asarray(np.asarray(v, np.float32))
            for k, v in log_state_tree(model).items()}
    shifted = {k: v + 0.1 for k, v in tree.items()}
    precs = _dot_precisions(lambda t: prior(t, tree), shifted)
    assert precs and all(p == (HIGHEST, HIGHEST) for p in precs), precs
