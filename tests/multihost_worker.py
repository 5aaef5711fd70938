"""Worker for the 2-process jax.distributed CPU test (SURVEY.md §5:
"multi-host tests on CPU jax.distributed with a fake 2-host mesh").

Launched twice by tests/test_multihost.py with JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID in the environment (exercising
initialize_from_env's env-variable path).  Each process owns 2 CPU
devices; the global mesh is (data=1, spectral=4).  Checks:

1. initialize_from_env reports multi-process mode, 2 processes, 4 devices.
2. local_shard_range partitions a work list without overlap.
3. The multi-controller wavenumber-sharded averaging (each process passes
   only its contiguous local slice) matches the dense single-host result
   computed from the shared seed.
4. A replicated-parameter gradient over process-spanning sharded data is
   psum'd by XLA to the global value.
"""

import sys

import numpy as np


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_num_cpu_devices", 2)

    from ecckd_tpu.parallel import distributed

    ok = distributed.initialize_from_env()
    assert ok, "initialize_from_env returned False under env configuration"
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 4, jax.device_count()
    assert jax.local_device_count() == 2
    pid = jax.process_index()

    r = distributed.local_shard_range(10)
    assert list(r) == list(range(pid * 5, pid * 5 + 5)), list(r)
    r = distributed.local_shard_range(7)   # uneven split
    assert list(r) == (list(range(0, 4)) if pid == 0 else list(range(4, 7)))

    # ---- multi-controller sharded averaging ----
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from ecckd_tpu.parallel import sharded_average_od_to_gpoints_multihost
    from ecckd_tpu.ops.average import average_od_to_gpoints

    mesh = Mesh(np.asarray(jax.devices()).reshape(1, 4),
                ("data", "spectral"))
    nz, nwav, ng = 5, 512, 6
    rng = np.random.default_rng(7)            # same seed on both processes
    od = 10.0 ** rng.uniform(-3, 0, (nz, nwav))
    od[:, rng.integers(0, nwav, 8)] = 0.0
    w = np.abs(rng.normal(1.0, 0.1, (nz, nwav)))
    gp = rng.integers(0, ng, nwav).astype(np.int32)

    half = nwav // 2
    sl = slice(pid * half, (pid + 1) * half)   # this process's local slice
    fit, mn, mx = sharded_average_od_to_gpoints_multihost(
        mesh, ng, gp[sl], od[:, sl], w[:, sl], "logarithmic")
    fit_ref, mn_ref, mx_ref = average_od_to_gpoints(ng, gp, od, w,
                                                    "logarithmic")
    np.testing.assert_allclose(fit, np.asarray(fit_ref), rtol=1e-9)
    np.testing.assert_allclose(mn, np.asarray(mn_ref), rtol=1e-12)
    np.testing.assert_allclose(mx, np.asarray(mx_ref), rtol=1e-12)

    # ---- STREAMED multi-controller sharded averaging:
    # each process reads its local slice in blocks (ragged last block),
    # per-round global assembly + psum, partials combined across rounds
    from ecckd_tpu.parallel import (
        streaming_sharded_average_od_to_gpoints_multihost)
    od_l, w_l, gp_l = od[:, sl], w[:, sl], gp[sl]
    fit2, mn2, mx2 = streaming_sharded_average_od_to_gpoints_multihost(
        mesh, ng, gp_l, lambda i0, nb: od_l[:, i0:i0 + nb], half,
        lambda i0, nb: w_l[:, i0:i0 + nb], "logarithmic", block_wav=100)
    np.testing.assert_allclose(fit2, np.asarray(fit_ref), rtol=1e-9)
    np.testing.assert_allclose(mn2, np.asarray(mn_ref), rtol=1e-12)
    np.testing.assert_allclose(mx2, np.asarray(mx_ref), rtol=1e-12)

    # ---- multi-controller SHARDED CANDIDATE SWEEP (r4): each process
    # contributes its contiguous wavenumber slice; costs must match the
    # single-device dense evaluation computed from the shared seed
    from ecckd_tpu.partition.cost_kernel import (CandidateCostLw,
                                                 CkdEquipartition)
    prng = np.random.default_rng(11)          # same seed on both processes
    nlay_s, nwav_s, nseg_s = 7, 256, 5
    p_hl = np.exp(np.linspace(np.log(100.0), np.log(1e5), nlay_s + 1))
    od_s = np.outer(np.linspace(0.05, 0.4, nlay_s),
                    np.sort(10.0 ** prng.uniform(-2, 1, nwav_s)))
    planck_s = np.abs(prng.normal(0.3, 0.05, (nlay_s + 1, nwav_s))) + 0.05
    lw_w = np.diff(np.sqrt(p_hl)); lw_w /= lw_w.sum()
    args_s = ("transmission", 0.02, lw_w, p_hl, np.ones(nwav_s),
              planck_s[-1], planck_s[-1] * 0.5, planck_s[0] * 0.8,
              planck_s, 0.05 * od_s, -np.expm1(-1.66 * od_s),
              prng.normal(0.0, 1e-5, (nlay_s, nwav_s)))
    dense = CandidateCostLw(*args_s, use_pallas=False)
    sharded = CandidateCostLw(*args_s, use_pallas=False, mesh=mesh)
    eq = CkdEquipartition(dense)
    edges = np.linspace(0, nwav_s, nseg_s + 1).astype(np.int32)
    i1s, i2s = edges[:-1], edges[1:] - 1
    seg_s = eq._seg_of_wav(i1s)
    np.testing.assert_allclose(sharded.costs(i1s, i2s, seg_s),
                               dense.costs(i1s, i2s, seg_s), rtol=1e-11)

    # ---- psum'd gradient over process-spanning data ----
    from jax.sharding import NamedSharding, PartitionSpec as P
    data_local = np.arange(pid * half, (pid + 1) * half, dtype=np.float64)
    data_g = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("spectral")), data_local, (nwav,))
    x = jax.device_put(jnp.asarray(3.0), NamedSharding(mesh, P()))

    @jax.jit
    def loss(x, d):
        return jnp.sum(x * d)

    g = jax.grad(loss)(x, data_g)
    expect = float(np.arange(nwav).sum())
    got = float(jax.device_get(g.addressable_data(0)))
    assert abs(got - expect) < 1e-6, (got, expect)

    print(f"MULTIHOST OK pid={pid}")


if __name__ == "__main__":
    sys.exit(main())
