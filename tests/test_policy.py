"""The execution policy: one place that resolves the per-platform choices
of the device path (fused sweep kernel, prefix sums, band batching,
auto-sharding, solver), with the platform injected."""

import jax
import numpy as np
import pytest

from ecckd_tpu.policy import ExecutionPolicy, default_platform, \
    execution_policy


def test_cpu_keeps_the_bit_stable_path():
    pol = execution_policy("cpu")
    assert pol == ExecutionPolicy("cpu")
    assert not (pol.fused_sweep or pol.prefix_sums or pol.band_parallel
                or pol.auto_shard)
    assert pol.solver == "scipy"


def test_gpu_choices():
    pol = execution_policy("gpu")
    assert pol.fused_sweep and pol.prefix_sums
    assert pol.band_parallel and pol.auto_shard
    assert pol.solver in ("scipy", "device")


@pytest.mark.parametrize("dtype,expect", [(np.float32, True),
                                          (np.float64, False)])
def test_kernel_and_prefix_only_for_float32(dtype, expect):
    pol = execution_policy("gpu")
    assert pol.sweep_kernel(dtype) is expect
    assert pol.prefix(dtype) is expect
    cpu = execution_policy("cpu")
    assert not cpu.sweep_kernel(dtype) and not cpu.prefix(dtype)


def test_unknown_platform_gets_the_plain_path():
    assert execution_policy("metal") == ExecutionPolicy("metal")


def test_default_platform_honours_default_device():
    cpu = jax.devices("cpu")[0]
    assert default_platform() == jax.default_backend()
    with jax.default_device(cpu):
        assert default_platform() == "cpu"
        assert execution_policy() == ExecutionPolicy("cpu")


def test_cost_kernels_take_their_defaults_from_the_policy():
    from ecckd_tpu.partition.cost_kernel import CandidateCostLw
    rng = np.random.default_rng(0)
    nlay, nwav = 3, 64
    f32 = lambda a: np.asarray(a, np.float32)
    planck = np.abs(rng.normal(5, 1, (nlay + 1, nwav)))
    kern = CandidateCostLw(
        "transmission", 0.02, f32(np.full(nlay, 1.0 / nlay)),
        f32(np.exp(np.linspace(4.6, 11.5, nlay + 1))), f32(np.ones(nwav)),
        f32(planck[-1]), f32(planck[-1]), f32(planck[0]), f32(planck),
        f32(rng.gamma(0.5, 0.1, (nlay, nwav))),
        f32(rng.uniform(0.1, 0.9, (nlay, nwav))), f32(np.zeros((nlay, nwav))))
    assert not kern.use_pallas and not kern.use_prefix   # on the CPU
