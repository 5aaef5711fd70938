"""Card-only checks: the fused sweep kernels compiled by the Triton route
against the XLA form on the same GPU.  They skip where JAX sees no GPU;
on a GPU machine run ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu
tests/``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecckd_tpu.ops.pallas.sweep_lw import rt_lw_bb_intervals_pallas
from ecckd_tpu.ops.pallas.sweep_sw import rt_sw_bb_intervals_pallas
from ecckd_tpu.ops.rt_lw import rt_lw_bb_intervals
from ecckd_tpu.ops.rt_sw import rt_sw_bb_intervals

pytestmark = pytest.mark.gpu


def _inputs(nlay=50, nwav=40000, nseg=16, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    edges = np.sort(rng.choice(np.arange(1, nwav), nseg - 1, replace=False))
    edges = np.concatenate([[0], edges, [nwav]]).astype(np.int32)
    i1, i2 = edges[:-1], edges[1:] - 1
    i2[3] = i1[4]                      # one shared boundary rank
    seg = np.maximum(0, np.searchsorted(i1, np.arange(nwav), "right") - 1)
    return dict(
        planck=f32(np.abs(rng.normal(5, 1, (nlay + 1, nwav)))),
        bg=f32(rng.gamma(0.5, 0.3, (nlay, nwav))),
        od_fit=f32(rng.gamma(0.5, 0.3, (nlay, nseg))),
        emis=f32(rng.uniform(0.9, 1.0, nwav)),
        surfp=f32(np.abs(rng.normal(8, 1, nwav))),
        ssi=f32(np.abs(rng.normal(2, 0.5, nwav))),
        i1=jnp.asarray(i1), i2=jnp.asarray(i2),
        seg=jnp.asarray(seg.astype(np.int32)))


def test_lw_kernel_compiled_matches_xla(gpu):
    with jax.default_device(gpu):
        d = _inputs()
        got = rt_lw_bb_intervals_pallas(d["planck"], d["bg"], d["od_fit"],
                                        d["seg"], d["emis"], d["surfp"],
                                        d["i1"], d["i2"])
        grey = jnp.take(d["od_fit"], d["seg"], axis=1)
        ref = rt_lw_bb_intervals(d["planck"], d["bg"], grey, d["emis"],
                                 d["surfp"], d["i1"], d["i2"])
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a)[1:], np.asarray(b)[1:],
                                   rtol=1e-5)


@pytest.mark.parametrize("with_up", [True, False])
def test_sw_kernel_compiled_matches_xla(gpu, with_up):
    with jax.default_device(gpu):
        d = _inputs(seed=1)
        got = rt_sw_bb_intervals_pallas(d["ssi"], d["bg"], d["od_fit"],
                                        d["seg"], d["i1"], d["i2"],
                                        cos_sza=0.5, albedo=0.2,
                                        with_upwelling=with_up)
        grey = jnp.take(d["od_fit"], d["seg"], axis=1)
        ref = rt_sw_bb_intervals(0.5, d["ssi"], d["bg"], grey, 0.2,
                                 d["i1"], d["i2"], with_upwelling=with_up)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4,
                                   atol=1e-6)
