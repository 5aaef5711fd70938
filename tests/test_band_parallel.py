"""Cross-band probe batching (band_parallel) vs the sequential band loop.

Bands are independent, so each equipartition iteration
can batch its probes across all bands of a gas into one device dispatch.
These tests assert (a) the gas-level kernel evaluates band probes
identically to per-band kernels, (b) the threaded parallel mode produces
BIT-identical partitions to the sequential gas-kernel mode (same kernel,
batch-independent costs), (c) the legacy per-band mode agrees structurally,
and (d) the dispatch count drops by ~nband.
"""

import numpy as np
import pytest

from ecckd_tpu.config import Config
from ecckd_tpu.io import NcFile
from ecckd_tpu.partition import cost_kernel
from ecckd_tpu.partition.band_parallel import (BandKernelView,
                                               ProbeScheduler)
from ecckd_tpu.partition.cost_kernel import (CandidateCostLw,
                                             CandidateCostSw,
                                             CkdEquipartition)
from ecckd_tpu.tools.find_g_points import find_g_points
from ecckd_tpu.tools.reorder_spectrum import reorder_spectrum
from synth import synth_spectrum_file
from test_sharded_sweep import lw_args, sw_args


def test_gas_kernel_band_probes_match_per_band():
    """Probes of a band evaluated on the whole-gas kernel (global bounds +
    global seg map) must match the band-sliced kernel to f64 summation-
    order differences."""
    args, p = lw_args("transmission", 384)
    nwav = 384
    # Treat [0, 128) and [128, 384) as two "bands"
    for b1, b2 in ((0, 127), (128, 383)):
        n = b2 - b1 + 1
        sliced = CandidateCostLw(
            args[0], args[1], args[2], args[3], args[4][b1:b2 + 1],
            args[5][b1:b2 + 1], args[6][b1:b2 + 1], args[7][b1:b2 + 1],
            args[8][:, b1:b2 + 1], args[9][:, b1:b2 + 1],
            args[10][:, b1:b2 + 1], args[11][:, b1:b2 + 1],
            use_pallas=False)
        gas = CandidateCostLw(*args, use_pallas=False)
        view = BandKernelView(gas, b1, n)
        eq = CkdEquipartition(sliced)
        edges = np.linspace(0, n, 5).astype(np.int32)
        i1, i2 = edges[:-1], edges[1:] - 1
        seg = eq._seg_of_wav(i1)
        np.testing.assert_allclose(view.costs(i1, i2, seg),
                                   sliced.costs(i1, i2, seg), rtol=1e-12)


def test_scheduler_merges_and_matches_direct():
    """Merged cross-band dispatches return exactly what direct per-band
    evaluation on the same gas kernel returns."""
    import threading
    args, _ = lw_args("transmission", 512, seed=5)
    gas = CandidateCostLw(*args, use_pallas=False)
    sched = ProbeScheduler(gas)
    bands = [(0, 255), (256, 511)]
    probes = {0: (np.array([0, 60], np.int32), np.array([59, 200], np.int32)),
              1: (np.array([10], np.int32), np.array([250], np.int32))}
    direct = {}
    for j, (b1, b2) in enumerate(bands):
        view = BandKernelView(gas, b1, b2 - b1 + 1)
        direct[j] = view.costs(*probes[j], None)

    got = {}

    def run(j):
        b1, b2 = bands[j]
        view = BandKernelView(gas, b1, b2 - b1 + 1, sched, j)
        try:
            got[j] = view.costs(*probes[j], None)
        finally:
            sched.done()

    for _ in bands:
        sched.register()
    ts = [threading.Thread(target=run, args=(j,)) for j in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert sched.dispatches == 1   # both bands' probes rode one dispatch
    for j in range(2):
        # Merged batches change the candidate-bucket shape, so the
        # membership matmul's summation strategy (BLAS kernel choice) can
        # differ by ~1 ulp — identical math, not identical rounding.
        np.testing.assert_allclose(got[j], direct[j], rtol=1e-13)


def test_scheduler_error_propagates():
    class Boom:
        npoints = 64

        def costs(self, i1, i2, seg=None):
            raise ValueError("boom")

    import threading
    sched = ProbeScheduler(Boom())
    errs = {}

    def run(j):
        try:
            sched.costs(j, np.array([0]), np.array([1]))
        except BaseException as e:   # noqa: BLE001
            errs[j] = e
        finally:
            sched.done()

    sched.register()
    sched.register()
    ts = [threading.Thread(target=run, args=(j,)) for j in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(errs) == 2


def test_sw_vector_albedo_equals_scalar_per_band():
    """A gas-level SW kernel with a per-wavenumber albedo must reproduce
    each band's scalar-albedo kernel for intervals inside that band."""
    args, extras, p = sw_args("transmission", 400, albedo=0.0)
    nwav = 400
    albedo_wav = np.zeros(nwav)
    albedo_wav[:160] = 0.15          # "band 0" has no-Rayleigh albedo
    gas_args = list(args)
    gas_args[6] = albedo_wav
    gas = CandidateCostSw(*gas_args, extras=extras, use_pallas=False)
    for (b1, b2), alb in (((0, 159), 0.15), ((160, 399), 0.0)):
        n = b2 - b1 + 1
        sl = slice(b1, b2 + 1)
        sliced_args = (args[0], args[1], args[2], args[3], args[4],
                       args[5][sl], alb, args[7][sl], args[8][sl],
                       args[9][:, sl], args[10][:, sl], args[11][:, sl])
        sliced = CandidateCostSw(*sliced_args, use_pallas=False)
        view = BandKernelView(gas, b1, n)
        eq = CkdEquipartition(sliced)
        edges = np.linspace(0, n, 4).astype(np.int32)
        i1, i2 = edges[:-1], edges[1:] - 1
        seg = eq._seg_of_wav(i1)
        np.testing.assert_allclose(view.costs(i1, i2, seg),
                                   sliced.costs(i1, i2, seg), rtol=1e-10)


def test_device_seg_matches_host_reference():
    """The in-kernel device partition map equals the host formula it
    replaced (CkdEquipartition._seg_of_wav) on front-padded bounds."""
    import jax.numpy as jnp
    from ecckd_tpu.partition.cost_kernel import _CandidateCostBase
    base = _CandidateCostBase()
    i1 = np.array([0, 0, 3, 10, 20], np.int32)   # two front-pad zeros
    got = np.asarray(base._device_seg_of_wav(jnp.asarray(i1), 30, None))
    ranks = np.arange(30)
    want = np.maximum(0, np.searchsorted(i1, ranks, side="right") - 1)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def multiband_lw(tmp_path_factory):
    d = tmp_path_factory.mktemp("bp")
    h2o = synth_spectrum_file(str(d / "h2o.h5"), molecule="h2o",
                              nwav=1024, seed=7)
    order = str(d / "order.h5")
    reorder_spectrum(Config({
        "input": h2o, "output": order,
        "wavenumber1": "0 700 1400", "wavenumber2": "700 1400 2001",
    }), argv=["r"])
    return dict(d=d, h2o=h2o, order=order)


def _run_fgp(ws, tag, band_parallel, counter=None):
    out = str(ws["d"] / f"gpoints_{tag}.h5")
    calls = [0]
    orig = cost_kernel._CandidateCostBase.costs

    def counted(self, i1, i2, seg=None):
        calls[0] += 1
        return orig(self, i1, i2, seg)

    cost_kernel._CandidateCostBase.costs = counted
    try:
        find_g_points(Config({
            "output": out, "gases": "h2o",
            "heating_rate_tolerance": "0.4",
            "averaging_method": "transmission",
            "band_parallel": band_parallel,
            "h2o.reordering_input": ws["order"], "h2o.input": ws["h2o"],
        }), argv=["find_g_points"])
    finally:
        cost_kernel._CandidateCostBase.costs = orig
    if counter is not None:
        counter.append(calls[0])
    return out


def test_tool_band_parallel_deterministic_and_fewer_dispatches(
        multiband_lw):
    """The parallel schedule is deterministic (lockstep rounds: a merged
    dispatch fires exactly when every live band thread is waiting, so
    batch composition never depends on thread timing): two parallel runs
    must be BIT-identical.  The sequential gas-kernel mode evaluates the
    same probes in different bucket shapes (~1 ulp rounding), so it is
    compared structurally.  Dispatch count must drop vs sequential."""
    calls = []
    par1 = _run_fgp(multiband_lw, "parallel", "1", calls)
    par2 = _run_fgp(multiband_lw, "parallel_b", "1", calls)
    f1, f2 = NcFile(par1), NcFile(par2)
    np.testing.assert_array_equal(f1.read("g_point"), f2.read("g_point"))
    np.testing.assert_array_equal(f1.read("h2o_rank1"),
                                  f2.read("h2o_rank1"))
    np.testing.assert_array_equal(f1.read("h2o_rank2"),
                                  f2.read("h2o_rank2"))
    np.testing.assert_allclose(f1.read("h2o_error"), f2.read("h2o_error"),
                               rtol=0, atol=0)
    f1.close(); f2.close()
    assert calls[0] == calls[1]            # identical dispatch count too

    calls_serial = []
    serial = _run_fgp(multiband_lw, "serial", "serial", calls_serial)
    fs, fp = NcFile(serial), NcFile(par1)
    np.testing.assert_array_equal(fs.read("h2o_n_g_points"),
                                  fp.read("h2o_n_g_points"))
    assert np.max(np.abs(fs.read("h2o_rank1").astype(np.int64)
                         - fp.read("h2o_rank1").astype(np.int64))) <= 2
    np.testing.assert_allclose(fs.read("h2o_error"), fp.read("h2o_error"),
                               rtol=1e-3)
    fs.close(); fp.close()
    assert calls[0] < calls_serial[0], (calls, calls_serial)


def test_tool_band_parallel_matches_legacy(multiband_lw):
    """Gas-level vs legacy per-band kernels: f64 summation order differs
    (tile/prefix alignment), so assert structural agreement."""
    legacy = _run_fgp(multiband_lw, "legacy", "0")
    par = _run_fgp(multiband_lw, "parallel2", "1")
    fl, fp = NcFile(legacy), NcFile(par)
    np.testing.assert_array_equal(fl.read("h2o_n_g_points"),
                                  fp.read("h2o_n_g_points"))
    assert np.max(np.abs(fl.read("h2o_rank1").astype(np.int64)
                         - fp.read("h2o_rank1").astype(np.int64))) <= 2
    gp_l, gp_p = fl.read("g_point"), fp.read("g_point")
    assert np.mean(gp_l != gp_p) < 0.01
    # A bound moving by one rank changes that interval's stored f32 error
    # at the ~1e-5 level
    np.testing.assert_allclose(fl.read("h2o_error"), fp.read("h2o_error"),
                               rtol=1e-3)
    fl.close(); fp.close()
