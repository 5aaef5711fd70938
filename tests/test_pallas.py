"""Pallas (Triton route) sweep kernels vs the XLA reference implementation,
in interpret mode on the CPU."""

import numpy as np
import pytest

from ecckd_tpu.ops.rt_lw import rt_lw_bb_intervals
from ecckd_tpu.ops.pallas.sweep_lw import rt_lw_bb_intervals_pallas


class TestPallasSweepLw:
    def _inputs(self, nlay=12, nwav=2500, nseg=5, seed=0, dtype=np.float32):
        rng = np.random.default_rng(seed)
        planck = np.abs(rng.normal(5, 1, (nlay + 1, nwav))).astype(dtype)
        bg_od = rng.gamma(0.5, 0.4, (nlay, nwav)).astype(dtype)
        od_fit = rng.gamma(0.5, 0.4, (nlay, nseg)).astype(dtype)
        emis = np.ones(nwav, dtype)
        surfp = np.abs(rng.normal(8, 1, nwav)).astype(dtype)
        edges = np.linspace(0, nwav, nseg + 1).astype(np.int32)
        i1 = edges[:-1]
        i2 = edges[1:] - 1
        seg = np.repeat(np.arange(nseg, dtype=np.int32), np.diff(edges))
        return planck, bg_od, od_fit, emis, surfp, i1, i2, seg

    def test_matches_xla(self):
        planck, bg_od, od_fit, emis, surfp, i1, i2, seg = self._inputs()
        grey = od_fit[:, seg]
        fd_ref, fu_ref = rt_lw_bb_intervals(planck, bg_od, grey, emis,
                                            surfp, i1, i2)
        fd, fu = rt_lw_bb_intervals_pallas(planck, bg_od, od_fit, seg,
                                           emis, surfp, i1, i2,
                                           interpret=True)
        np.testing.assert_allclose(np.asarray(fd), np.asarray(fd_ref),
                                   rtol=2e-5)
        np.testing.assert_allclose(np.asarray(fu), np.asarray(fu_ref),
                                   rtol=2e-5)

    def test_non_tile_aligned(self):
        # nwav and intervals not multiples of the block: masked lanes must
        # not contribute
        planck, bg_od, od_fit, emis, surfp, i1, i2, seg = self._inputs(
            nwav=1333, nseg=3, seed=4)
        grey = od_fit[:, seg]
        fd_ref, fu_ref = rt_lw_bb_intervals(planck, bg_od, grey, emis,
                                            surfp, i1, i2)
        fd, fu = rt_lw_bb_intervals_pallas(planck, bg_od, od_fit, seg,
                                           emis, surfp, i1, i2,
                                           interpret=True)
        np.testing.assert_allclose(np.asarray(fd), np.asarray(fd_ref),
                                   rtol=2e-5)
        np.testing.assert_allclose(np.asarray(fu), np.asarray(fu_ref),
                                   rtol=2e-5)

    def test_overlapping_boundary_index(self):
        # Shared boundary index belongs to both intervals (ceil/floor map)
        planck, bg_od, od_fit, emis, surfp, i1, i2, seg = self._inputs(
            nwav=2048, nseg=4, seed=7)
        i1 = np.array([0, 500, 1000, 1500], np.int32)
        i2 = np.array([500, 1000, 1500, 2047], np.int32)  # overlaps
        grey = od_fit[:, seg]
        fd_ref, fu_ref = rt_lw_bb_intervals(planck, bg_od, grey, emis,
                                            surfp, i1, i2)
        fd, fu = rt_lw_bb_intervals_pallas(planck, bg_od, od_fit, seg,
                                           emis, surfp, i1, i2,
                                           interpret=True)
        np.testing.assert_allclose(np.asarray(fd), np.asarray(fd_ref),
                                   rtol=2e-5)
        np.testing.assert_allclose(np.asarray(fu), np.asarray(fu_ref),
                                   rtol=2e-5)


class TestPallasSweepSw:
    def _inputs(self, nlay=10, nwav=2100, nseg=4, seed=2,
                dtype=np.float32):
        rng = np.random.default_rng(seed)
        ssi = np.abs(rng.normal(2, 0.5, nwav)).astype(dtype)
        bg_od = rng.gamma(0.4, 0.2, (nlay, nwav)).astype(dtype)
        od_fit = rng.gamma(0.4, 0.2, (nlay, nseg)).astype(dtype)
        edges = np.linspace(0, nwav, nseg + 1).astype(np.int32)
        i1, i2 = edges[:-1], edges[1:] - 1
        seg = np.repeat(np.arange(nseg, dtype=np.int32), np.diff(edges))
        return ssi, bg_od, od_fit, i1, i2, seg

    def test_matches_xla_with_up(self):
        from ecckd_tpu.ops.rt_sw import rt_sw_bb_intervals
        from ecckd_tpu.ops.pallas.sweep_sw import rt_sw_bb_intervals_pallas
        ssi, bg_od, od_fit, i1, i2, seg = self._inputs()
        grey = od_fit[:, seg]
        fd_ref, fu_ref = rt_sw_bb_intervals(0.5, ssi, bg_od, grey, 0.15,
                                            i1, i2, with_upwelling=True)
        fd, fu = rt_sw_bb_intervals_pallas(ssi, bg_od, od_fit, seg, i1, i2,
                                           cos_sza=0.5, albedo=0.15,
                                           with_upwelling=True,
                                           interpret=True)
        np.testing.assert_allclose(np.asarray(fd), np.asarray(fd_ref),
                                   rtol=2e-5)
        np.testing.assert_allclose(np.asarray(fu), np.asarray(fu_ref),
                                   rtol=2e-5)

    def test_matches_xla_direct_only(self):
        from ecckd_tpu.ops.rt_sw import rt_sw_bb_intervals
        from ecckd_tpu.ops.pallas.sweep_sw import rt_sw_bb_intervals_pallas
        ssi, bg_od, od_fit, i1, i2, seg = self._inputs(seed=9, nwav=1024)
        grey = od_fit[:, seg]
        fd_ref, _ = rt_sw_bb_intervals(0.5, ssi, bg_od, grey, 0.0,
                                       i1, i2, with_upwelling=False)
        fd, fu = rt_sw_bb_intervals_pallas(ssi, bg_od, od_fit, seg, i1, i2,
                                           cos_sza=0.5, albedo=0.0,
                                           with_upwelling=False,
                                           interpret=True)
        np.testing.assert_allclose(np.asarray(fd), np.asarray(fd_ref),
                                   rtol=2e-5)
        np.testing.assert_allclose(np.asarray(fu), 0.0)


class TestScanFormProductionShape:
    """The production layer count (nlay=50: 100 register-held terms per
    lane in the upward pass) against the XLA form."""

    def test_lw_scan_nlay50(self):
        rng = np.random.default_rng(11)
        nlay, nwav, nseg = 50, 3000, 4
        planck = np.abs(rng.normal(5, 1, (nlay + 1, nwav))).astype(np.float32)
        bg = rng.gamma(0.5, 0.3, (nlay, nwav)).astype(np.float32)
        od_fit = rng.gamma(0.5, 0.3, (nlay, nseg)).astype(np.float32)
        emis = rng.uniform(0.9, 1.0, nwav).astype(np.float32)
        surfp = np.abs(rng.normal(8, 1, nwav)).astype(np.float32)
        edges = np.linspace(0, nwav, nseg + 1).astype(np.int32)
        i1, i2 = edges[:-1], edges[1:] - 1
        seg = np.repeat(np.arange(nseg, dtype=np.int32), np.diff(edges))
        fd_k, fu_k = rt_lw_bb_intervals_pallas(
            planck, bg, od_fit, seg, emis, surfp, i1, i2, interpret=True)
        fd_x, fu_x = rt_lw_bb_intervals(planck, bg, od_fit[:, seg], emis,
                                        surfp, i1, i2)
        np.testing.assert_allclose(np.asarray(fd_k), np.asarray(fd_x),
                                   rtol=3e-5)
        np.testing.assert_allclose(np.asarray(fu_k), np.asarray(fu_x),
                                   rtol=3e-5)

    def test_sw_scan_nlay50(self):
        from ecckd_tpu.ops.rt_sw import rt_sw_bb_intervals
        from ecckd_tpu.ops.pallas.sweep_sw import rt_sw_bb_intervals_pallas
        rng = np.random.default_rng(12)
        nlay, nwav, nseg = 50, 2600, 3
        ssi = np.abs(rng.normal(2, 0.5, nwav)).astype(np.float32)
        bg = rng.gamma(0.4, 0.2, (nlay, nwav)).astype(np.float32)
        od_fit = rng.gamma(0.4, 0.2, (nlay, nseg)).astype(np.float32)
        edges = np.linspace(0, nwav, nseg + 1).astype(np.int32)
        i1, i2 = edges[:-1], edges[1:] - 1
        seg = np.repeat(np.arange(nseg, dtype=np.int32), np.diff(edges))
        out_k = rt_sw_bb_intervals_pallas(ssi, bg, od_fit, seg, i1, i2,
                                          cos_sza=0.5, albedo=0.2,
                                          interpret=True)
        out_x = rt_sw_bb_intervals(0.5, ssi, bg, od_fit[:, seg], 0.2,
                                   i1, i2)
        for a, b in zip(out_k, out_x):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=3e-5)


class TestChunkTable:
    """The kernels' work split: chunks of one interval each."""

    def test_chunks_cover_each_interval_once(self):
        from ecckd_tpu.ops.pallas.sweep_lw import (interval_chunks,
                                                   num_programs)
        i1 = np.array([0, 0, 0, 130, 400], np.int32)
        i2 = np.array([0, 0, 129, 399, 999], np.int32)
        nprog = num_programs(1000, 5, block=128)
        lo, hi, seg = map(np.asarray,
                          interval_chunks(i1, i2, 1000, 128, nprog))
        for s in range(5):
            ranks = np.concatenate([np.arange(a, b) for a, b, g
                                    in zip(lo, hi, seg) if g == s])
            np.testing.assert_array_equal(np.sort(ranks),
                                          np.arange(i1[s], i2[s] + 1))
            assert np.all(hi[seg == s] - lo[seg == s] <= 128)
        assert np.all(hi[seg < 0] == lo[seg < 0])

    def test_chunks_clip_shard_local_bounds(self):
        # Mesh shards pass bounds shifted into local rank space
        from ecckd_tpu.ops.pallas.sweep_lw import interval_chunks
        lo, hi, seg = map(np.asarray, interval_chunks(
            np.array([-50, 60], np.int32), np.array([59, 300], np.int32),
            100, 64, 8))
        spans = sorted((int(a), int(b), int(g))
                       for a, b, g in zip(lo, hi, seg) if g >= 0)
        assert spans == [(0, 60, 0), (60, 100, 1)]

    @pytest.mark.parametrize("i1,i2,fits", [
        ([0, 500, 1000], [499, 999, 1999], True),      # disjoint
        ([0, 500, 1000], [500, 1000, 1999], True),     # shared boundaries
        ([0, 0, 0, 10], [0, 0, 0, 99], True),          # bucket front pad
        ([0, 0, 0], [999, 999, 999], False),           # nested copies
    ])
    def test_chunks_fit(self, i1, i2, fits):
        from ecckd_tpu.ops.pallas.sweep_lw import chunks_fit
        assert chunks_fit(np.array(i1), np.array(i2), 2000) is fits

    def test_overlapping_costs_rejected(self):
        from ecckd_tpu.partition.cost_kernel import CandidateCostLw
        rng = np.random.default_rng(5)
        nlay, nwav = 4, 256
        f32 = lambda a: np.asarray(a, np.float32)
        p = np.exp(np.linspace(np.log(100.0), np.log(1e5), nlay + 1))
        planck = np.abs(rng.normal(5, 1, (nlay + 1, nwav)))
        kern = CandidateCostLw(
            "transmission", 0.02, f32(np.full(nlay, 0.25)), f32(p),
            f32(np.ones(nwav)), f32(planck[-1]), f32(planck[-1] * 0.5),
            f32(planck[0] * 0.8), f32(planck),
            f32(rng.gamma(0.5, 0.1, (nlay, nwav))),
            f32(rng.uniform(0.1, 0.9, (nlay, nwav))),
            f32(np.zeros((nlay, nwav))), use_pallas=True,
            pallas_interpret=True)
        with pytest.raises(ValueError, match="overlap"):
            kern.costs(np.array([0, 0], np.int32),
                       np.array([255, 255], np.int32))
