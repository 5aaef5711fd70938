"""Tests for reorder_spectrum and the ordering file round trip."""

import numpy as np
import pytest

from ecckd_tpu.config import Config
from ecckd_tpu.io import NcFile, NcWriter, read_order
from ecckd_tpu.tools.reorder_spectrum import (reorder_spectrum,
                                              compute_sorting_variable)
from synth import synth_spectrum_file


@pytest.fixture(scope="module")
def spectrum_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("spectra") / "h2o.h5"
    return synth_spectrum_file(str(path), molecule="h2o", nwav=1024)


class TestSortingVariable:
    def test_od_threshold_height_matches_serial(self, spectrum_file):
        """Vectorized threshold search must match the reference's serial scan."""
        from ecckd_tpu.io import read_spectrum
        sp = read_spectrum(spectrum_file, 0)
        threshold = 0.5
        sorting, column_od = compute_sorting_variable(
            sp.pressure_hl, sp.wavenumber, sp.d_wavenumber, sp.optical_depth,
            do_sw=True, ssi=np.ones(len(sp.wavenumber)),
            threshold_optical_depth=threshold)
        sorting = np.asarray(sorting)

        # Serial NumPy port of reorder_spectrum.cpp:196-222
        od = sp.optical_depth
        nlay, nwav = od.shape
        ph_hl = np.log(sp.pressure_hl[-1]) - np.log(sp.pressure_hl)
        expected = np.zeros(nwav)
        for iwav in range(nwav):
            if column_od[iwav] <= threshold:
                expected[iwav] = column_od[iwav] - threshold
            else:
                cum = 0.0
                for ilay in range(nlay):
                    nxt = cum + od[ilay, iwav]
                    if nxt >= threshold:
                        expected[iwav] = (
                            ((threshold - cum) * ph_hl[ilay + 1]
                             + (nxt - threshold) * ph_hl[ilay])
                            / max(1e-12, od[ilay, iwav]))
                        break
                    cum = nxt
        np.testing.assert_allclose(sorting, expected, rtol=1e-9, atol=1e-12)

    def test_lw_sorting_finite(self, spectrum_file):
        from ecckd_tpu.io import read_spectrum
        sp = read_spectrum(spectrum_file, 0)
        sorting, column_od = compute_sorting_variable(
            sp.pressure_hl, sp.wavenumber, sp.d_wavenumber, sp.optical_depth,
            do_sw=False)
        assert np.all(np.isfinite(np.asarray(sorting)))

    @pytest.mark.parametrize("do_sw", [False, True])
    def test_kernel_captures_no_spectral_consts(self, do_sw):
        """The sorting kernel must take every spectral operand as a jit
        ARGUMENT — captured arrays become HLO constants, multi-GB programs
        at CKDMIP scale.  Assert via the traced jaxpr's consts."""
        import jax
        import jax.numpy as jnp
        from ecckd_tpu.tools.reorder_spectrum import _sorting_kernel
        nlay, nwav = 7, 4096
        args = (jnp.ones(nlay + 1), jnp.linspace(10.0, 2000.0, nwav),
                jnp.ones(nwav), jnp.ones((nlay, nwav)),
                jnp.ones(nwav) if do_sw else None)
        jaxpr = jax.make_jaxpr(
            lambda *a: _sorting_kernel(*a, do_sw=do_sw,
                                       threshold_optical_depth=0.5))(*args)
        big = [np.shape(c) for c in jaxpr.consts
               if np.size(np.asarray(c)) > nlay + 1]
        assert not big, f"jit-captured operands beyond O(nlay): {big}"

    def test_blockwise_matches_dense_and_profileblocks(self, spectrum_file):
        """Block size must not change the result; a ProfileBlocks source
        (streamed reads, the CKDMIP-scale path) must match the dense
        array bitwise."""
        from ecckd_tpu.io import read_spectrum
        from ecckd_tpu.io.spectrum import open_spectrum_profile
        sp = read_spectrum(spectrum_file, 0)
        dense = compute_sorting_variable(
            sp.pressure_hl, sp.wavenumber, sp.d_wavenumber,
            sp.optical_depth, do_sw=False)
        blocked = compute_sorting_variable(
            sp.pressure_hl, sp.wavenumber, sp.d_wavenumber,
            sp.optical_depth, do_sw=False, block_wav=129)
        with open_spectrum_profile(spectrum_file, 0) as pb:
            streamed = compute_sorting_variable(
                pb.pressure_hl, pb.wavenumber, pb.d_wavenumber, pb,
                do_sw=False, block_wav=257)
        for got in (blocked, streamed):
            np.testing.assert_array_equal(got[0], dense[0])
            np.testing.assert_allclose(got[1], dense[1], rtol=1e-13)


class TestReorderTool:
    def test_lw_end_to_end(self, spectrum_file, tmp_path):
        out = str(tmp_path / "order_lw.h5")
        cfg = Config({"input": spectrum_file, "output": out})
        reorder_spectrum(cfg, argv=["reorder_spectrum", "test"])
        order = read_order(out)
        nwav = len(order.wavenumber)
        # rank is a permutation
        assert sorted(order.rank.tolist()) == list(range(nwav))
        assert order.molecule == "h2o"
        # Sorting variable must be non-decreasing along the rank ordering
        ordered_index = np.empty(nwav, int)
        ordered_index[order.rank] = np.arange(nwav)
        sv_sorted = order.sorting_variable[np.argsort(order.rank)]
        assert np.all(np.diff(sv_sorted) >= -1e-6)
        assert np.all(order.band_number == 0)

    def test_multi_band(self, spectrum_file, tmp_path):
        out = str(tmp_path / "order_bands.h5")
        cfg = Config({"input": spectrum_file, "output": out,
                      "wavenumber1": "0 1000", "wavenumber2": "1000 2001"})
        reorder_spectrum(cfg, argv=["reorder_spectrum"])
        order = read_order(out)
        assert len(order.wavenumber1_band) == 2
        assert set(np.unique(order.band_number)) == {0, 1}
        # Within each band, ranks form a contiguous range and sorting is
        # non-decreasing
        for b in (0, 1):
            sel = order.band_number == b
            ranks = np.sort(order.rank[sel])
            assert np.all(np.diff(ranks) == 1)
            sv = order.sorting_variable[sel][
                np.argsort(order.rank[sel], kind="stable")]
            assert np.all(np.diff(sv) >= -1e-6)

    def test_stable_sort_ties(self, tmp_path):
        """Equal sorting variables keep original wavenumber order."""
        # Build a degenerate spectrum where many columns are identical
        path = str(tmp_path / "flat.h5")
        nwav, nlay = 64, 5
        with NcWriter(path) as w:
            w.define_dimension("column", None)
            w.define_dimension("half_level", nlay + 1)
            w.define_dimension("level", nlay)
            w.define_dimension("wavenumber", nwav)
            w.define_variable("pressure_hl", "double", "column", "half_level")
            w.define_variable("temperature_hl", "double", "column",
                              "half_level")
            w.define_variable("wavenumber", "double", "wavenumber")
            w.define_variable("optical_depth", "double", "column", "level",
                              "wavenumber")
            w.write(np.linspace(100.0, 1e5, nlay + 1), "pressure_hl", index=0)
            w.write(np.linspace(220.0, 290.0, nlay + 1), "temperature_hl",
                    index=0)
            w.write(np.linspace(10.0, 2000.0, nwav), "wavenumber")
            w.write(np.full((nlay, nwav), 1e-6), "optical_depth", index=0)
            w.write_attribute("x", "constituent_id")
        out = str(tmp_path / "order_flat.h5")
        reorder_spectrum(Config({"input": path, "output": out}), argv=["r"])
        order = read_order(out)
        # All sorting variables equal -> stable sort keeps identity order
        np.testing.assert_array_equal(order.rank, np.arange(nwav))
