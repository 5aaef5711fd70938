"""Mesh-sharded candidate sweep == single-device sweep.

The candidate-cost kernels shard the band's wavenumber axis over the mesh's
spectral axis (partition.cost_kernel): each shard reduces its local interval
partial sums and flux partials, combined with psum over the mesh.  These
tests assert the sharded costs match the dense single-device costs for LW
and SW across averaging methods (incl. total-transmission and the Pallas
kernels in interpret mode), on the 8-virtual-device CPU rig, including
wavenumber counts that do not divide the shard count (padding path) and
end-to-end through the find_g_points tool.
"""

import numpy as np
import pytest

from ecckd_tpu.parallel import make_mesh
from ecckd_tpu.partition.cost_kernel import (CandidateCostLw,
                                             CandidateCostSw,
                                             CkdEquipartition)
from test_native_baseline import build_problem

LW_METHODS = ["linear", "transmission", "logarithmic"]
SW_METHODS = ["linear", "transmission", "logarithmic", "total-transmission"]


def lw_args(method, nwav, seed=0):
    p = build_problem(nwav=nwav, seed=seed, dtype=np.float64)
    metric = np.sqrt(p["metric"]) if method == "square-root" else p["metric"]
    return (method, 0.02, p["layer_weight"], p["pressure_hl"],
            p["surf_emissivity"], p["surf_planck"], p["flux_dn_surf"],
            p["flux_up_toa"], p["planck_hl"], p["bg_od"], metric,
            p["hr"]), p


def sw_args(method, nwav, seed=0, albedo=0.15):
    p = build_problem(nwav=nwav, seed=seed, dtype=np.float64)
    rng = np.random.default_rng(seed + 100)
    ssi = np.abs(rng.normal(1.0, 0.1, nwav))
    extras = None
    if method == "total-transmission":
        nlay = p["hr"].shape[0]
        extras = dict(
            flux_dn_surf_low=np.abs(rng.normal(0.2, 0.02, nwav)),
            flux_up_toa_low=np.abs(rng.normal(0.05, 0.01, nwav)),
            flux_dn_surf_high=np.abs(rng.normal(0.15, 0.02, nwav)),
            flux_up_toa_high=np.abs(rng.normal(0.04, 0.01, nwav)),
            hr_low=rng.normal(0.0, 1e-5, (nlay, nwav)),
            hr_high=rng.normal(0.0, 1e-5, (nlay, nwav)),
            min_scaling=0.5, max_scaling=2.5)
    return (method, 0.02, p["layer_weight"], 0.5, p["pressure_hl"], ssi,
            albedo, p["flux_dn_surf"], p["flux_up_toa"], p["bg_od"],
            p["metric"], p["hr"]), extras, p


def probe_batches(npoints, nseg=7, seed=1):
    """A partition sweep plus a few single probes spanning shard edges."""
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.choice(np.arange(1, npoints), nseg - 1,
                               replace=False))
    i1 = np.concatenate([[0], edges]).astype(np.int32)
    i2 = np.concatenate([edges - 1, [npoints - 1]]).astype(np.int32)
    batches = [(i1, i2)]
    # A single interval strictly inside one shard, and one crossing shards
    q = npoints // 4
    batches.append((np.array([q], np.int32), np.array([q + 3], np.int32)))
    batches.append((np.array([q], np.int32),
                    np.array([3 * q], np.int32)))
    return batches


def assert_sharded_matches(make_dense, make_sharded):
    dense = make_dense()
    sharded = make_sharded()
    assert sharded.npoints == dense.npoints
    eq = CkdEquipartition(dense)
    for i1, i2 in probe_batches(dense.npoints):
        seg = eq._seg_of_wav(i1)
        np.testing.assert_allclose(
            sharded.costs(i1, i2, seg), dense.costs(i1, i2, seg),
            rtol=1e-11, atol=0.0)


@pytest.mark.parametrize("method", LW_METHODS)
@pytest.mark.parametrize("nwav", [256, 257])   # 257: shard padding path
def test_lw_sharded_equals_dense(method, nwav):
    mesh = make_mesh(data_parallel=1)
    args, _ = lw_args(method, nwav)
    assert_sharded_matches(
        lambda: CandidateCostLw(*args, use_pallas=False),
        lambda: CandidateCostLw(*args, use_pallas=False, mesh=mesh))


@pytest.mark.parametrize("method", SW_METHODS)
@pytest.mark.parametrize("nwav", [256, 257])
def test_sw_sharded_equals_dense(method, nwav):
    mesh = make_mesh(data_parallel=1)
    args, extras, _ = sw_args(method, nwav)
    assert_sharded_matches(
        lambda: CandidateCostSw(*args, extras=extras, use_pallas=False),
        lambda: CandidateCostSw(*args, extras=extras, use_pallas=False,
                                mesh=mesh))


def test_sw_sharded_no_upwelling():
    """albedo <= 0 skips the upwelling sweep (with_upwelling False)."""
    mesh = make_mesh(data_parallel=1)
    args, extras, _ = sw_args("linear", 256, albedo=0.0)
    assert_sharded_matches(
        lambda: CandidateCostSw(*args, extras=extras, use_pallas=False),
        lambda: CandidateCostSw(*args, extras=extras, use_pallas=False,
                                mesh=mesh))


def test_lw_sharded_pallas_interpret_matches_dense():
    """The Pallas sweep kernel inside shard_map (interpret mode): the
    membership reduction must honour the rank-shifted local bounds."""
    mesh = make_mesh(data_parallel=1)
    args, _ = lw_args("transmission", 256)
    dense = CandidateCostLw(*args, use_pallas=False)
    sharded = CandidateCostLw(*args, use_pallas=True, pallas_interpret=True,
                              mesh=mesh)
    eq = CkdEquipartition(dense)
    i1, i2 = probe_batches(dense.npoints)[0]
    seg = eq._seg_of_wav(i1)
    np.testing.assert_allclose(sharded.costs(i1, i2, seg),
                               dense.costs(i1, i2, seg), rtol=1e-6)


def test_sw_sharded_pallas_interpret_matches_dense():
    mesh = make_mesh(data_parallel=1)
    args, extras, _ = sw_args("total-transmission", 256)
    dense = CandidateCostSw(*args, extras=extras, use_pallas=False)
    sharded = CandidateCostSw(*args, extras=extras, use_pallas=True,
                              pallas_interpret=True, mesh=mesh)
    eq = CkdEquipartition(dense)
    i1, i2 = probe_batches(dense.npoints)[0]
    seg = eq._seg_of_wav(i1)
    np.testing.assert_allclose(sharded.costs(i1, i2, seg),
                               dense.costs(i1, i2, seg), rtol=1e-6)


def test_sharded_on_data_spectral_mesh():
    """Sharding uses only the spectral axis; a (data=2, spectral=4) mesh
    must give the same costs as (data=1, spectral=8)."""
    args, _ = lw_args("transmission", 256)
    dense = CandidateCostLw(*args, use_pallas=False)
    mesh = make_mesh(data_parallel=2)
    sharded = CandidateCostLw(*args, use_pallas=False, mesh=mesh)
    eq = CkdEquipartition(dense)
    i1, i2 = probe_batches(dense.npoints)[0]
    seg = eq._seg_of_wav(i1)
    np.testing.assert_allclose(sharded.costs(i1, i2, seg),
                               dense.costs(i1, i2, seg), rtol=1e-11)


def test_find_g_points_tool_sharded_matches_dense(tmp_path):
    """End-to-end: the find_g_points tool with sharded=1 must produce the
    same g-point decomposition as sharded=0 on the synthetic LW rig."""
    from ecckd_tpu.config import Config
    from ecckd_tpu.io import NcFile
    from ecckd_tpu.tools.find_g_points import find_g_points
    from ecckd_tpu.tools.reorder_spectrum import reorder_spectrum
    from synth import synth_spectrum_file

    h2o = synth_spectrum_file(str(tmp_path / "h2o.h5"), molecule="h2o",
                              nwav=1024, seed=3)
    order = str(tmp_path / "h2o_order.h5")
    reorder_spectrum(Config({"input": h2o, "output": order}), argv=["r"])

    def run(tag, sharded):
        out = str(tmp_path / f"gpoints_{tag}.h5")
        find_g_points(Config({
            "output": out,
            "gases": "h2o",
            "heating_rate_tolerance": "0.4",
            "averaging_method": "transmission",
            "sharded": sharded,
            "h2o.reordering_input": order,
            "h2o.input": h2o,
        }), argv=["find_g_points"])
        return out

    dense_out = run("dense", "0")
    shard_out = run("sharded", "1")
    fd, fs = NcFile(dense_out), NcFile(shard_out)
    np.testing.assert_array_equal(fd.read("g_point"), fs.read("g_point"))
    np.testing.assert_array_equal(fd.read("h2o_rank1"),
                                  fs.read("h2o_rank1"))
    np.testing.assert_array_equal(fd.read("h2o_rank2"),
                                  fs.read("h2o_rank2"))
    np.testing.assert_allclose(fd.read("h2o_error"), fs.read("h2o_error"),
                               rtol=1e-9)
    fd.close(); fs.close()


def test_find_g_points_tool_sharded_matches_dense_sw(tmp_path):
    """SW total-transmission (low/high-scaled truth extras + upwelling)
    through the find_g_points tool: sharded=1 must match sharded=0."""
    from ecckd_tpu.config import Config
    from ecckd_tpu.io import NcFile, read_spectrum
    from ecckd_tpu.tools.find_g_points import find_g_points
    from ecckd_tpu.tools.reorder_spectrum import reorder_spectrum
    from synth import synth_spectrum_file, synth_ssi_file

    h2o = synth_spectrum_file(str(tmp_path / "h2o_sw.h5"), molecule="h2o",
                              nwav=1024, ncol=1, seed=11, is_sw=True)
    sp = read_spectrum(h2o, 0)
    ssi_path, _ = synth_ssi_file(str(tmp_path / "ssi.h5"), sp.wavenumber)
    order = str(tmp_path / "order_sw.h5")
    reorder_spectrum(Config({"input": h2o, "output": order,
                             "ssi": ssi_path,
                             "threshold_optical_depth": "0.25"}),
                     argv=["r"])

    def run(tag, sharded):
        out = str(tmp_path / f"gpoints_sw_{tag}.h5")
        find_g_points(Config({
            "output": out, "gases": "h2o", "ssi": ssi_path,
            "heating_rate_tolerance": "0.8",
            "averaging_method": "total-transmission",
            "sharded": sharded,
            "h2o.reordering_input": order, "h2o.input": h2o,
            "h2o.min_scaling": "0.5", "h2o.max_scaling": "2.0",
        }), argv=["find_g_points"])
        return out

    fd, fs = NcFile(run("dense", "0")), NcFile(run("sharded", "1"))
    # The psum reorders f64 summation, so secant-search decisions can move
    # individual bounds by a rank or two — assert the PARTITION is
    # structurally identical (same g-point count, bounds within a few
    # ranks, <1% of wavenumber assignments moved); exact cost equality is
    # asserted at kernel level above.
    np.testing.assert_array_equal(fd.read("h2o_n_g_points"),
                                  fs.read("h2o_n_g_points"))
    assert np.max(np.abs(fd.read("h2o_rank1").astype(np.int64)
                         - fs.read("h2o_rank1").astype(np.int64))) <= 3
    gp_d, gp_s = fd.read("g_point"), fs.read("g_point")
    assert np.mean(gp_d != gp_s) < 0.01
    np.testing.assert_allclose(fd.read("h2o_error"), fs.read("h2o_error"),
                               rtol=5e-2)
    np.testing.assert_allclose(fd.read("solar_irradiance"),
                               fs.read("solar_irradiance"), rtol=2e-2)
    fd.close(); fs.close()


def test_tiny_band_smaller_than_mesh():
    """Bands with fewer wavenumbers than shards (narrow SW bands) must
    pad and still match dense."""
    mesh = make_mesh(data_parallel=1)
    p = build_problem(nwav=5, nseg=2, dtype=np.float64)
    args = ("transmission", 0.02, p["layer_weight"], p["pressure_hl"],
            p["surf_emissivity"], p["surf_planck"], p["flux_dn_surf"],
            p["flux_up_toa"], p["planck_hl"], p["bg_od"], p["metric"],
            p["hr"])   # 5 points over 8 shards
    dense = CandidateCostLw(*args, use_pallas=False)
    sharded = CandidateCostLw(*args, use_pallas=False, mesh=mesh)
    i1 = np.array([0, 2], np.int32)
    i2 = np.array([1, 4], np.int32)
    seg = CkdEquipartition(dense)._seg_of_wav(i1)
    np.testing.assert_allclose(sharded.costs(i1, i2, seg),
                               dense.costs(i1, i2, seg), rtol=1e-11)
