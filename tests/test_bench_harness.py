"""Guard the driver-facing bench harness from bit-rot (tiny CPU runs)."""

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402


def test_pipeline_bench_detail_keys(tmp_path, monkeypatch):
    """run_pipeline_bench drives the real tools and reports wall-clock,
    the kernel/compile split and call counts."""
    real_build = bench.build_bench_spectrum
    monkeypatch.setattr(
        bench, "build_bench_spectrum",
        lambda path, nwav, nlay, **kw: real_build(
            str(tmp_path / "spec.h5"), nwav, nlay, **kw))
    res = bench.run_pipeline_bench(4096, 5, use_pallas=False, hr_tol=0.5)
    for key in ("reorder_s", "find_g_points_s", "create_lut_s", "total_s",
                "sweep_kernel_s", "sweep_kernel_calls", "sweep_compile_s",
                "sweep_compiles", "kernel_fraction"):
        assert key in res, key
    assert res["sweep_compiles"] >= 1
    assert res["sweep_kernel_calls"] >= 1
    assert 0.0 <= res["kernel_fraction"] <= 1.0
    assert res["total_s"] > 0


def test_pipeline_bench_sw(tmp_path, monkeypatch):
    """The SW pipeline chain (ssi + total-transmission) through the same
    harness (no SW end-to-end point existed)."""
    real_build = bench.build_bench_spectrum
    monkeypatch.setattr(
        bench, "build_bench_spectrum",
        lambda path, nwav, nlay, **kw: real_build(
            str(tmp_path / "spec_sw.h5"), nwav, nlay, **kw))
    real_ssi = bench.build_bench_ssi
    monkeypatch.setattr(
        bench, "build_bench_ssi",
        lambda path, spec: real_ssi(str(tmp_path / "ssi.h5"), spec))
    res = bench.run_pipeline_bench(4096, 5, use_pallas=False, hr_tol=0.8,
                                   is_sw=True)
    assert res["is_sw"] and res["total_s"] > 0
    assert res["sweep_kernel_calls"] >= 1


def test_bench_default_metric_cpu_smoke():
    """`python bench.py` (the driver's invocation) prints one JSON line
    with the headline metric on a CPU-pinned tiny run."""
    env = dict(os.environ, BENCH_PLATFORM="cpu", BENCH_NWAV="8192",
               BENCH_NLAY="5", BENCH_ITERS="1", BENCH_SKIP_EXTRAS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench.py")], env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("{")][-1]
    d = json.loads(line)
    assert d["metric"] == \
        "candidate_sweep_wavenumber_bins_layers_per_s_per_chip"
    assert np.isfinite(d["value"]) and d["value"] > 0
