"""chip_smoke.py's phases at a tiny size on the CPU (the script's main
refuses anything but a GPU), the compile-cache location, and bench.py's
refusal to measure anything but a known GPU."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


def test_sweep_phase_tiny(cpu, capsys):
    chip_smoke.sweep_phase(cpu, cpu, nwav=1024, nwav_big=2048, nlay=6,
                           nseg=8, ng=4, kernel=True, interpret=True)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[sweep]")
    for key in ("lw_xla_vs_f64", "sw_kernel_vs_f64", "avg_logarithmic",
                "lw_kernel_vs_xla_2^21", "sweep_2^21_temp_bytes"):
        assert key in line, key


def test_pipeline_phase_tiny(cpu, tmp_path, capsys):
    res = chip_smoke.pipeline_phase(cpu, nwav=4096, nlay=50,
                                    work=str(tmp_path))
    assert os.path.exists(res["gpoints"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[pipeline_lw]") and "max_rank_shift" in line
    assert jax.config.jax_enable_x64     # restored for later tests


def test_optimize_phase_tiny(cpu, capsys):
    chip_smoke.optimize_phase(cpu, cpu, solver_iters=2, ncol=2, nlay=6)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[optimize]") and "value_vs_f64" in line
    assert jax.config.jax_enable_x64


def test_four_card_phase_on_virtual_devices(capsys):
    devices = jax.devices("cpu")[:4]
    assert len(devices) == 4
    chip_smoke.four_card_phase(devices, nwav=4096, nlay=50, sharded="1")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    # The mesh and the data-parallel step span every device JAX sees
    n = len(jax.devices())
    assert f"sweep_shard_devices={n}" in line
    assert f"train_step_devices={n}" in line and "dp_grad_vs_one" in line


def test_phase_raises_over_the_limit(capsys):
    ph = chip_smoke.Phase("demo")
    ph.check("ok", 1e-7, 1e-5)
    ph.check("bad", 1e-3, 1e-5)
    with pytest.raises(chip_smoke.SmokeFailure, match="bad"):
        ph.done()
    assert "bad=1.000e-03(<=1e-05)" in capsys.readouterr().out


def test_main_refuses_the_cpu():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_location(tmp_path, monkeypatch, env_dir):
    from ecckd_tpu.tools import common
    old = jax.config.jax_compilation_cache_dir
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                           str(tmp_path / env_dir))
        expect = str(tmp_path / env_dir)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        expect = os.path.join(ROOT, ".jax_cache")
    try:
        assert common.configure_compile_cache() == expect
        assert jax.config.jax_compilation_cache_dir == expect
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_bench_refuses_a_machine_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu", BENCH_NWAV="4096",
               BENCH_NLAY="4", BENCH_ITERS="1")
    env.pop("BENCH_PLATFORM", None)
    out = subprocess.run([sys.executable, os.path.join(ROOT, "bench.py")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "measures a GPU" in out.stderr
    assert not [l for l in out.stdout.splitlines() if l.startswith("{")]


def test_bench_cpu_smoke_is_labelled():
    env = dict(os.environ, BENCH_PLATFORM="cpu", BENCH_NWAV="4096",
               BENCH_NLAY="4", BENCH_ITERS="1", BENCH_METRIC="sw")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "bench.py")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["device"]["platform"] == "cpu"


class _Dev:
    def __init__(self, kind):
        self.device_kind = kind


@pytest.mark.parametrize("kernel,bytes_per_bin_layer", [
    (False, 8.24), (True, 8.4)])
def test_roofline_counts_the_work_that_runs(kernel, bytes_per_bin_layer):
    """The XLA form counts its membership matmuls; the fused kernel, which
    runs none, gets a byte share only, with its partition-map traffic."""
    r = bench.roofline(_Dev("NVIDIA H100 80GB HBM3"), 3.35e12 / 8.2,
                       nlay=50, nseg=64, prefix=True, kernel=kernel)
    assert r["bytes_per_bin_layer"] == pytest.approx(bytes_per_bin_layer)
    assert r["pct_hbm_peak"] == pytest.approx(
        100.0 * bytes_per_bin_layer / 8.2, rel=1e-3)
    assert ("pct_f32_peak" in r) is not kernel
    assert ("membership_gflops" in r) is not kernel


def test_roofline_known_and_unknown_device_kinds():
    r = bench.roofline(_Dev("NVIDIA H100 80GB HBM3"), 3.35e12 / 8.2,
                       nlay=50, nseg=64, prefix=True)
    assert r["pct_hbm_peak"] == pytest.approx(100.0 * 8.24 / 8.2, rel=1e-3)
    with pytest.raises(KeyError, match="no published peaks"):
        bench.roofline(_Dev("NVIDIA A100-SXM4-40GB"), 1e9)
    with pytest.raises(KeyError):
        bench.device_peaks(_Dev("cpu"))
