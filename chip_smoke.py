"""Run the ecCKD pipeline's main path once on one GPU and check it.

    python chip_smoke.py                # one GPU: every phase below
    python chip_smoke.py --four-cards   # four GPUs: sharded find_g_points
                                        # and one data-parallel train step,
                                        # each against one GPU

Phases (one line each: name, seconds, compared quantities and limits):

1. device  — the default device must be a GPU; its kind, the device count,
   and ``nvidia-smi``'s name and power limit.
2. sweep   — LW and SW candidate costs at 2^17 x 50 x 64, the GPU float32
   production path against float64 on the CPU; g-point averaging against
   the CPU; at 2^21 the fused sweep kernels against the XLA form on the
   GPU; the compiled 2^21 sweep's memory analysis.
3. pipeline_lw — reorder_spectrum -> find_g_points -> create_lut through
   the tool entry points on a seeded CKDMIP-shaped h2o spectrum at 2^20 x
   50 in float32, then find_g_points again in float64: same g-point count,
   rank bounds within the limits of ``LIMITS``.
4. pipeline_sw — the same chain with total-transmission and an SSI file.
5. optimize — the optimize_lut train step (value and gradient) against
   float64 on the CPU, 20 iterations of the policy's solver, and the CKD
   forward step of ``__graft_entry__.entry()``.

CPU truths come from ``jax.devices("cpu")`` in this process.  A failed
comparison raises, so the script exits non-zero; the last line of a
passing run is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import bench  # noqa: E402  (fails outside a checkout of the repository)

# Limits (PARITY.md "GPU parity"): GPU float32 against CPU float64, or a
# fused kernel against the XLA form on the same GPU.
LIMITS = {
    "lw_sweep": 1e-5,
    "sw_sweep_xla": 1e-5,
    "sw_sweep_kernel": 2e-4,
    "average_linear": 1e-5,
    "average_square-root": 1e-5,
    "average_logarithmic": 1e-5,
    "average_transmission": 5e-4,
    "optimize": 1e-3,
    # g-point rank bounds, in ranks of the 2^20-rank band, about 3x the
    # largest shift seen over seeds (PERF.md): float32 against float64
    # find_g_points, where the float32 transmission clamp (grey od <= 8.3)
    # moves the bounds of saturated layers and flat cost minima amplify
    # it (LW 278 and 227, SW 25 and 22171 ranks); and the sharded float32
    # sweep against one card, where only the order of the sums differs (9
    # and 21)
    "rank_shift_f32_f64_lw": 768,
    "rank_shift_f32_f64_sw": 65536,
    "rank_shift_sharded": 64,
}


class SmokeFailure(RuntimeError):
    pass


class Phase:
    """Collects one phase's comparisons; prints its line and raises when
    any comparison exceeds its limit."""

    def __init__(self, name: str):
        self.name = name
        self.t0 = time.perf_counter()
        self.items = []
        self.failed = []

    def check(self, key: str, value: float, limit: float):
        value = float(value)
        ok = np.isfinite(value) and value <= limit
        self.items.append(f"{key}={value:.3e}(<={limit:g})")
        if not ok:
            self.failed.append(key)

    def note(self, key: str, value):
        if isinstance(value, float):
            value = f"{value:.4g}"
        self.items.append(f"{key}={value}")

    def done(self):
        secs = time.perf_counter() - self.t0
        print(f"[{self.name}] {secs:.1f}s " + " ".join(self.items),
              flush=True)
        if self.failed:
            raise SmokeFailure(f"{self.name}: over the limit: "
                               + ", ".join(self.failed))
        return secs


def max_rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape or not np.all(np.isfinite(a)):
        return float("inf")
    scale = np.maximum(np.abs(b), 1e-30)
    return float(np.max(np.abs(a - b) / scale))


def gpu_info() -> str:
    """``nvidia-smi`` name and power limit, from a child that stays off
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


# ---------------------------------------------------------------- sweeps --

def _sweep_kernels(data, ssi, device, dtype, use_pallas=None,
                   interpret=False, mesh=None):
    import jax
    from ecckd_tpu.partition.cost_kernel import CandidateCostLw, \
        CandidateCostSw
    c = lambda a: np.asarray(a, dtype)
    kw = dict(use_pallas=use_pallas, pallas_interpret=interpret, mesh=mesh)
    with jax.default_device(device):
        lw = CandidateCostLw(
            "transmission", 0.02, c(data["layer_weight"]),
            c(data["pressure_hl"]), c(data["surf_emissivity"]),
            c(data["surf_planck"]), c(data["flux_dn_surf"]),
            c(data["flux_up_toa"]), c(data["planck_hl"]), c(data["bg_od"]),
            c(data["metric"]), c(data["hr"]), **kw)
        sw = CandidateCostSw(
            "transmission", 0.02, c(data["layer_weight"]), 0.5,
            c(data["pressure_hl"]), c(ssi), 0.15, c(data["flux_dn_surf"]),
            c(data["flux_up_toa"]), c(data["bg_od"]), c(data["metric"]),
            c(data["hr"]), **kw)
    return lw, sw


def _sweep_data(nwav, nlay, nseg):
    data = bench.build_inputs(nlay, nwav, nseg, np.float64)
    ssi = np.abs(np.random.default_rng(1).normal(1.0, 0.1, nwav))
    return data, ssi


def sweep_phase(gpu, cpu, nwav=1 << 17, nwav_big=1 << 21, nlay=50,
                nseg=64, ng=16, kernel=None, interpret=False):
    """Candidate-sweep and averaging parity; kernel against XLA form.
    ``kernel`` (default: the execution policy's choice) adds the fused
    sweep kernels, in interpret mode with ``interpret``."""
    import jax
    import jax.numpy as jnp
    from ecckd_tpu.ops.average import average_od_to_gpoints
    from ecckd_tpu.policy import execution_policy

    jax.config.update("jax_enable_x64", True)
    ph = Phase("sweep")
    data, ssi = _sweep_data(nwav, nlay, nseg)
    i1, i2 = data["i1"], data["i2"]
    lw64, sw64 = _sweep_kernels(data, ssi, cpu, np.float64, use_pallas=False)
    ref_lw, ref_sw = lw64.costs(i1, i2), sw64.costs(i1, i2)
    kernel_on = kernel
    if kernel_on is None:
        with jax.default_device(gpu):
            kernel_on = execution_policy().sweep_kernel(np.float32)
    ph.note("fused_kernel", kernel_on)
    for tag, use in (("xla", False), ("kernel", True)):
        if use and not kernel_on:
            continue
        lw, sw = _sweep_kernels(data, ssi, gpu, np.float32, use_pallas=use,
                                interpret=interpret)
        ph.check(f"lw_{tag}_vs_f64", max_rel(lw.costs(i1, i2), ref_lw),
                 LIMITS["lw_sweep"])
        ph.check(f"sw_{tag}_vs_f64", max_rel(sw.costs(i1, i2), ref_sw),
                 LIMITS[f"sw_sweep_{tag}"])

    # g-point averaging: per-g fits of a rank-ordered optical depth
    od = np.asarray(data["bg_od"]) + 1e-3 * np.asarray(data["metric"])
    w = np.asarray(data["planck_hl"][1:])
    gp = np.repeat(np.arange(ng, dtype=np.int32),
                   np.diff(np.linspace(0, nwav, ng + 1).astype(int)))
    for method in ("linear", "square-root", "logarithmic", "transmission"):
        with jax.default_device(cpu):
            ref = average_od_to_gpoints(ng, gp, od, w, method)[0]
        with jax.default_device(gpu):
            got = average_od_to_gpoints(
                ng, gp, jnp.asarray(od, jnp.float32),
                jnp.asarray(w, jnp.float32), method)[0]
        ph.check(f"avg_{method}", max_rel(got, ref),
                 LIMITS[f"average_{method}"])

    # Fused kernel against the XLA form at full width, on the GPU
    big, ssi_big = _sweep_data(nwav_big, nlay, nseg)
    i1, i2 = big["i1"], big["i2"]
    lw_x, sw_x = _sweep_kernels(big, ssi_big, gpu, np.float32,
                                use_pallas=False)
    if kernel_on:
        lw_k, sw_k = _sweep_kernels(big, ssi_big, gpu, np.float32,
                                    use_pallas=True, interpret=interpret)
        ph.check("lw_kernel_vs_xla_2^21",
                 max_rel(lw_k.costs(i1, i2), lw_x.costs(i1, i2)),
                 LIMITS["lw_sweep"])
        ph.check("sw_kernel_vs_xla_2^21",
                 max_rel(sw_k.costs(i1, i2), sw_x.costs(i1, i2)),
                 LIMITS["sw_sweep_kernel"])
    prod = lw_k if kernel_on else lw_x
    with jax.default_device(gpu):
        compiled = prod.chained_bench_fn().lower(
            prod._bound_arrays, jnp.asarray(i1), jnp.asarray(i2),
            1).compile()
    mem = compiled.memory_analysis()
    if mem is not None:
        ph.note("sweep_2^21_temp_bytes", int(mem.temp_size_in_bytes))
        ph.note("sweep_2^21_argument_bytes", int(mem.argument_size_in_bytes))
    note_peak_memory(ph, gpu)
    ph.done()


# -------------------------------------------------------------- pipeline --

def _gpoint_ranks(path, gas="h2o"):
    from ecckd_tpu.io import NcFile
    with NcFile(path) as f:
        return (np.asarray(f.read(f"{gas}_rank1")),
                np.asarray(f.read(f"{gas}_rank2")))


def compare_gpoints(ph, tag_a, ranks_a, tag_b, ranks_b, limit):
    """Same g-point count, and rank bounds within ``limit`` ranks."""
    (a1, a2), (b1, b2) = ranks_a, ranks_b
    ph.note(f"ng_{tag_a}", len(a1))
    ph.note(f"ng_{tag_b}", len(b1))
    if len(a1) != len(b1):
        ph.failed.append("g-point count")
        ph.note("max_rank_shift", "n/a")
        return
    shift = int(max(np.max(np.abs(a1 - b1)), np.max(np.abs(a2 - b2))))
    ph.check("max_rank_shift", shift, limit)


def note_peak_memory(ph, device):
    """The device's peak bytes in use so far in this process: phases run
    in order, so a phase raised the peak only where its value grew."""
    stats = device.memory_stats() or {}
    ph.note("process_peak_bytes", stats.get("peak_bytes_in_use", "n/a"))


def pipeline_phase(gpu, nwav=1 << 20, nlay=50, is_sw=False, work=None):
    """The tool chain in float32, then find_g_points in float64."""
    import jax
    from ecckd_tpu.config import Config
    from ecckd_tpu.tools.find_g_points import find_g_points

    ph = Phase("pipeline_sw" if is_sw else "pipeline_lw")
    ph.note("nwav", nwav)
    ph.note("nlay", nlay)
    work = work or tempfile.mkdtemp(prefix="ecckd_smoke_")
    # The tools switch 64-bit types on or off by their ``precision``;
    # the entry state is restored afterwards.
    with x64(jax.config.jax_enable_x64), jax.default_device(gpu):
        res = bench.run_pipeline_bench(nwav, nlay, is_sw=is_sw,
                                       precision="float32", work=work)
        for key in ("reorder_s", "find_g_points_s", "create_lut_s",
                    "sweep_compile_s", "sweep_kernel_s",
                    "sweep_kernel_calls"):
            ph.note(key, res[key])
        cfg = dict(res["find_g_points_config"], precision="float64")
        cfg["output"] = os.path.join(work, "gpoints_f64.nc")
        t0 = time.perf_counter()
        find_g_points(Config(cfg), argv=["chip_smoke"])
        ph.note("find_g_points_f64_s", time.perf_counter() - t0)
    r1_32, r2_32 = _gpoint_ranks(res["gpoints"])
    r1_64, r2_64 = _gpoint_ranks(cfg["output"])
    compare_gpoints(ph, "f32", (r1_32, r2_32), "f64", (r1_64, r2_64),
                    LIMITS["rank_shift_f32_f64_sw" if is_sw
                           else "rank_shift_f32_f64_lw"])
    note_peak_memory(ph, gpu)
    ph.done()
    return res


# -------------------------------------------------------------- optimize --

@contextlib.contextmanager
def x64(enabled: bool):
    """Run a block with 64-bit types on or off (float32 device phases run
    as the tools do with ``precision=float32``)."""
    import jax
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", enabled)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def optimize_phase(gpu, cpu, solver_iters=20, ncol=48, nlay=50):
    """optimize_lut's train step against float64 on the CPU, the policy's
    solver, and the CKD forward step."""
    import jax
    import jax.numpy as jnp
    import __graft_entry__ as ge
    from ecckd_tpu.optimize.solver import solve

    ph = Phase("optimize")
    gnorm = lambda g: np.sqrt(sum(float(np.sum(np.asarray(v, np.float64)
                                               ** 2))
                                  for v in jax.tree.leaves(g)))
    with x64(True), jax.default_device(cpu):
        step64, x_64 = bench.build_train_step(ncol=ncol, nlay=nlay,
                                              dtype=np.float64)
        v64, g64 = jax.jit(step64)(x_64)
        v64, n64 = float(v64), gnorm(g64)
    with x64(False), jax.default_device(gpu):
        step32, x_32 = bench.build_train_step(ncol=ncol, nlay=nlay,
                                              dtype=np.float32)
        v32, g32 = jax.jit(step32)(x_32)
        v32, n32 = float(v32), gnorm(g32)
    ph.check("value_vs_f64", max_rel(v32, v64), LIMITS["optimize"])
    ph.check("grad_norm_vs_f64", max_rel(n32, n64), LIMITS["optimize"])

    with x64(False), jax.default_device(gpu):
        model, lbl = bench.build_optimize_problem(ncol=ncol, nlay=nlay)
        res = solve(model, [lbl], max_iterations=solver_iters,
                    prior_error=4.0, solver="auto")
        ph.note("solver_iterations", res.n_iterations)
        ph.note("solver_s_per_iter", res.seconds_per_iteration)
        ph.check("solver_cost_nonfinite",
                 0.0 if np.isfinite(res.cost) else 1.0, 0.0)

        fn, args = ge.entry()
        flux_dn, flux_up, hr = jax.jit(fn)(*args)
        finite = all(bool(jnp.all(jnp.isfinite(a)))
                     for a in (flux_dn, flux_up, hr))
        ph.note("forward_shapes", f"{tuple(flux_dn.shape)}"
                                  f"/{tuple(hr.shape)}")
        ph.check("forward_nonfinite", 0.0 if finite else 1.0, 0.0)
    note_peak_memory(ph, gpu)
    ph.done()


# ------------------------------------------------------------ four cards --

def four_card_phase(devices, nwav=1 << 20, nlay=50, sharded="auto"):
    """Sharded find_g_points on a 4-GPU mesh and a data-parallel train
    step, each against one GPU.  ``sharded`` is find_g_points' option for
    the mesh run ("auto": the execution policy's choice)."""
    import jax
    from ecckd_tpu.config import Config
    from ecckd_tpu.tools.find_g_points import find_g_points

    ph = Phase("four_cards")
    work = tempfile.mkdtemp(prefix="ecckd_smoke4_")
    with x64(jax.config.jax_enable_x64), jax.default_device(devices[0]):
        res = bench.run_pipeline_bench(nwav, nlay, precision="float32",
                                       work=work, tools=("reorder",))
        cfg = dict(res["find_g_points_config"])
        outs = {}
        for tag, mode in (("one", "0"), ("four", sharded)):
            cfg["output"] = os.path.join(work, f"gpoints_{tag}.nc")
            cfg["sharded"] = mode
            t0 = time.perf_counter()
            find_g_points(Config(cfg), argv=["chip_smoke"])
            ph.note(f"find_g_points_{tag}_s", time.perf_counter() - t0)
            outs[tag] = _gpoint_ranks(cfg["output"])
    compare_gpoints(ph, "one", outs["one"], "four", outs["four"],
                    LIMITS["rank_shift_sharded"])

    # The sweep's bound arrays must be spread over every device of the mesh
    from ecckd_tpu.parallel import make_mesh
    data, ssi = _sweep_data(1 << 14, nlay, 64)
    with x64(False):
        lw, _ = _sweep_kernels(data, ssi, devices[0], np.float32,
                               mesh=make_mesh(data_parallel=1))
    ph.note("sweep_shard_devices", len({
        d for a in jax.tree.leaves(lw._bound_arrays) for d in a.devices()}))

    v1, g1, v4, g4, placed = data_parallel_step(devices)
    ph.note("train_step_devices", placed)
    ph.check("dp_value_vs_one", max_rel(v4, v1), LIMITS["optimize"])
    ph.check("dp_grad_vs_one", max(max_rel(a, b) for a, b in zip(
        jax.tree.leaves(g4), jax.tree.leaves(g1))), LIMITS["optimize"])
    ph.done()


def data_parallel_step(devices, ncol=48, nlay=50):
    """One optimize_lut train step with the profiles sharded over
    ``devices`` (``data_parallel=1``) and the same step on one device."""
    import jax
    from ecckd_tpu.optimize.solver import _shard_scene_profiles

    with x64(False), jax.default_device(devices[0]):
        step1, x1 = bench.build_train_step(ncol=ncol, nlay=nlay,
                                           dtype=np.float32)
        v1, g1 = jax.jit(step1)(x1)
        step4, x4 = bench.build_train_step(
            ncol=ncol, nlay=nlay, dtype=np.float32,
            shard=_shard_scene_profiles)
        v4, g4 = jax.jit(step4)(x4)
    placed = len({d for leaf in jax.tree.leaves(step4.scene)
                  for d in leaf.devices()})
    return v1, g1, v4, g4, placed


# ------------------------------------------------------------------ main --

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-GPU phase")
    args = parser.parse_args(argv)

    import jax
    from ecckd_tpu.tools.common import configure_compile_cache

    configure_compile_cache()
    jax.config.update("jax_enable_x64", True)
    gpu = jax.devices()[0]
    if gpu.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; the default device is "
              f"{gpu.platform!r}", file=sys.stderr)
        return 2
    cpu = jax.devices("cpu")[0]

    ph = Phase("device")
    ph.note("device_kind", repr(gpu.device_kind))
    ph.note("count", len(jax.devices()))
    ph.done()
    print(gpu_info(), flush=True)        # as nvidia-smi prints it

    if args.four_cards:
        if len(jax.devices()) < 4:
            print("--four-cards needs four GPUs", file=sys.stderr)
            return 2
        four_card_phase(jax.devices()[:4])
    else:
        sweep_phase(gpu, cpu)
        work = tempfile.mkdtemp(prefix="ecckd_smoke_")
        try:
            pipeline_phase(gpu, work=os.path.join(work, "lw"))
            pipeline_phase(gpu, is_sw=True, work=os.path.join(work, "sw"))
        finally:
            shutil.rmtree(work, ignore_errors=True)
        optimize_phase(gpu, cpu)
    print(json.dumps({"ok": True, "device": bench.device_record(gpu)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
