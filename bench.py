"""Benchmark: spectral candidate-sweep kernel throughput per GPU.

Measures the framework's hot loop — the batched candidate-interval cost
kernel of find_g_points (fitted-od computation + broadband two-stream RT
over every wavenumber + prefix-sum interval reductions + heating-rate cost;
see ecckd_tpu/partition/cost_kernel.py) — on the default accelerator, in
float32, and reports wavenumber-bins x layers processed per second.

vs_baseline is the speedup over the same kernel executed on the host CPU
(the reference ecCKD publishes no benchmark numbers — BASELINE.md — so the
all-cores host run of the identical computation is the measured stand-in
for the OpenMP C++ reference).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device"}; fails when the default device is not a GPU unless
``BENCH_PLATFORM=cpu`` asks for a labelled CPU smoke run.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

NLAY = int(os.environ.get("BENCH_NLAY", 50))
NWAV = int(os.environ.get("BENCH_NWAV", 1 << 21))
NSEG = int(os.environ.get("BENCH_NSEG", 64))
N_ITERS = int(os.environ.get("BENCH_ITERS", 10))
CPU_NWAV = min(NWAV, 1 << 17)
CPU_ITERS = 3


def build_inputs(nlay, nwav, nseg, dtype):
    rng = np.random.default_rng(0)
    pressure_hl = np.exp(np.linspace(np.log(100.0), np.log(1.0e5),
                                     nlay + 1))
    wav = np.linspace(10.0, 3000.0, nwav)
    k = np.sort(10.0 ** rng.uniform(-4, 2, nwav))
    col = (pressure_hl[1:] - pressure_hl[:-1]) / pressure_hl[-1]
    od = np.outer(col, k)
    bg_od = 0.05 * col[:, None] * np.ones((1, nwav))
    from ecckd_tpu.ops import planck_function
    t_hl = np.linspace(210.0, 290.0, nlay + 1)
    planck_hl = np.asarray(planck_function(t_hl, wav,
                                           np.full(nwav, wav[1] - wav[0])))
    surf_planck = planck_hl[-1] * 1.05
    emis = np.ones(nwav)
    from ecckd_tpu.constants import LW_DIFFUSIVITY
    metric = -np.expm1(-LW_DIFFUSIVITY * od)
    # Plausible truth fields
    hr = rng.normal(0.0, 1e-5, (nlay, nwav))
    layer_weight = np.sqrt(pressure_hl[1:]) - np.sqrt(pressure_hl[:-1])
    layer_weight /= layer_weight.sum()
    edges = np.linspace(0, nwav, nseg + 1).astype(np.int32)
    i1 = edges[:-1]
    i2 = edges[1:] - 1
    seg_of_wav = np.repeat(np.arange(nseg, dtype=np.int32),
                           np.diff(edges))
    cast = lambda a: np.asarray(a, dtype)
    return dict(
        layer_weight=cast(layer_weight), pressure_hl=cast(pressure_hl),
        surf_emissivity=cast(emis), surf_planck=cast(surf_planck),
        flux_dn_surf=cast(planck_hl[-1] * 0.5),
        flux_up_toa=cast(planck_hl[0] * 0.8),
        planck_hl=cast(planck_hl), bg_od=cast(bg_od), metric=cast(metric),
        hr=cast(hr), i1=i1, i2=i2, seg_of_wav=seg_of_wav)


def run_bench(device, nwav, n_iters, dtype, use_pallas=None):
    import jax
    import jax.numpy as jnp
    from ecckd_tpu.partition.cost_kernel import CandidateCostLw

    data = build_inputs(NLAY, nwav, NSEG, dtype)
    with jax.default_device(device):
        t_build0 = time.perf_counter()
        kernel = CandidateCostLw(
            "transmission", 0.02, data["layer_weight"], data["pressure_hl"],
            data["surf_emissivity"], data["surf_planck"],
            data["flux_dn_surf"], data["flux_up_toa"], data["planck_hl"],
            data["bg_od"], data["metric"], data["hr"],
            use_pallas=use_pallas)
        jax.block_until_ready(kernel._bound_arrays)
        build_s = time.perf_counter() - t_build0
        arrays = kernel._bound_arrays
        i1 = jnp.asarray(data["i1"])
        i2 = jnp.asarray(data["i2"])

        # All iterations run inside ONE dispatch (fori_loop), serialized
        # by a genuine data dependency on the carry (see
        # cost_kernel.chained_bench_fn); keeps host dispatch latency
        # out of the measurement and defeats caching of repeated identical
        # executions.  The measured per-sweep work matches production: on
        # the prefix path the once-per-band prefix-sum build is OUTSIDE
        # the loop (amortized over a band's hundreds of probes in
        # find_g_points) and reported separately as build_s.
        jitted = kernel.chained_bench_fn()
        out = jitted(arrays, i1, i2, 1)   # compile + warm
        out.block_until_ready()
        t0 = time.perf_counter()
        out = jitted(arrays, i1, i2, n_iters)
        out.block_until_ready()
        dt = time.perf_counter() - t0
    if not np.isfinite(float(out)):
        raise RuntimeError("benchmark kernel produced non-finite costs")
    return (nwav * NLAY * n_iters / dt, kernel.use_prefix, kernel.use_pallas,
            build_s)


def run_bench_sw(device, nwav, n_iters, dtype, use_pallas=None):
    """SW candidate-sweep throughput (Zdunkowski direct+up two-stream,
    albedo 0.15 so the upwelling pass runs), chained single-dispatch
    timing like the LW bench."""
    import jax
    import jax.numpy as jnp
    from ecckd_tpu.partition.cost_kernel import CandidateCostSw

    data = build_inputs(NLAY, nwav, NSEG, dtype)
    rng = np.random.default_rng(1)
    ssi = np.asarray(np.abs(rng.normal(1.0, 0.1, nwav)), dtype)
    with jax.default_device(device):
        kernel = CandidateCostSw(
            "transmission", 0.02, data["layer_weight"], 0.5,
            data["pressure_hl"], ssi, 0.15,
            data["flux_dn_surf"], data["flux_up_toa"],
            data["bg_od"], data["metric"], data["hr"],
            use_pallas=use_pallas)
        arrays = kernel._bound_arrays
        i1 = jnp.asarray(data["i1"])
        i2 = jnp.asarray(data["i2"])

        jitted = kernel.chained_bench_fn()
        out = jitted(arrays, i1, i2, 1)
        out.block_until_ready()
        t0 = time.perf_counter()
        out = jitted(arrays, i1, i2, n_iters)
        out.block_until_ready()
        dt = time.perf_counter() - t0
    if not np.isfinite(float(out)):
        raise RuntimeError("SW benchmark kernel produced non-finite costs")
    return nwav * NLAY * n_iters / dt


# Published dense peaks by ``device_kind`` (NVIDIA H100 SXM5 data sheet):
# HBM3 bytes/s, float32 FLOP/s outside the tensor cores, TF32 and bf16
# tensor-core FLOP/s.  A device missing here is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_s=3.35e12, f32_flops=67e12,
                                  tf32_flops=495e12, bf16_flops=989e12),
}


def device_peaks(device):
    kind = getattr(device, "device_kind", "")
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind {kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[kind]


def roofline(device, throughput_bins_layers_s, nlay=NLAY, nseg=NSEG,
             prefix=False, kernel=False):
    """Bytes moved (and, for the XLA form, FLOPs) per sweep, as a share of
    the device's peaks.

    XLA form, non-prefix: device-memory reads of metric, bg_od, hr ((nlay,
    nwav) each), planck_hl ((nlay+1, nwav)) and ~5 nwav-length vectors ->
    (4*nlay + 6) * 4 bytes per wavenumber; interval reductions as
    full-precision f32 membership matmuls over ~(5*nlay + 4) rows (fit
    numerator+denominator 2*nlay, truth nlay+2, per-level broadband fluxes
    2*(nlay+1)) -> 2 * rows * nseg FLOPs per wavenumber.  With ``prefix``
    the fit/truth reductions are gathers into per-band prefix sums: reads
    drop to planck_hl + bg_od + 2 vectors -> (2*nlay + 3) * 4 bytes, and
    the matmul rows to 3*nlay + 2 (partition one-hot + flux reductions).

    ``kernel`` (the fused sweep kernel, which runs on the prefix path):
    the kernel reads planck_hl, bg_od, surface emissivity and Planck, and
    the partition map that a search over the bounds writes just before ->
    (2*nlay + 5) * 4 bytes per wavenumber.  Its fitted-od gathers come from
    a (nlay, nseg) table that stays in cache, and it reduces with lane sums
    rather than matmuls, so no FLOP share is given for it.
    """
    peaks = device_peaks(device)
    sweeps_per_s = throughput_bins_layers_s / float(nlay)  # per wavenumber
    if kernel:
        bytes_per_wav = (2 * nlay + 5) * 4.0
    else:
        bytes_per_wav = ((2 * nlay + 3) if prefix else (4 * nlay + 6)) * 4.0
    bytes_s = sweeps_per_s * bytes_per_wav
    out = {
        "device_kind": device.device_kind,
        "form": "kernel" if kernel else "xla",
        "hbm_read_gbps": bytes_s / 1e9,
        "bytes_per_bin_layer": bytes_per_wav / nlay,
        "pct_hbm_peak": 100.0 * bytes_s / peaks["hbm_bytes_s"],
    }
    if not kernel:
        rows = (3 * nlay + 2) if prefix else (5 * nlay + 4)
        flops_per_wav = 2.0 * rows * nseg
        flops = sweeps_per_s * flops_per_wav
        out.update(membership_gflops=flops / 1e9,
                   flops_per_bin_layer=flops_per_wav / nlay,
                   pct_f32_peak=100.0 * flops / peaks["f32_flops"])
    return out


def run_native_baseline(nwav, n_iters):
    """All-cores OpenMP C++ throughput of the identical sweep computation
    (csrc/sweep_baseline.cpp) — the measured stand-in for the reference's
    OpenMP hot loop (Equipartition::calc_error_all). Returns
    bins*layers/s or None if the native library is unavailable."""
    from ecckd_tpu.partition import native_baseline

    if not native_baseline.available():
        return None
    data = build_inputs(NLAY, nwav, NSEG, np.float32)
    args = (data["layer_weight"], data["pressure_hl"],
            data["surf_emissivity"], data["surf_planck"],
            data["flux_dn_surf"], data["flux_up_toa"], data["planck_hl"],
            data["bg_od"], data["metric"], data["hr"],
            data["i1"], data["i2"], 0.02)
    native_baseline.sweep_lw_cost_transmission(*args)  # warm (thread pool)
    # Best of 3 passes: transient host contention deflates the baseline
    # and silently inflates vs_baseline — the fastest pass is the honest
    # capability.
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n_iters):
            out = native_baseline.sweep_lw_cost_transmission(*args)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    if not np.all(np.isfinite(out)):
        raise RuntimeError("native baseline produced non-finite costs")
    return nwav * NLAY * n_iters / best


def build_optimize_problem(ng=64, nt=6, npress=53, ncol=48, nlay=50):
    """(model, lbl): a synthetic LW optimize_lut problem of production size
    (64 g-points, 6x53 LUT, ``ncol`` training columns of ``nlay``
    layers)."""
    import __graft_entry__ as ge
    from ecckd_tpu.io.lbl_fluxes import LblFluxes
    from ecckd_tpu.constants import ACCEL_GRAVITY, SPECIFIC_HEAT_AIR

    model = ge._synthetic_model(ng=ng, nt=nt, npress=npress)
    pressure_hl, temperature_hl, vmr = ge._atmosphere(model, ncol=ncol,
                                                      nlay=nlay)
    rng = np.random.default_rng(0)
    lbl = LblFluxes()
    lbl.is_sw = False
    lbl.pressure_hl = pressure_hl
    lbl.temperature_hl = temperature_hl
    lbl.vmr_fl = vmr[:, None, :]
    lbl.molecules = ["h2o"]
    lbl.spectral_flux_dn = np.abs(rng.normal(5.0, 1.0,
                                             (ncol, nlay + 1, ng)))
    lbl.spectral_flux_up = np.abs(rng.normal(5.0, 1.0,
                                             (ncol, nlay + 1, ng)))
    lbl.flux_dn = lbl.spectral_flux_dn.sum(-1)
    lbl.flux_up = lbl.spectral_flux_up.sum(-1)
    conv = -(ACCEL_GRAVITY / SPECIFIC_HEAT_AIR) / np.diff(pressure_hl,
                                                          axis=1)
    lbl.spectral_heating_rate = conv[:, :, None] * (
        np.diff(lbl.spectral_flux_dn, axis=1)
        - np.diff(lbl.spectral_flux_up, axis=1))
    lbl.heating_rate = lbl.spectral_heating_rate.sum(-1)
    lbl.surf_emissivity = np.ones((ncol, ng))
    lbl.make_gas_mapping(model.molecules)
    lbl.planck_hl = np.asarray(model.calc_planck_function(temperature_hl))
    lbl.surf_planck = np.asarray(
        model.calc_planck_function(temperature_hl[:, -1]))
    lbl.have_spectral_fluxes = True

    return model, lbl


def build_train_step(ng=64, nt=6, npress=53, ncol=48, nlay=50,
                     dtype=np.float32, shard=None):
    """One optimize_lut training iteration (cost + gradient of the log-LUT
    state, the per-iteration work of solve_adept.cpp:240-291) on the
    :func:`build_optimize_problem` problem.  ``shard(scene, meta)``
    places the scene's arrays (optimize_lut's ``data_parallel``); the
    returned step keeps the placed scene as ``step.scene``."""
    import jax
    import jax.numpy as jnp
    from ecckd_tpu.optimize import (build_scene, make_cost_fn, make_prior_fn,
                                    log_state_tree)
    from ecckd_tpu.ops.cost import CostWeights

    model, lbl = build_optimize_problem(ng, nt, npress, ncol, nlay)
    scene, meta = build_scene(model, lbl)
    scene = type(scene)(*[None if a is None else jnp.asarray(
        np.asarray(a, np.float64).astype(dtype)
        if np.asarray(a).dtype.kind == "f" else np.asarray(a))
        for a in scene])
    if shard is not None:
        scene, meta = shard(scene, meta)
    cost_fn = make_cost_fn(model, [(scene, meta)], CostWeights())
    prior_fn = make_prior_fn(model)
    x_tree = {k: jnp.asarray(np.asarray(v, dtype))
              for k, v in log_state_tree(model).items()}
    prior_tree = dict(x_tree)

    def step(tree):
        return jax.value_and_grad(
            lambda t: cost_fn(t) + prior_fn(t, prior_tree))(tree)

    step.scene = scene
    return step, x_tree


def build_bench_shard(nwav, nlay, dtype=np.float32):
    """Synthetic CKDMIP-scale spectral shard on disk (cached by size)."""
    from ecckd_tpu.io.shards import write_shard
    from ecckd_tpu.io.spectrum import Spectrum

    path = os.path.join(tempfile.gettempdir(),
                        f"ecckd_bench_shard_{nwav}x{nlay}_"
                        f"{np.dtype(dtype).name}.spbin")
    if os.path.exists(path):
        return path
    rng = np.random.default_rng(0)
    pressure_hl = np.exp(np.linspace(np.log(100.0), np.log(1.0e5),
                                     nlay + 1))
    wav = np.linspace(10.0, 3000.0, nwav)
    k = np.sort(10.0 ** rng.uniform(-4, 2, nwav)).astype(dtype)
    col = ((pressure_hl[1:] - pressure_hl[:-1])
           / pressure_hl[-1]).astype(dtype)
    od = col[:, None] * k[None, :]
    od[od < 1e-4] = 0.0  # exercise the logarithmic zero-od branch
    spec = Spectrum(
        pressure_hl=pressure_hl,
        temperature_hl=np.linspace(210.0, 290.0, nlay + 1),
        wavenumber=wav, d_wavenumber=np.full(nwav, wav[1] - wav[0]),
        optical_depth=od, molecule="bench")
    return write_shard(path, spec, dtype=dtype)


def run_streaming_bench(device, nwav, nlay, ng=64, block_wav=1 << 18,
                        averaging_method="logarithmic"):
    """CKDMIP-scale streaming g-point averaging: double-buffered native
    shard reads overlapping device accumulation — the pass whose disk reads
    dominate the reference's wall clock (create_look_up_table.cpp:242-340,
    doc/ecckd_documentation.tex:225-228).  The warm pass leaves the shard
    in the OS page cache, so the timed number is the host->device
    streaming + reduction throughput (the bound disk cannot inflate).
    Uses the logarithmic method because it exercises the heaviest
    accumulator path (per-block zero-od counting plus masked log sums,
    average_optical_depth.cpp:120-170); the reference's default method is
    'transmission' (create_look_up_table.cpp:245)."""
    import jax
    from ecckd_tpu.io.shards import ShardReader
    from ecckd_tpu.ops.streaming import streaming_average_od_to_gpoints
    from ecckd_tpu.ops import planck_function

    path = build_bench_shard(nwav, nlay)
    edges = np.linspace(0, nwav, ng + 1).astype(np.int64)
    g_point = np.repeat(np.arange(ng, dtype=np.int32), np.diff(edges))
    with ShardReader(path) as reader:
        t_fl = 0.5 * (reader.temperature_hl[1:]
                      + reader.temperature_hl[:-1])
        planck_fl = np.asarray(planck_function(
            t_fl, reader.wavenumber, reader.d_wavenumber),
            np.float32)
        weight_fn = lambda i0, nb: planck_fl[:, i0:i0 + nb]
        pressure_fl = 0.5 * (reader.pressure_hl[1:]
                             + reader.pressure_hl[:-1])
        with jax.default_device(device):
            args = (reader, ng, g_point, weight_fn, averaging_method)
            kw = dict(block_wav=block_wav, pressure_fl=pressure_fl)
            streaming_average_od_to_gpoints(*args, **kw)  # compile + warm
            t0 = time.perf_counter()
            od_fit, _, _ = streaming_average_od_to_gpoints(*args, **kw)
            dt = time.perf_counter() - t0
    if not np.all(np.isfinite(od_fit)):
        raise RuntimeError("streaming bench produced non-finite od")
    return nwav * nlay / dt


def run_optimize_bench(device, n_iters):
    """Chained single-dispatch timing: all iterations run inside ONE
    fori_loop dispatch, serialized by a genuine data dependency on the
    carry, so dispatch latency stays out of the number (like the sweep
    benches)."""
    import jax
    import jax.numpy as jnp

    with jax.default_device(device):
        step, x_tree = build_train_step()

        def chained(tree, n):
            def body(_, carry):
                acc, tree = carry
                # Additive perturbation far below the f32 ulp: values stay
                # bit-identical at runtime but the dependency defeats
                # constant folding/hoisting of the loop body.
                tree2 = jax.tree.map(
                    lambda x: x + acc * jnp.asarray(1e-45, x.dtype), tree)
                val, grad = step(tree2)
                leaves = jax.tree.leaves(grad)
                gsum = sum(jnp.sum(g) for g in leaves)
                return (acc + (val + gsum) * jnp.asarray(1e-30, val.dtype),
                        tree)

            z = jnp.asarray(0.0, jax.tree.leaves(tree)[0].dtype)
            return jax.lax.fori_loop(0, n, body, (z, tree))[0]

        jitted = jax.jit(chained)   # n traced: one compile for any count
        out = jitted(x_tree, 1)   # compile + warm
        out.block_until_ready()
        t0 = time.perf_counter()
        out = jitted(x_tree, n_iters)
        out.block_until_ready()
        dt = time.perf_counter() - t0
    if not np.isfinite(float(out)):
        raise RuntimeError("optimize bench produced non-finite cost")
    return dt / n_iters


def build_bench_ssi(path, spectrum_path):
    """Solar spectral irradiance file matching a spectrum's wavenumbers
    (SW pipeline bench input; read_solar_spectrum.cpp layout)."""
    from ecckd_tpu.io import NcFile, NcWriter

    if os.path.exists(path):
        return path
    f = NcFile(spectrum_path)
    wavenumber = np.asarray(f.read("wavenumber"))
    f.close()
    ssi = 20.0 * np.exp(-((wavenumber - 20000.0) / 15000.0) ** 2) + 0.5
    ssi = ssi * (1361.0 / ssi.sum())
    with NcWriter(path) as w:
        w.define_dimension("wavenumber", len(wavenumber))
        w.define_variable("wavenumber", "double", "wavenumber")
        w.define_variable("solar_spectral_irradiance", "double",
                          "wavenumber")
        w.define_variable("total_solar_irradiance", "double")
        w.write(wavenumber, "wavenumber")
        w.write(ssi, "solar_spectral_irradiance")
        w.write(float(ssi.sum()), "total_solar_irradiance")
    return path


def build_bench_spectrum(path, nwav, nlay, ncol=1, seed=0, is_sw=False):
    """CKDMIP-shaped synthetic absorption spectrum file on disk
    (read_spectrum.cpp layout; ~200 MB f32 per column at 2^20 wavenumbers,
    50 layers — the shape of one CKDMIP Idealized member).  ``is_sw``
    covers the solar wavenumber range instead of the thermal one."""
    from ecckd_tpu.io import NcWriter

    if os.path.exists(path):
        return path
    rng = np.random.default_rng(seed)
    pressure_hl = np.exp(np.linspace(np.log(100.0), np.log(1.013e5),
                                     nlay + 1))
    temperature_hl = np.linspace(210.0, 284.0, nlay + 1)
    wavenumber = (np.linspace(250.0, 50000.0, nwav) if is_sw
                  else np.linspace(1.0, 2500.0, nwav))
    d_wavenumber = np.gradient(wavenumber)
    k = np.full(nwav, 1e-4)
    span = wavenumber[-1] - wavenumber[0]
    for c0, s, wd in zip(rng.uniform(wavenumber[0], wavenumber[-1], 120),
                         10.0 ** rng.uniform(-1, 3.5, 120),
                         rng.uniform(2.0, 40.0, 120) * (span / 2500.0)):
        k += s / (1.0 + ((wavenumber - c0) / wd) ** 2)
    vmr = 0.01
    col_mass = np.diff(pressure_hl) / 9.80665 / 0.02897
    with NcWriter(path) as w:
        w.define_dimension("column", None)
        w.define_dimension("half_level", nlay + 1)
        w.define_dimension("level", nlay)
        w.define_dimension("wavenumber", nwav)
        w.define_variable("pressure_hl", "double", "column", "half_level")
        w.define_variable("temperature_hl", "double", "column",
                          "half_level")
        w.define_variable("wavenumber", "double", "wavenumber")
        w.define_variable("d_wavenumber", "double", "wavenumber")
        w.define_variable("optical_depth", "float", "column", "level",
                          "wavenumber")
        w.define_variable("reference_surface_mole_fraction", "double")
        w.define_variable("mole_fraction_fl", "double", "column", "level")
        w.write_attribute("h2o", "constituent_id")
        w.write_attribute("synthetic benchmark spectrum", "title")
        w.end_define()
        w.write(wavenumber, "wavenumber")
        w.write(d_wavenumber, "d_wavenumber")
        w.write(vmr, "reference_surface_mole_fraction")
        tfact = np.exp(0.02 * (temperature_hl[1:, None] - 250.0))
        od = (vmr * col_mass[:, None] * 1e-3 * k[None, :] * tfact)
        for icol in range(ncol):
            w.write(pressure_hl, "pressure_hl", index=icol)
            w.write(temperature_hl, "temperature_hl", index=icol)
            w.write(od.astype(np.float32), "optical_depth", index=icol)
            w.write(np.full(nlay, vmr), "mole_fraction_fl", index=icol)
    return path


def run_pipeline_bench(nwav, nlay, use_pallas=None, hr_tol=0.2,
                       is_sw=False, precision="float64", work=None,
                       tools=("reorder", "find_g_points", "create_lut")):
    """End-to-end device execution of the real tools (BASELINE.md
    criterion 3): reorder_spectrum -> find_g_points -> create_lut on a
    CKDMIP-shaped synthetic spectrum (LW by default; ``is_sw`` runs the
    solar chain with an SSI file and the total-transmission method),
    through the actual tool entry points, at the tools' ``precision``.
    ``tools`` may stop the chain early.  Times each tool's wall clock
    and the fraction of find_g_points spent inside candidate-sweep kernel
    calls (device compute + dispatch) vs host control flow
    (equipartition's serial decisions).  Returns a dict, which also
    carries the find_g_points configuration and output paths."""
    from ecckd_tpu.config import Config
    from ecckd_tpu.partition import cost_kernel
    from ecckd_tpu.tools.reorder_spectrum import reorder_spectrum
    from ecckd_tpu.tools.find_g_points import find_g_points
    from ecckd_tpu.tools.create_lut import create_lut

    work = work or tempfile.mkdtemp(prefix="ecckd_bench_pipe_")
    os.makedirs(work, exist_ok=True)
    spec = build_bench_spectrum(os.path.join(work, "spectrum.nc"), nwav,
                                nlay, is_sw=is_sw)
    ssi_path = None
    if is_sw:
        ssi_path = build_bench_ssi(os.path.join(work, "ssi.nc"), spec)

    kernel_s = [0.0, 0]
    compile_s = [0.0, 0]
    seen_buckets = set()
    orig_costs = cost_kernel._CandidateCostBase.costs

    def timed_costs(self, i1, i2, seg=None):
        bucket = (id(self), cost_kernel._pad_to_bucket(len(i1)))
        first = bucket not in seen_buckets
        seen_buckets.add(bucket)
        t0 = time.perf_counter()
        out = orig_costs(self, i1, i2, seg)
        dt = time.perf_counter() - t0
        # First call per (kernel, bucket) pays the XLA compile;
        # split it out so kernel_fraction reflects warm execution.
        if first:
            compile_s[0] += dt
            compile_s[1] += 1
        else:
            kernel_s[0] += dt
            kernel_s[1] += 1
        return out

    out = {"nwav": nwav, "nlay": nlay, "is_sw": is_sw,
           "precision": precision}
    order = os.path.join(work, "order.nc")
    gpoints = os.path.join(work, "gpoints.nc")
    lut = os.path.join(work, "lut.nc")
    t0 = time.perf_counter()
    reorder_cfg = {"input": spec, "output": order, "precision": precision}
    if is_sw:
        reorder_cfg["ssi"] = ssi_path
        reorder_cfg["threshold_optical_depth"] = "0.25"
    reorder_spectrum(Config(reorder_cfg), argv=["b"])
    out["reorder_s"] = time.perf_counter() - t0

    method = "total-transmission" if is_sw else "transmission"
    fgp_cfg = {"output": gpoints, "gases": "h2o",
               "heating_rate_tolerance": str(hr_tol),
               "averaging_method": method, "precision": precision,
               "h2o.reordering_input": order, "h2o.input": spec}
    if is_sw:
        fgp_cfg["ssi"] = ssi_path
        fgp_cfg["h2o.min_scaling"] = "0.5"
        fgp_cfg["h2o.max_scaling"] = "2.0"
    if use_pallas is not None:
        fgp_cfg["use_pallas"] = "1" if use_pallas else "0"
    out["find_g_points_config"] = dict(fgp_cfg)
    if "find_g_points" not in tools:
        return out
    cost_kernel._CandidateCostBase.costs = timed_costs
    try:
        t0 = time.perf_counter()
        find_g_points(Config(fgp_cfg), argv=["b"])
        out["find_g_points_s"] = time.perf_counter() - t0
    finally:
        cost_kernel._CandidateCostBase.costs = orig_costs
    out["gpoints"] = gpoints
    out["sweep_kernel_s"] = kernel_s[0]
    out["sweep_kernel_calls"] = kernel_s[1]
    out["sweep_compile_s"] = compile_s[0]
    out["sweep_compiles"] = compile_s[1]
    out["kernel_fraction"] = kernel_s[0] / out["find_g_points_s"]
    if "create_lut" not in tools:
        return out

    t0 = time.perf_counter()
    lut_cfg = {"input": gpoints, "output": lut, "gases": "h2o",
               "averaging_method": ("transmission" if not is_sw
                                    else "logarithmic"),
               "precision": precision,
               "h2o.conc_dependence": "linear", "h2o.input": spec}
    if is_sw and ssi_path:
        lut_cfg["ssi"] = ssi_path
    create_lut(Config(lut_cfg), argv=["b"])
    out["create_lut_s"] = time.perf_counter() - t0
    out["total_s"] = (out["reorder_s"] + out["find_g_points_s"]
                      + out["create_lut_s"])
    return out


def bench_device():
    """The device to measure: the default device, which must be a GPU.
    ``BENCH_PLATFORM=cpu`` pins a labelled CPU smoke run instead."""
    import jax

    platform = os.environ.get("BENCH_PLATFORM")
    if platform:
        jax.config.update("jax_platforms", platform)
    device = jax.devices()[0]
    if device.platform != "gpu" and platform != "cpu":
        raise SystemExit(f"bench.py measures a GPU; the default device is "
                         f"{device.platform!r} (BENCH_PLATFORM=cpu runs a "
                         "labelled CPU smoke run)")
    return device


def device_record(device):
    import jax
    return {"platform": device.platform, "kind": device.device_kind,
            "count": len(jax.devices())}


def main():
    import jax
    from ecckd_tpu.tools.common import configure_compile_cache

    configure_compile_cache()
    accel = bench_device()
    device = device_record(accel)

    metric_mode = os.environ.get("BENCH_METRIC", "")
    if metric_mode == "optimize":
        print(json.dumps({
            "metric": "optimize_lut_seconds_per_iteration",
            "value": run_optimize_bench(accel, max(N_ITERS, 200)),
            "unit": "s/iter",
            "device": device,
        }))
        return

    if metric_mode == "pipeline":
        nwav = int(os.environ.get("BENCH_NWAV", 1 << 20))
        use_pallas = None
        if os.environ.get("BENCH_KERNEL"):
            use_pallas = os.environ["BENCH_KERNEL"] == "pallas"
        res = run_pipeline_bench(
            nwav, NLAY, use_pallas=use_pallas,
            hr_tol=float(os.environ.get("BENCH_HR_TOL", 0.2)),
            is_sw=os.environ.get("BENCH_SW") == "1")
        print(json.dumps({
            "metric": "pipeline_end_to_end_seconds",
            "value": res["total_s"],
            "unit": "s",
            "device": device,
            "detail": res,
        }))
        return

    if metric_mode == "streaming":
        nwav = int(os.environ.get("BENCH_NWAV", 1 << 22))
        print(json.dumps({
            "metric": "streaming_gpoint_average_wavenumber_bins_layers_per_s",
            "value": run_streaming_bench(accel, nwav, NLAY),
            "unit": "bins*layers/s",
            "device": device,
        }))
        return

    if metric_mode == "sw":
        print(json.dumps({
            "metric": "sw_candidate_sweep_wavenumber_bins_layers_per_s",
            "value": run_bench_sw(accel, NWAV, N_ITERS, np.float32),
            "unit": "bins*layers/s",
            "device": device,
        }))
        return

    throughput, used_prefix, used_kernel, build_s = run_bench(
        accel, NWAV, N_ITERS, np.float32)

    # Baseline: the native OpenMP C++ implementation of the same
    # computation (reference-style candidate parallelism, all host cores);
    # the JAX form on the host CPU where the native library is missing.
    cpu_throughput = run_native_baseline(CPU_NWAV, CPU_ITERS)
    if cpu_throughput is None:
        cpu_throughput = run_bench(jax.devices("cpu")[0], CPU_NWAV,
                                   CPU_ITERS, np.float32,
                                   use_pallas=False)[0]

    result = {
        "metric": "candidate_sweep_wavenumber_bins_layers_per_s_per_chip",
        "value": throughput,
        "unit": "bins*layers/s",
        "vs_baseline": throughput / cpu_throughput,
        "device": device,
        "prefix_path": used_prefix,
        "fused_kernel": used_kernel,
        "prefix_build_s": build_s,
    }
    # Roofline + the SW-sweep and optimize entries ride the same line
    # (BENCH_SKIP_EXTRAS=1 for the single-metric output).
    if os.environ.get("BENCH_SKIP_EXTRAS") != "1":
        if accel.platform == "gpu":
            result["roofline"] = roofline(accel, throughput,
                                          prefix=used_prefix,
                                          kernel=used_kernel)
        result["sw_sweep_bins_layers_per_s"] = run_bench_sw(
            accel, NWAV, N_ITERS, np.float32)
        result["optimize_s_per_iter"] = run_optimize_bench(
            accel, max(N_ITERS, 200))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
