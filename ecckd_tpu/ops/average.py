"""Spectral averaging: candidate-interval fits and g-point LUT averaging.

Two families, both expressed as parallel segment reductions:

* Interval fits used during g-point search — equivalents of
  ``fit_optical_depth_lw/sw/sw_total_trans`` (find_g_points.cpp:54-204).
  Operate on rank-contiguous intervals via prefix sums, batched over all
  candidate intervals at once.

* G-point LUT averaging used by create_look_up_table — equivalent of
  ``average_optical_depth_to_g_point`` (average_optical_depth.cpp:21-197),
  with the OpenMP-over-g loop (P2) replaced by one-hot matmul segment
  reductions as matmuls.

Reference quirks reproduced deliberately (documented in SURVEY.md §7):
* the 0.9999999999999999 transmission clamp (average_optical_depth.cpp:48);
* LW logarithmic fit weights: numerator Planck at the layer *base*
  (planck_hl[iz+1]), denominator at the layer *top* (planck_hl[iz])
  (find_g_points.cpp:85-99);
* the SW transmission clamp applied before normalization
  (find_g_points.cpp:125-133);
* ``abs(-log(1-x))`` to strip the sign of a negative zero
  (average_optical_depth.cpp:168).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (LW_DIFFUSIVITY, ACCEL_GRAVITY, MOLAR_MASS_DRY_AIR)
from .segments import (_member_dot, interval_sum, interval_sum_fused,
                       part_of)

_TRANS_CLAMP = 0.9999999999999999


def _trans_clamp(dtype):
    """Largest representable transmission mean below 1 for the dtype.

    The reference's double constant 0.9999999999999999 rounds to exactly
    1.0f in float32, which would make -log1p(-mean) infinite; cap f32 at
    1 - 1e-6 (od cap ~8.3 at the LW diffusivity), f64 keeps reference
    parity.
    """
    if jnp.dtype(dtype) == jnp.float64:
        return _TRANS_CLAMP
    return 1.0 - 1.0e-6

# Scale factor of the transmission applied per method name
_METHOD_SCALE = {
    "transmission": 1.0,
    "transmission-2": 2.0,
    "transmission-3": 3.0,
    "transmission-10": 10.0,
}


def fit_optical_depth_lw(averaging_method, planck_hl, metric, i1, i2):
    """Fitted (grey) od per layer for each rank interval, LW weighting.

    Args:
      averaging_method: one of linear/transmission/transmission-2/square-root/
        logarithmic.
      planck_hl: (nlev+1, nwav) Planck function (rank-ordered wavenumbers).
      metric: (nlay, nwav) sorting metric (od, 1-exp(-D od), or sqrt(od)
        depending on method; built by the caller as in find_g_points.cpp:1119).
      i1, i2: (nseg,) inclusive interval bounds in rank space.

    Returns:
      (nlay, nseg) fitted optical depth per layer and interval.
    """
    parts, rows, finish = fit_parts_lw(averaging_method, planck_hl, metric)
    sums = interval_sum_fused(parts, metric.shape[-1], i1, i2,
                              dtype=metric.dtype)
    return finish(sums, i1, i2)


def fit_parts_lw(averaging_method, planck_hl, metric):
    """Decomposed LW interval fit: ``(parts, rows, finish)``.

    ``parts`` are fused-reduction operand producers (ops.segments
    ``interval_sum_fused``) covering ``rows`` output rows;
    ``finish(sums, i1, i2)`` maps the (rows, nseg) stacked sums to the
    fitted od.  Exposing the decomposition lets the candidate-sweep kernel
    reduce fit operands AND truth fluxes in ONE pass over the spectrum."""
    w_num = planck_hl[1:]   # weights at layer base (ref :61-63)
    nlay = metric.shape[0]

    if averaging_method in ("linear", "transmission", "transmission-2",
                            "square-root"):
        parts = [part_of(metric, w_num), part_of(w_num)]

        def finish(sums, i1, i2):
            mean = sums[:nlay] / sums[nlay:2 * nlay]
            if averaging_method == "linear":
                return mean
            if averaging_method == "square-root":
                return mean * mean
            scale = _METHOD_SCALE[averaging_method]
            mean = jnp.minimum(_trans_clamp(metric.dtype), mean)
            return jnp.abs(-jnp.log1p(-mean) / (LW_DIFFUSIVITY * scale))

        return parts, 2 * nlay, finish

    if averaging_method == "logarithmic":
        return _log_fit_parts(metric, w_num, planck_hl[:-1])
    raise ValueError(f"Averaging method {averaging_method!r} not understood")


def fit_optical_depth_sw(averaging_method, ssi, metric, i1, i2):
    """Fitted od per layer for each interval, SW (solar-irradiance) weighting.

    Ref fit_optical_depth_sw (find_g_points.cpp:113-168).
    """
    parts, rows, finish = fit_parts_sw(averaging_method, ssi, metric)
    sums = interval_sum_fused(parts, metric.shape[-1], i1, i2,
                              dtype=metric.dtype)
    return finish(sums, i1, i2)


def fit_parts_sw(averaging_method, ssi, metric):
    """Decomposed SW interval fit (see :func:`fit_parts_lw`)."""
    nlay = metric.shape[0]
    if averaging_method in ("linear", "transmission", "transmission-2",
                            "square-root"):
        parts = [part_of(metric, ssi), part_of(ssi)]

        def finish(sums, i1, i2):
            wsum_m, wsum = sums[:nlay], sums[nlay]
            norm = 1.0 / wsum
            if averaging_method == "linear":
                return wsum_m * norm
            if averaging_method == "square-root":
                fit = wsum_m * norm
                return fit * fit
            scale = _METHOD_SCALE[averaging_method]
            # NOTE: clamp applied before normalization, as in the reference
            mean = jnp.minimum(_trans_clamp(metric.dtype), wsum_m) * norm
            return jnp.abs(-jnp.log1p(-mean) / (LW_DIFFUSIVITY * scale))

        return parts, nlay + 1, finish

    if averaging_method in ("logarithmic", "total-transmission"):
        return _log_fit_parts(metric, ssi, ssi)
    raise ValueError(f"Averaging method {averaging_method!r} not understood")


def _log_fit_parts(metric, w_num, w_den):
    """Logarithmic average handling zeros (ref find_g_points.cpp:80-110)
    as a fused-reduction decomposition.

    Pure log-average over nonzero entries, scaled by the nonzero fraction
    when some entries are zero; zero when all are zero.  The three
    reductions (log-weighted sum, nonzero-masked denominator weights,
    nonzero count) are built per tile from the raw operands — the log/mask
    temporaries never hit HBM.
    """
    nlay = metric.shape[0]
    w_num = jnp.asarray(w_num)
    w_den = jnp.asarray(w_den)

    def rows2d(a, start, size):
        sl = jax.lax.dynamic_slice_in_dim(a, start, size, axis=a.ndim - 1)
        return sl[None, :] if a.ndim == 1 else sl

    def log_part(start, size):
        m = jax.lax.dynamic_slice_in_dim(metric, start, size, axis=-1)
        wn = rows2d(w_num, start, size)
        wd = rows2d(w_den, start, size)
        nonzero = m > 0.0
        nz = nonzero.astype(m.dtype)
        log_m = jnp.where(nonzero, jnp.log(jnp.where(nonzero, m, 1.0)), 0.0)
        return jnp.concatenate(
            [log_m * wn * nz,
             jnp.broadcast_to(wd, m.shape) * nz, nz], axis=0)

    def finish(sums, i1, i2):
        sum_log = sums[:nlay]
        sum_w_den_nz = sums[nlay:2 * nlay]
        count_nz = sums[2 * nlay:3 * nlay]
        count_all = (i2 - i1 + 1).astype(metric.dtype)

        all_nonzero = count_nz >= count_all
        none_nonzero = count_nz <= 0.0
        # Pure case denominator uses w_den over *nonzero* columns because
        # when all are nonzero iindex == index (ref :86-87 uses
        # planck_hl(iz,iindex)).
        denom = jnp.where(none_nonzero, 1.0, sum_w_den_nz)
        fit = jnp.exp(sum_log / denom)
        frac = count_nz / count_all
        fit = jnp.where(all_nonzero, fit, fit * frac)
        return jnp.where(none_nonzero, 0.0, fit)

    return [log_part], 3 * nlay, finish


def total_trans_fit_parts(ssi, bg_od, od):
    """Decomposed total-transmission fit: ``(parts, rows, finish)``.

    Like :func:`fit_parts_sw` but for the total-transmission method
    (ref find_g_points.cpp:173-204): the interval reductions (per-level
    broadband direct fluxes with/without the target gas, plus the linear
    fallback numerator) are exposed as fused-reduction parts so callers can
    shard/psum them; ``finish(sums, i1, i2)`` derives the fitted od from
    the (globally reduced) sums."""
    sec = 2.0
    nlay = od.shape[0]
    ssi = jnp.asarray(ssi)

    def levels_part(start, size):
        """All per-level direct fluxes of a wavenumber tile at once: the
        layer recurrence is a cumulative sum of optical depths (tiny axis,
        nlay ~ 50), so one tile read yields every flux row — no scan with
        full-spectrum carries, no per-layer reduction passes."""
        ssi_t = jax.lax.dynamic_slice_in_dim(ssi, start, size, 0)[None, :]
        bg_t = jax.lax.dynamic_slice_in_dim(bg_od, start, size, axis=-1)
        od_t = jax.lax.dynamic_slice_in_dim(od, start, size, axis=-1)
        bg_flux = ssi_t * jnp.exp(-sec * jnp.cumsum(bg_t, axis=0))
        flux = ssi_t * jnp.exp(-sec * jnp.cumsum(bg_t + od_t, axis=0))
        return jnp.concatenate([ssi_t, bg_flux, flux], axis=0)

    def finish(sums, i1, i2):
        top = sums[0]
        bb_bg = sums[1:nlay + 1]
        bb = sums[nlay + 1:2 * nlay + 1]
        bb_bg_above = jnp.concatenate([top[None], bb_bg[:-1]], axis=0)
        bb_above = jnp.concatenate([top[None], bb[:-1]], axis=0)

        ok = (bb_bg > 0.0) & (bb > 0.0)
        safe_bg = jnp.where(ok, bb_bg, 1.0)
        safe = jnp.where(ok, bb, 1.0)
        bg_fit = -0.5 * jnp.log(safe_bg / jnp.maximum(bb_bg_above, 1e-300))
        fit = -0.5 * jnp.log(safe / jnp.maximum(bb_above, 1e-300)) - bg_fit

        linear = sums[2 * nlay + 1:] / top
        any_bad = jnp.any(~ok, axis=0)          # (nseg,)
        return jnp.where(any_bad[None, :], linear, fit)

    return [levels_part, part_of(od, ssi)], 3 * nlay + 1, finish


def fit_optical_depth_sw_total_trans(ssi, bg_od, od, i1, i2):
    """Total-transmission fit (ref find_g_points.cpp:173-204).

    The per-layer fitted od is derived from broadband direct-flux ratios at
    secant 2 with/without the target gas; falls back to the linear SSI
    average for the entire profile if the broadband flux underflows to zero
    at any layer (replicating the reference's whole-vector overwrite).

    Returns (nlay, nseg).
    """
    parts, rows, finish = total_trans_fit_parts(ssi, bg_od, od)
    sums = interval_sum_fused(parts, od.shape[-1], i1, i2, dtype=od.dtype)
    return finish(sums, i1, i2)


# ---------------------------------------------------------------------------
# G-point LUT averaging (create_look_up_table)
# ---------------------------------------------------------------------------

def average_od_to_gpoints(ng, g_point, optical_depth, weight,
                          averaging_method, pressure_fl=None):
    """Average spectral od into g-points (nz, ng) by the requested method.

    Equivalent of average_optical_depth_to_g_point
    (average_optical_depth.cpp:21-197) minus the molar-abs conversion (see
    :func:`od_to_molar_abs`).  The per-g OpenMP loop becomes one-hot matmul
    segment reductions as matmuls; g-point membership may be arbitrary
    (non-contiguous in wavenumber space).

    Args:
      ng: static number of g-points.
      g_point: (nwav,) int map wavenumber -> g-point (<0 = unassigned).
      optical_depth: (nz, nwav).
      weight: (nz, nwav) Planck weights (LW) or broadcastable SSI (SW).
      averaging_method: linear/transmission[-2,-3,-10]/square-root/
        logarithmic/hybrid-logarithmic-transmission-3.
      pressure_fl: (nz,) full-level pressure, required for the hybrid method.

    Returns:
      (od_fit, min_od, max_od), each (nz, ng).
    """
    od = jnp.asarray(optical_depth)
    nz, nwav = od.shape
    w = jnp.broadcast_to(jnp.asarray(weight), od.shape)
    gp = jnp.asarray(g_point)

    # Segment sums as chunked one-hot matmuls: the one-hot membership block
    # is materialized only per chunk (chunk x ng), so memory stays bounded
    # for multi-million-point spectra.
    chunk = min(nwav, 65536)
    nchunk = -(-nwav // chunk)
    pad = nchunk * chunk - nwav
    gp_p = jnp.pad(gp, (0, pad), constant_values=-1).reshape(nchunk, chunk)
    g_range = jnp.arange(ng)

    def seg_sum(v):
        v_p = jnp.pad(v, ((0, 0), (0, pad))).reshape(nz, nchunk, chunk)

        def body(carry, xs):
            v_c, gp_c = xs
            onehot = (gp_c[:, None] == g_range[None, :]).astype(od.dtype)
            # _member_dot: exact-0/1 membership matmul at full precision
            # (a TF32 dot would round the data operand to ~2^-11)
            return carry + _member_dot(v_c, onehot), None

        init = jnp.zeros((nz, ng), od.dtype)
        out, _ = jax.lax.scan(body, init,
                              (jnp.moveaxis(v_p, 1, 0), gp_p))
        return out

    w_sum = seg_sum(w)
    safe_w_sum = jnp.where(w_sum > 0.0, w_sum, 1.0)

    def mean_of(v):
        return seg_sum(v * w) / safe_w_sum

    def trans_fit(scale):
        mean = jnp.minimum(
            _trans_clamp(od.dtype),
            mean_of(-jnp.expm1(-od * (LW_DIFFUSIVITY * scale))))
        return jnp.abs(-jnp.log1p(-mean) / (LW_DIFFUSIVITY * scale))

    def log_fit():
        nonzero = od > 0.0
        log_od = jnp.where(nonzero, jnp.log(jnp.where(nonzero, od, 1.0)), 0.0)
        sum_log = seg_sum(log_od * w * nonzero)
        sum_w_nz = seg_sum(w * nonzero)
        count_nz = seg_sum(nonzero.astype(od.dtype))
        count_all = seg_sum(jnp.ones_like(od))
        all_nz = count_nz >= count_all
        none_nz = count_nz <= 0.0
        denom = jnp.where(none_nz, 1.0, jnp.where(all_nz, safe_w_sum, sum_w_nz))
        fit = jnp.exp(sum_log / denom)
        fit = jnp.where(all_nz, fit, fit * count_nz / jnp.maximum(count_all, 1.0))
        return jnp.where(none_nz, 0.0, fit)

    if averaging_method == "linear":
        fit = mean_of(od)
    elif averaging_method in _METHOD_SCALE:
        fit = trans_fit(_METHOD_SCALE[averaging_method])
    elif averaging_method == "square-root":
        fit = mean_of(jnp.sqrt(od))
        fit = fit * fit
    elif averaging_method == "logarithmic":
        fit = log_fit()
    elif averaging_method == "hybrid-logarithmic-transmission-3":
        if pressure_fl is None:
            raise ValueError("hybrid method requires pressure_fl")
        use_log = (jnp.asarray(pressure_fl) > 100.0e2)[:, None]
        fit = jnp.where(use_log, log_fit(), trans_fit(3.0))
    else:
        raise ValueError(f"averaging_method {averaging_method!r} not understood")

    # Per-(layer, g) min/max od over member wavenumbers: flattened segment
    # reductions, O(nz*nwav) memory
    valid = gp >= 0
    seg_ids = jnp.where(valid, gp, ng)[None, :] + ng * jnp.arange(nz)[:, None]
    seg_ids = jnp.where(valid[None, :], seg_ids, nz * ng).ravel()
    nseg_total = nz * ng + 1
    min_od = jax.ops.segment_min(od.ravel(), seg_ids,
                                 num_segments=nseg_total)[:-1].reshape(nz, ng)
    max_od = jax.ops.segment_max(od.ravel(), seg_ids,
                                 num_segments=nseg_total)[:-1].reshape(nz, ng)
    count = seg_sum(jnp.ones_like(od))
    empty = count[0] <= 0.0                                 # (ng,)
    min_od = jnp.where(empty[None, :] | ~jnp.isfinite(min_od), 0.0, min_od)
    max_od = jnp.where(empty[None, :] | ~jnp.isfinite(max_od), 0.0, max_od)
    fit = jnp.where(empty[None, :], 0.0, fit)

    # Clamp fit into [min, max]; widen degenerate bounds
    # (ref average_optical_depth.cpp:139-163)
    fit = jnp.maximum(min_od, jnp.minimum(fit, max_od))
    degenerate = (min_od > 0.0) & (min_od >= max_od)
    min_od = jnp.where(degenerate, min_od * 0.99, min_od)
    max_od = jnp.where(degenerate, max_od * 1.01, max_od)
    return fit, min_od, max_od


# ---------------------------------------------------------------------------
# Partial-sum (block/shard) form of g-point averaging
# ---------------------------------------------------------------------------

#: Every method average_optical_depth_to_g_point supports
#: (average_optical_depth.cpp:120-197), all expressible as accumulated
#: weighted sums plus a final host-side transform.
GPOINT_AVERAGING_METHODS = (
    "linear", "transmission", "transmission-2", "transmission-3",
    "transmission-10", "square-root", "logarithmic",
    "hybrid-logarithmic-transmission-3")


def gpoint_block_partials(ng, g_point, od, weight, averaging_method):
    """Partial sums for one wavenumber block or mesh shard.

    Every g-point averaging reduction decomposes into weighted sums
    accumulated over wavenumber blocks (streamed from disk,
    :mod:`ecckd_tpu.ops.streaming`) or mesh shards (psum'd over the
    spectral axis, :mod:`ecckd_tpu.parallel.sharded_average`) plus a final
    transform (:func:`finalize_gpoint_partials`).  Sum keys combine with
    ``+``/``psum``; ``min``/``max`` combine with elementwise
    minimum/maximum (``pmin``/``pmax``).

    The logarithmic method (average_optical_depth.cpp:127-141) needs three
    extra accumulators: sum of w*log(od) over od>0, sum of w over od>0,
    and the nonzero count; the hybrid method accumulates both those and
    the transmission-3 numerator so the finalizer can blend per layer.

    Returns a dict of (nz, ng) jnp arrays (traceable inside shard_map).
    """
    od = jnp.asarray(od)
    w = jnp.broadcast_to(jnp.asarray(weight), od.shape)
    gp = jnp.asarray(g_point, jnp.int32)
    nz = od.shape[0]
    onehot = (gp[:, None] == jnp.arange(ng)[None, :]).astype(od.dtype)

    def seg(v):
        # See seg_sum above: full-precision dot against the 0/1 membership
        return _member_dot(v, onehot)

    out = {"w_sum": seg(w), "count": seg(jnp.ones_like(od))}
    method = averaging_method
    hybrid = method == "hybrid-logarithmic-transmission-3"
    if method == "linear":
        out["num"] = seg(od * w)
    elif method in _METHOD_SCALE or hybrid:
        scale = 3.0 if hybrid else _METHOD_SCALE[method]
        out["num"] = seg(-jnp.expm1(-od * (LW_DIFFUSIVITY * scale)) * w)
    elif method == "square-root":
        out["num"] = seg(jnp.sqrt(od) * w)
    elif method != "logarithmic":
        raise ValueError(
            f"averaging_method {method!r} not understood; choose from "
            f"{GPOINT_AVERAGING_METHODS}")
    if method == "logarithmic" or hybrid:
        nonzero = od > 0.0
        log_od = jnp.where(nonzero,
                           jnp.log(jnp.where(nonzero, od, 1.0)), 0.0)
        out["sum_log"] = seg(log_od * w * nonzero)
        out["sum_w_nz"] = seg(w * nonzero)
        out["count_nz"] = seg(nonzero.astype(od.dtype))

    # Per-(layer, g) min/max over member wavenumbers: flattened segment
    # reductions, O(nz*nwav) memory (never a (nz, nwav, ng) broadcast).
    # Empty segments yield the scatter identity (+/-inf), which survives
    # min/max combination across blocks and is masked by the finalizer.
    valid = gp >= 0
    gsafe = jnp.where(valid, gp, 0)
    seg_ids = jnp.where(valid[None, :],
                        gsafe[None, :] + ng * jnp.arange(nz)[:, None],
                        nz * ng).ravel()
    nseg_total = nz * ng + 1
    out["min"] = jax.ops.segment_min(
        od.ravel(), seg_ids, num_segments=nseg_total)[:-1].reshape(nz, ng)
    out["max"] = jax.ops.segment_max(
        od.ravel(), seg_ids, num_segments=nseg_total)[:-1].reshape(nz, ng)
    return out


def finalize_gpoint_partials(acc, averaging_method, pressure_fl=None):
    """(od_fit, min_od, max_od) from fully combined partial sums.

    Host-side numpy: the output is tiny ((nz, ng)) and this runs once per
    gas, after the streamed/psum'd accumulation.  Semantics identical to
    :func:`average_od_to_gpoints` (average_optical_depth.cpp:120-197
    incl. the clamp-to-bounds and degenerate-bound widening at :139-163).
    """
    acc = {k: np.asarray(v) for k, v in acc.items()}
    w_sum = acc["w_sum"]
    safe = np.where(w_sum > 0.0, w_sum, 1.0)
    method = averaging_method

    def trans_fit(scale):
        mean = np.minimum(_trans_clamp(acc["num"].dtype),
                          acc["num"] / safe)
        return np.abs(-np.log1p(-mean) / (LW_DIFFUSIVITY * scale))

    def log_fit():
        count_nz, count_all = acc["count_nz"], acc["count"]
        all_nz = count_nz >= count_all
        none_nz = count_nz <= 0.0
        denom = np.where(none_nz, 1.0,
                         np.where(all_nz, safe, acc["sum_w_nz"]))
        with np.errstate(over="ignore"):
            fit = np.exp(acc["sum_log"] / denom)
        fit = np.where(all_nz, fit,
                       fit * count_nz / np.maximum(count_all, 1.0))
        return np.where(none_nz, 0.0, fit)

    if method == "linear":
        fit = acc["num"] / safe
    elif method in _METHOD_SCALE:
        fit = trans_fit(_METHOD_SCALE[method])
    elif method == "square-root":
        mean = acc["num"] / safe
        fit = mean * mean
    elif method == "logarithmic":
        fit = log_fit()
    elif method == "hybrid-logarithmic-transmission-3":
        if pressure_fl is None:
            raise ValueError("hybrid method requires pressure_fl")
        use_log = (np.asarray(pressure_fl) > 100.0e2)[:, None]
        fit = np.where(use_log, log_fit(), trans_fit(3.0))
    else:
        raise ValueError(
            f"averaging_method {method!r} not understood; choose from "
            f"{GPOINT_AVERAGING_METHODS}")

    empty = acc["count"][0] <= 0.0
    min_od = np.where(empty[None, :] | ~np.isfinite(acc["min"]), 0.0,
                      acc["min"])
    max_od = np.where(empty[None, :] | ~np.isfinite(acc["max"]), 0.0,
                      acc["max"])
    fit = np.where(empty[None, :], 0.0, fit)
    fit = np.maximum(min_od, np.minimum(fit, max_od))
    degenerate = (min_od > 0.0) & (min_od >= max_od)
    min_od = np.where(degenerate, min_od * 0.99, min_od)
    max_od = np.where(degenerate, max_od * 1.01, max_od)
    return fit, min_od, max_od


def od_to_molar_abs(od_fit, pressure_hl, reference_surface_vmr):
    """Convert per-layer od to molar absorption coefficient (m2 mol-1).

    Ref average_optical_depth.cpp:168-187: k = (g * 0.001 * M_air / vmr) *
    od / dp.  With reference_surface_vmr <= 0, returns od unchanged (mean od
    mode).
    """
    if reference_surface_vmr is None or reference_surface_vmr <= 0.0:
        return od_fit
    dp = (pressure_hl[1:] - pressure_hl[:-1])[:, None]
    return ((ACCEL_GRAVITY * 0.001 * MOLAR_MASS_DRY_AIR)
            / reference_surface_vmr) * od_fit / dp
