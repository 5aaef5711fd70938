"""Batched candidate-interval cost kernels for g-point search.

Data-parallel replacement for ``CkdEquipartition::calc_error``
(find_g_points.cpp:206-426): one jitted kernel evaluates the heating-rate/
flux cost of MANY candidate rank intervals at once.  Per sweep the work is
O(nwav x nlay) regardless of the number of intervals — the per-wavenumber
flux recurrence is computed once, with each wavenumber carrying the grey
fitted od of its own interval, and prefix-sum interval reductions extracting
per-candidate broadband fluxes (see ops.rt_lw.rt_lw_bb_intervals).

This replaces OpenMP parallelism P1 (equipartition.h:100-104) with data
parallelism over the wavenumber axis, the framework's scaling dimension.

Multi-chip: pass ``mesh`` (a jax.sharding.Mesh with a named spectral axis)
to shard the band's wavenumber axis over the mesh.  Per-wavenumber
recurrences are independent, so every shard runs the fused sweep and
interval reductions on its local slice with rank-shifted interval bounds,
and only the tiny (rows, nseg) interval sums and (nlev+1, nseg) flux
partials cross devices via ``psum`` — two allreduces per sweep, O(nlay * nseg)
bytes each.  The fit ``finish`` and the scalar cost run replicated on the
psum'd results.  This is the multi-chip form of the reference's hottest
loop (find_g_points.cpp:291-330), which OpenMP limits to one node.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import HR_WEIGHT
from ..ops.average import (fit_parts_lw, fit_parts_sw, total_trans_fit_parts)
from ..ops.heating_rate import heating_rate
from ..ops.rt_lw import rt_lw_bb_intervals
from ..ops.rt_sw import rt_sw_bb_intervals
from ..ops.segments import (build_prefix_sums, interval_sum_from_prefix,
                            interval_sum_fused, part_of)
from ..ops.pallas.sweep_lw import chunks_fit
from ..policy import execution_policy
from .equipartition import Equipartition


def _pad_to_bucket(n: int) -> int:
    """Pad the candidate count to a power of two (1, 2, 4, 8, ...) to bound
    the number of XLA compilations."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _pad_wav(a, pad: int, host: bool = False):
    """Zero-pad the trailing (wavenumber) axis by ``pad`` entries.

    Padded ranks sit ABOVE every interval's global i2 (intervals live in
    [0, npoints)), so membership excludes them from every reduction; the
    flux recurrences on zero operands also produce exactly zero rows, so
    tile-level padding inside the kernels is harmless too.

    ``host=True`` keeps the padded array in host numpy (mesh mode: the
    sharded copies in ``_bound_arrays`` are the working set; a second
    device-resident unsharded copy would double residency for the kernel's
    lifetime).
    """
    if host:
        a = np.asarray(a)
        if pad == 0:
            return a
        width = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
        return np.pad(a, width)
    if pad == 0:
        return jnp.asarray(a)
    a = jnp.asarray(a)
    width = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
    return jnp.pad(a, width)


def _local_bounds(i1, i2, axis, nloc):
    """Shift global inclusive rank bounds into a shard's local index space.

    Membership tests ``i1 <= idx <= i2`` need no clipping: intervals
    entirely outside the shard produce empty membership (and hence exact
    zero partial sums), intervals extending past either edge are clipped
    by the comparison itself.
    """
    offset = jax.lax.axis_index(axis).astype(i1.dtype) * nloc
    return i1 - offset, i2 - offset


def _candidate_cost_from_fluxes(pressure_hl, layer_weight, flux_weight,
                                flux_dn, flux_up, hr_true,
                                fd_surf_true, fu_toa_true):
    """Scalar candidate cost per interval from broadband flux profiles.

    Ref calc_cost_function_lw.cpp:104-110 / calc_cost_function_sw.cpp:110-115:
    sqrt of layer-weighted squared heating-rate error (in K/day) plus
    flux-weighted squared boundary-flux errors.
    """
    hr_fit = heating_rate(pressure_hl, flux_dn, flux_up)
    hr_err = hr_fit - hr_true
    dn_err = flux_dn[-1] - fd_surf_true
    up_err = flux_up[0] - fu_toa_true
    return jnp.sqrt(
        HR_WEIGHT * HR_WEIGHT
        * jnp.sum(layer_weight[:, None] * hr_err * hr_err, axis=0)
        + flux_weight * (dn_err * dn_err + up_err * up_err))


class _CandidateCostBase:
    """Shared jit/shard_map dispatch for the candidate-cost kernels."""

    mesh = None
    mesh_axis = "spectral"
    _wav_pad = 0
    use_prefix = False
    _prefix = None          # (hi, lo) double-float prefix sums, or None
    _bg_index = None        # index of bg_od in _arrays() (bench perturbation)

    def _resolve_prefix(self, use_prefix, mesh, dtype) -> bool:
        """Whether to precompute per-band prefix sums and replace the
        per-sweep interval-sum pass with gathers.

        Default (:mod:`ecckd_tpu.policy`): on for f32 single-device GPU
        execution — the production sweep path, where the fit+truth
        operands never change between the hundreds of probes of a band's
        partition search.  Off for f64/CPU (the determinism-sensitive
        partition path keeps its bit-stable membership reductions) and for
        mesh mode (the prefix arrays would need a cross-shard carry;
        sharded sweeps keep the psum'd partial-sum form).  Override with
        the ``use_prefix`` argument.
        """
        if mesh is not None:
            return False
        if use_prefix is not None:
            return bool(use_prefix)
        return execution_policy().prefix(dtype)

    def chained_bench_fn(self):
        """Jitted ``fn(arrays, i1, i2, n)`` running ``n`` sweep
        evaluations inside ONE dispatch (fori_loop), serialized by a
        genuine data dependency on the carry: the interval bounds get a
        RUNTIME-ZERO offset derived from the carry (``acc * 1e-45``
        underflows to integer 0 at runtime but is not foldable), so every
        stage — fit reductions/gathers, the sweep kernel, the cost — is
        data-dependent on the previous iteration and nothing can be
        constant-folded or hoisted out of the loop.  Earlier forms also
        perturbed a full-size operand additively; that COPIED the
        (nlay, nwav) array every iteration (~800 MB/iter of pure harness
        traffic at 2^21 — half of the r4 LW headline's time and more than
        the SW sweep's own reads), so the measured number understated the
        kernel.  Keeps host dispatch latency out of benchmark
        measurements (bench.py)."""

        def chained(arrays, i1, i2, n):
            def body(_, acc):
                # Runtime-zero int offset: not foldable, value unchanged
                iz = (acc * jnp.asarray(1e-45, acc.dtype)).astype(jnp.int32)
                out = self._kernel(arrays, i1 + iz, i2 + iz)
                dep = jnp.sum(out) * jnp.asarray(1e-30, out.dtype)
                return acc + dep.astype(acc.dtype)   # carry stays f32

            return jax.lax.fori_loop(0, n, body,
                                     jnp.asarray(0.0, jnp.float32))

        return jax.jit(chained)

    def _setup_mesh(self, mesh, mesh_axis: str, nwav: int) -> int:
        """Record the mesh and return the padded wavenumber count."""
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self._wav_pad = 0
        if mesh is None:
            return nwav
        nshard = mesh.shape[mesh_axis]
        self._wav_pad = (-nwav) % nshard
        return nwav + self._wav_pad

    def _shard_arrays(self):
        """Commit the bound arrays to their mesh shardings (one transfer at
        construction instead of one per sweep).

        Multi-controller (jax.distributed): every process holds the full
        band (each host reads the same files) and contributes only the
        contiguous wavenumber slice owned by its devices via
        ``make_array_from_process_local_data`` — no cross-host data
        movement; the mesh's device order is process-major so each
        process's shards are a contiguous slice of the padded axis.
        """
        from jax.sharding import NamedSharding, PartitionSpec as P
        specs = self._array_specs(P, self.mesh_axis)
        nproc = jax.process_count()
        pid = jax.process_index()
        axis = self.mesh_axis

        if nproc > 1 and self.mesh.shape[axis] != jax.device_count():
            raise ValueError(
                "multi-controller sharded sweeps need the spectral mesh "
                "axis to span ALL devices (data_parallel=1), so each "
                "process's shards are a contiguous exclusive wavenumber "
                f"slice; got spectral={self.mesh.shape[axis]} of "
                f"{jax.device_count()} devices")

        def put(a, s):
            if a is None or np.isscalar(a):
                return a
            sh = NamedSharding(self.mesh, s)
            if nproc == 1:
                return jax.device_put(a, sh)
            a = np.asarray(a)
            if axis in jax.tree.leaves(tuple(s)):
                n = a.shape[-1]
                per = n // nproc
                local = a[..., pid * per:(pid + 1) * per]
            else:
                local = a
            return jax.make_array_from_process_local_data(sh, local,
                                                          a.shape)

        return jax.tree.map(put, self._arrays(), specs,
                            is_leaf=lambda x: x is None)

    def _make_jitted(self):
        if self.mesh is None:
            return jax.jit(self._kernel)
        from jax.sharding import PartitionSpec as P
        axis = self.mesh_axis
        body = functools.partial(self._kernel, axis=axis)
        kwargs = dict(mesh=self.mesh,
                      in_specs=(self._array_specs(P, axis), P(), P()),
                      out_specs=P())
        if self.use_pallas:
            # pallas_call inside shard_map cannot express per-output
            # varying-axis metadata for every interpreter path (literals
            # are not auto-pvaried), so drop the replication checker; the
            # XLA path keeps it as a sharding-correctness guard.
            kwargs["check_vma"] = False
        sm = jax.shard_map(body, **kwargs)
        return jax.jit(sm)

    def _device_seg_of_wav(self, i1, nloc, axis):
        """Per-rank partition map computed ON DEVICE from the (sorted,
        front-padded) interval lower bounds: the last interval with
        i1 <= rank carries each rank's fitted od (the device form of
        CkdEquipartition._seg_of_wav), so a probe call ships only the
        O(nseg) bounds to the device, not an O(npoints) map."""
        ranks = jnp.arange(nloc, dtype=jnp.int32)
        if axis is not None:
            ranks = ranks + jax.lax.axis_index(axis).astype(jnp.int32) \
                * nloc
        return jnp.maximum(
            0, jnp.searchsorted(i1, ranks, side="right").astype(jnp.int32)
            - 1)

    def costs(self, i1: np.ndarray, i2: np.ndarray,
              seg_of_wav=None) -> np.ndarray:
        """Candidate costs for sorted, non-overlapping intervals.

        ``seg_of_wav`` is accepted for backward compatibility and
        ignored: the partition map is derived on device from ``i1``
        (identical by construction to CkdEquipartition._seg_of_wav).
        Bucket padding goes at the FRONT with [0, 0] intervals so the
        padded bounds stay sorted for the in-kernel searchsorted; padded
        columns are benign (single-point interval 0) and sliced off.
        """
        n = len(i1)
        nb = _pad_to_bucket(n)
        if nb not in self._jitted:
            self._jitted[nb] = self._make_jitted()
        pad = nb - n
        i1p = np.zeros(nb, np.int32); i1p[pad:] = i1
        i2p = np.zeros(nb, np.int32); i2p[pad:] = i2
        if self.use_pallas and not chunks_fit(i1p, i2p, self.npoints):
            raise ValueError("the fused sweep kernel takes intervals that "
                             "overlap in at most one rank each")
        out = self._jitted[nb](self._bound_arrays, jnp.asarray(i1p),
                               jnp.asarray(i2p))
        if jax.process_count() > 1:
            # out_specs=P() -> replicated; every process reads its copy
            out = jax.device_get(out.addressable_data(0))
        return np.asarray(out)[pad:].astype(np.float64)


class CandidateCostLw(_CandidateCostBase):
    """LW candidate cost over a band of rank-ordered wavenumbers.

    Arrays are bound once (device-resident; mesh-sharded over the
    wavenumber axis when ``mesh`` is given); :meth:`costs` evaluates a
    batch of intervals.  Mirrors CkdEquipartition::init_lw
    (find_g_points.cpp:209-238).
    """

    _bg_index = 7

    def __init__(self, averaging_method: str, flux_weight: float,
                 layer_weight, pressure_hl, surf_emissivity, surf_planck,
                 flux_dn_surf, flux_up_toa, planck_hl, bg_od, metric, hr,
                 use_pallas: Optional[bool] = None,
                 pallas_interpret: bool = False,
                 use_prefix: Optional[bool] = None,
                 mesh=None, mesh_axis: str = "spectral"):
        import jax
        self.averaging_method = averaging_method
        self.flux_weight = float(flux_weight)
        # Fused sweep kernel: default from the execution policy (f32 GPU)
        if use_pallas is None:
            use_pallas = execution_policy().sweep_kernel(
                jnp.asarray(metric).dtype)
        self.use_pallas = bool(use_pallas)
        self.pallas_interpret = bool(pallas_interpret)
        self.npoints = int(np.shape(metric)[1])
        self._setup_mesh(mesh, mesh_axis, self.npoints)
        pad = self._wav_pad
        host = mesh is not None
        self.layer_weight = jnp.asarray(layer_weight)
        self.pressure_hl = jnp.asarray(pressure_hl)
        self.surf_emissivity = _pad_wav(surf_emissivity, pad, host)
        self.surf_planck = _pad_wav(surf_planck, pad, host)
        self.flux_dn_surf = _pad_wav(flux_dn_surf, pad, host)
        self.flux_up_toa = _pad_wav(flux_up_toa, pad, host)
        self.planck_hl = _pad_wav(planck_hl, pad, host)
        self.bg_od = _pad_wav(bg_od, pad, host)
        self.metric = _pad_wav(metric, pad, host)
        self.hr = _pad_wav(hr, pad, host)
        self._jitted: Dict[int, object] = {}
        self.use_prefix = self._resolve_prefix(use_prefix, mesh,
                                               self.metric.dtype)
        if self.use_prefix:
            # Once-per-band double-float prefix sums over every fit and
            # truth operand row: each sweep's interval-sum pass becomes a
            # pair of gathers (ops.segments.interval_sum_from_prefix) —
            # the O(rows * nwav) reduction is amortized over ALL probes of
            # the band's partition search instead of paid per sweep.
            parts, rows, finish = fit_parts_lw(self.averaging_method,
                                               self.planck_hl, self.metric)
            self._fit_rows = rows
            self._fit_finish = finish
            self._prefix = build_prefix_sums(
                parts + [part_of(self.hr), part_of(self.flux_dn_surf),
                         part_of(self.flux_up_toa)], self.npoints)
        self._bound_arrays = (self._shard_arrays() if mesh is not None
                              else self._arrays())

    def _arrays(self):
        """Array operands passed as jit ARGUMENTS (never closures, which XLA
        would constant-fold — prohibitively slow for big spectra)."""
        base = (self.layer_weight, self.pressure_hl, self.surf_emissivity,
                self.surf_planck, self.flux_dn_surf, self.flux_up_toa,
                self.planck_hl, self.bg_od, self.metric, self.hr)
        return base + self._prefix if self._prefix is not None else base

    def _array_specs(self, P, axis):
        return (P(), P(), P(axis), P(axis), P(axis), P(axis),
                P(None, axis), P(None, axis), P(None, axis), P(None, axis))

    def _kernel(self, arrays, i1, i2, axis=None):
        (layer_weight, pressure_hl, surf_emissivity, surf_planck,
         flux_dn_surf, flux_up_toa, planck_hl, bg_od, metric, hr) = \
            arrays[:10]
        nlay = hr.shape[0]
        nloc = metric.shape[-1]
        seg_of_wav = self._device_seg_of_wav(i1, nloc, axis)
        if axis is None:
            i1_l, i2_l = i1, i2
            allred = lambda x: x
        else:
            i1_l, i2_l = _local_bounds(i1, i2, axis, nloc)
            allred = lambda x: jax.lax.psum(x, axis)
        if self.use_prefix:
            # Fast path: every fit/truth interval sum is a gather into the
            # once-per-band double-float prefix arrays — no spectral pass.
            cum_hi, cum_lo = arrays[10], arrays[11]
            sums = interval_sum_from_prefix(cum_hi, cum_lo, i1, i2)
            rows, finish = self._fit_rows, self._fit_finish
        else:
            # Fit operands and truth reductions share ONE pass over the
            # spectrum: each fused-reduction tile reads its operand block
            # once and reduces everything against the same membership
            # matmul.
            parts, rows, finish = fit_parts_lw(self.averaging_method,
                                               planck_hl, metric)
            sums = allred(interval_sum_fused(
                parts + [part_of(hr), part_of(flux_dn_surf),
                         part_of(flux_up_toa)],
                nloc, i1_l, i2_l, dtype=metric.dtype))
        # ``finish`` consumes globally reduced sums with GLOBAL bounds (the
        # logarithmic method derives interval lengths from i2 - i1 + 1).
        od_fit = finish(sums[:rows], i1, i2)
        hr_true = sums[rows:rows + nlay]
        fd_surf_true = sums[rows + nlay]
        fu_toa_true = sums[rows + nlay + 1]
        if self.use_pallas:
            from ..ops.pallas.sweep_lw import rt_lw_bb_intervals_pallas
            flux_dn, flux_up = rt_lw_bb_intervals_pallas(
                planck_hl, bg_od, od_fit, seg_of_wav, surf_emissivity,
                surf_planck, i1_l, i2_l, interpret=self.pallas_interpret)
        else:
            grey = jnp.take(od_fit, seg_of_wav, axis=1)
            flux_dn, flux_up = rt_lw_bb_intervals(
                planck_hl, bg_od, grey, surf_emissivity, surf_planck,
                i1_l, i2_l)
        return _candidate_cost_from_fluxes(
            pressure_hl, layer_weight, self.flux_weight,
            allred(flux_dn), allred(flux_up), hr_true, fd_surf_true,
            fu_toa_true)


class CandidateCostSw(_CandidateCostBase):
    """SW candidate cost (ref CkdEquipartition::init_sw / init_sw_extras,
    find_g_points.cpp:240-296), including the total-transmission method that
    averages the cost of low- and high-scaled optical depths
    (find_g_points.cpp:340-394)."""

    _bg_index = 5

    def __init__(self, averaging_method: str, flux_weight: float,
                 layer_weight, cos_sza, pressure_hl, ssi, surf_albedo,
                 flux_dn_surf, flux_up_toa, bg_od, metric, hr,
                 extras: Optional[dict] = None,
                 use_pallas: Optional[bool] = None,
                 pallas_interpret: bool = False,
                 use_prefix: Optional[bool] = None,
                 mesh=None, mesh_axis: str = "spectral"):
        import jax
        self.averaging_method = averaging_method
        self.flux_weight = float(flux_weight)
        # Fused sweep kernel: default from the execution policy (f32 GPU)
        if use_pallas is None:
            use_pallas = execution_policy().sweep_kernel(
                jnp.asarray(metric).dtype)
        self.use_pallas = bool(use_pallas)
        self.pallas_interpret = bool(pallas_interpret)
        self.npoints = int(np.shape(metric)[1])
        self._setup_mesh(mesh, mesh_axis, self.npoints)
        pad = self._wav_pad
        host = mesh is not None
        self.layer_weight = jnp.asarray(layer_weight)
        self.cos_sza = float(cos_sza)
        self.pressure_hl = jnp.asarray(pressure_hl)
        self.ssi = _pad_wav(ssi, pad, host)
        # Scalar (per-band, ref find_g_points.cpp:415-417) or per-
        # wavenumber albedo (gas-level kernels spanning bands with
        # different no-Rayleigh albedos); bound as a vector either way.
        alb = np.broadcast_to(np.asarray(surf_albedo, np.asarray(ssi).dtype),
                              (self.npoints,))
        self.with_upwelling = bool(np.any(alb > 0.0))
        self.surf_albedo = (float(surf_albedo)
                            if np.isscalar(surf_albedo)
                            or np.ndim(surf_albedo) == 0 else None)
        self.surf_albedo_wav = _pad_wav(alb, pad, host)
        self.flux_dn_surf = _pad_wav(flux_dn_surf, pad, host)
        self.flux_up_toa = _pad_wav(flux_up_toa, pad, host)
        self.bg_od = _pad_wav(bg_od, pad, host)
        self.metric = _pad_wav(metric, pad, host)
        self.hr = _pad_wav(hr, pad, host)
        self.extras = None
        if extras is not None:
            self.extras = {k: (_pad_wav(v, pad, host)
                               if not np.isscalar(v) else float(v))
                           for k, v in extras.items()}
        self._jitted: Dict[int, object] = {}
        self.use_prefix = self._resolve_prefix(use_prefix, mesh,
                                               jnp.asarray(metric).dtype)
        if self.use_prefix:
            # See CandidateCostLw: per-band prefix sums over fit + truth
            # operand rows (for total-transmission, the low/high-scaled
            # truth extras are included so both scaled costs' reductions
            # are gathers too — ref find_g_points.cpp:340-394).
            truth_of = lambda h, fd, fu: [part_of(h), part_of(fd),
                                          part_of(fu)]
            if self.averaging_method == "total-transmission":
                ex = self.extras
                parts, rows, finish = total_trans_fit_parts(
                    self.ssi, self.bg_od, self.metric)
                all_parts = (parts
                             + truth_of(ex["hr_low"],
                                        ex["flux_dn_surf_low"],
                                        ex["flux_up_toa_low"])
                             + truth_of(ex["hr_high"],
                                        ex["flux_dn_surf_high"],
                                        ex["flux_up_toa_high"]))
            else:
                parts, rows, finish = fit_parts_sw(
                    self.averaging_method, self.ssi, self.metric)
                all_parts = parts + truth_of(self.hr, self.flux_dn_surf,
                                             self.flux_up_toa)
            self._fit_rows = rows
            self._fit_finish = finish
            self._prefix = build_prefix_sums(all_parts, self.npoints)
        self._bound_arrays = (self._shard_arrays() if mesh is not None
                              else self._arrays())

    def _arrays(self):
        """Array operands passed as jit ARGUMENTS, not closures (closures
        get constant-folded by XLA at compile time)."""
        base = (self.layer_weight, self.pressure_hl, self.ssi,
                self.flux_dn_surf, self.flux_up_toa, self.bg_od,
                self.metric, self.hr, self.surf_albedo_wav, self.extras)
        return base + self._prefix if self._prefix is not None else base

    def _array_specs(self, P, axis):
        ex = None
        if self.extras is not None:
            ex = {k: (P() if np.isscalar(v)
                      else P(axis) if v.ndim == 1 else P(None, axis))
                  for k, v in self.extras.items()}
        return (P(), P(), P(axis), P(axis), P(axis),
                P(None, axis), P(None, axis), P(None, axis), P(axis), ex)

    def _cost_with(self, arrs, od_fit, seg_of_wav, i1_l, i2_l,
                   hr_true, fd_surf_true, fu_toa_true, allred,
                   want_components=False):
        (layer_weight, pressure_hl, ssi, _, _, bg_od, _, _,
         albedo) = arrs[:9]
        with_up = self.with_upwelling
        if self.use_pallas:
            from ..ops.pallas.sweep_sw import rt_sw_bb_intervals_pallas
            flux_dn, flux_up = rt_sw_bb_intervals_pallas(
                ssi, bg_od, od_fit, seg_of_wav, i1_l, i2_l,
                cos_sza=self.cos_sza, albedo=albedo,
                with_upwelling=with_up, interpret=self.pallas_interpret)
        else:
            grey = jnp.take(od_fit, seg_of_wav, axis=1)
            flux_dn, flux_up = rt_sw_bb_intervals(
                self.cos_sza, ssi, bg_od, grey,
                albedo, i1_l, i2_l, with_upwelling=with_up)
        flux_dn = allred(flux_dn)
        flux_up = allred(flux_up)
        # SW heating rate uses downwelling only (calc_cost_function_sw.cpp:93)
        hr_fit = heating_rate(pressure_hl, flux_dn)
        hr_err = hr_fit - hr_true
        dn_err = flux_dn[-1] - fd_surf_true
        up_err = flux_up[0] - fu_toa_true
        cost = jnp.sqrt(
            HR_WEIGHT * HR_WEIGHT
            * jnp.sum(layer_weight[:, None] * hr_err * hr_err, axis=0)
            + self.flux_weight * (dn_err * dn_err + up_err * up_err))
        if not want_components:
            return cost
        # The diagnostic pieces calc_cost_function_sw.cpp:93-105 dumps
        # under debug_partition
        comps = dict(
            flux_dn_surf_true=fd_surf_true, flux_dn_surf_fit=flux_dn[-1],
            flux_up_toa_true=fu_toa_true, flux_up_toa_fit=flux_up[0],
            hr_true=hr_true, hr_fit=hr_fit,
            cf_hr=jnp.sqrt(HR_WEIGHT * HR_WEIGHT * jnp.sum(
                layer_weight[:, None] * hr_err * hr_err, axis=0)),
            cf_flux=jnp.sqrt(self.flux_weight
                             * (dn_err * dn_err + up_err * up_err)))
        return cost, comps

    def _kernel(self, arrs, i1, i2, axis=None):
        (_, _, ssi, flux_dn_surf, flux_up_toa, bg_od, metric, hr,
         _albedo, extras) = arrs[:10]
        nloc = metric.shape[-1]
        nlay = hr.shape[0]
        seg_of_wav = self._device_seg_of_wav(i1, nloc, axis)
        if axis is None:
            i1_l, i2_l = i1, i2
            allred = lambda x: x
        else:
            i1_l, i2_l = _local_bounds(i1, i2, axis, nloc)
            allred = lambda x: jax.lax.psum(x, axis)
        truth_of = lambda h, fd, fu: [part_of(h), part_of(fd), part_of(fu)]
        if self.averaging_method == "total-transmission":
            ex = extras
            if self.use_prefix:
                all_sums = interval_sum_from_prefix(arrs[10], arrs[11],
                                                    i1, i2)
                rows = self._fit_rows
                sums_tt = all_sums[:rows]
                sums = all_sums[rows:]
                finish_tt = self._fit_finish
            else:
                parts_tt, _rows_tt, finish_tt = total_trans_fit_parts(
                    ssi, bg_od, metric)
                sums_tt = allred(interval_sum_fused(
                    parts_tt, nloc, i1_l, i2_l, dtype=metric.dtype))
                # Both scaled costs' truth reductions share one pass
                sums = allred(interval_sum_fused(
                    truth_of(ex["hr_low"], ex["flux_dn_surf_low"],
                             ex["flux_up_toa_low"])
                    + truth_of(ex["hr_high"], ex["flux_dn_surf_high"],
                               ex["flux_up_toa_high"]),
                    nloc, i1_l, i2_l, dtype=metric.dtype))
            od_fit = finish_tt(sums_tt, i1, i2)
            lo, hi = sums[:nlay + 2], sums[nlay + 2:]
            cf_low = self._cost_with(
                arrs, od_fit * ex["min_scaling"], seg_of_wav, i1_l, i2_l,
                lo[:nlay], lo[nlay], lo[nlay + 1], allred)
            cf_high = self._cost_with(
                arrs, od_fit * ex["max_scaling"], seg_of_wav, i1_l, i2_l,
                hi[:nlay], hi[nlay], hi[nlay + 1], allred)
            return 0.5 * (cf_low + cf_high)
        if self.use_prefix:
            sums = interval_sum_from_prefix(arrs[10], arrs[11], i1, i2)
            rows, finish = self._fit_rows, self._fit_finish
        else:
            parts, rows, finish = fit_parts_sw(self.averaging_method, ssi,
                                               metric)
            sums = allred(interval_sum_fused(
                parts + truth_of(hr, flux_dn_surf, flux_up_toa),
                nloc, i1_l, i2_l, dtype=metric.dtype))
        od_fit = finish(sums[:rows], i1, i2)
        return self._cost_with(arrs, od_fit, seg_of_wav, i1_l, i2_l,
                               sums[rows:rows + nlay], sums[rows + nlay],
                               sums[rows + nlay + 1], allred)

    def _components_kernel(self, arrs, i1, i2, seg_of_wav):
        """Per-interval diagnostic cost components (single-device path).

        The quantities calc_cost_function_sw.cpp:93-105 dumps under
        ``debug_partition``; for total-transmission the reference
        evaluates LOW/HIGH (the scaled runs entering the cost) and MID
        (the unscaled fit against the main truth, find_g_points.cpp:
        346-375) — all three are returned."""
        (_, _, ssi, flux_dn_surf, flux_up_toa, bg_od, metric, hr,
         _albedo, extras) = arrs[:10]
        nloc = metric.shape[-1]
        nlay = hr.shape[0]
        ident = lambda x: x
        truth_of = lambda h, fd, fu: [part_of(h), part_of(fd), part_of(fu)]
        if self.averaging_method == "total-transmission":
            ex = extras
            parts_tt, _rows_tt, finish_tt = total_trans_fit_parts(
                ssi, bg_od, metric)
            sums_tt = interval_sum_fused(
                parts_tt, nloc, i1, i2, dtype=metric.dtype)
            od_fit = finish_tt(sums_tt, i1, i2)
            sums = interval_sum_fused(
                truth_of(ex["hr_low"], ex["flux_dn_surf_low"],
                         ex["flux_up_toa_low"])
                + truth_of(ex["hr_high"], ex["flux_dn_surf_high"],
                           ex["flux_up_toa_high"])
                + truth_of(hr, flux_dn_surf, flux_up_toa),
                nloc, i1, i2, dtype=metric.dtype)
            lo = sums[:nlay + 2]
            hi = sums[nlay + 2:2 * nlay + 4]
            mid = sums[2 * nlay + 4:]
            out = {}
            for tag, scale, t in (("LOW", ex["min_scaling"], lo),
                                  ("HIGH", ex["max_scaling"], hi),
                                  ("MID", 1.0, mid)):
                _, out[tag] = self._cost_with(
                    arrs, od_fit * scale, seg_of_wav, i1, i2,
                    t[:nlay], t[nlay], t[nlay + 1], ident,
                    want_components=True)
            return out
        parts, rows, finish = fit_parts_sw(self.averaging_method, ssi,
                                           metric)
        sums = interval_sum_fused(
            parts + truth_of(hr, flux_dn_surf, flux_up_toa),
            nloc, i1, i2, dtype=metric.dtype)
        od_fit = finish(sums[:rows], i1, i2)
        _, comps = self._cost_with(
            arrs, od_fit, seg_of_wav, i1, i2, sums[rows:rows + nlay],
            sums[rows + nlay], sums[rows + nlay + 1], ident,
            want_components=True)
        return {"MID": comps}

    def components(self, i1: np.ndarray, i2: np.ndarray,
                   seg_of_wav: np.ndarray):
        """Per-interval diagnostic components for ``debug_partition``
        (host numpy; evaluated single-device regardless of mesh — this is
        a diagnostic path run once per band)."""
        if not hasattr(self, "_components_jit"):
            self._components_jit = jax.jit(self._components_kernel)
        seg = np.minimum(seg_of_wav, len(i1) - 1).astype(np.int32)
        if self._wav_pad:
            seg = np.concatenate([seg, np.zeros(self._wav_pad, np.int32)])
        out = self._components_jit(self._arrays(),
                                   jnp.asarray(np.asarray(i1, np.int32)),
                                   jnp.asarray(np.asarray(i2, np.int32)),
                                   jnp.asarray(seg))
        return jax.tree.map(np.asarray, jax.device_get(out))


class CkdEquipartition(Equipartition):
    """Equipartition driver bound to a candidate-cost kernel.

    Index mapping follows the reference exactly: a bound b in [0, 1] maps to
    lower index ceil(b*(n-1)) / upper index floor(b*(n-1))
    (find_g_points.cpp:282-287).
    """

    def __init__(self, kernel):
        super().__init__()
        self.kernel = kernel
        self.npoints = kernel.npoints
        self.total_comp_cost = 0.0
        self.set_resolution(1.0 / self.npoints)

    def lower_index(self, bound: float) -> int:
        return int(np.ceil(bound * (self.npoints - 1)))

    def upper_index(self, bound: float) -> int:
        return int(np.floor(bound * (self.npoints - 1)))

    def _indices(self, pairs: Sequence[Tuple[float, float]]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        i1 = np.empty(len(pairs), np.int32)
        i2 = np.empty(len(pairs), np.int32)
        for k, (b1, b2) in enumerate(pairs):
            if b2 < b1:
                raise ValueError(f"Bounds out of order: {b1}-{b2}")
            j1 = self.lower_index(b1)
            j2 = self.upper_index(b2)
            if j1 < 0 or j2 >= self.npoints:
                raise ValueError(
                    f"Bounds {b1}-{b2} -> indices {j1}-{j2} outside 0-"
                    f"{self.npoints - 1}")
            if j2 < j1:
                j2 = j1   # bounds extremely close (ref :312-315)
            i1[k], i2[k] = j1, j2
            self.total_comp_cost += b2 - b1
        return i1, i2

    def _seg_of_wav(self, i1: np.ndarray) -> np.ndarray:
        """Map each rank to the interval whose fit od it carries.

        Assigns rank r to the last interval with i1 <= r.  Each wavenumber
        can carry only ONE interval's fitted od per kernel evaluation, so
        this is correct exactly when the (sorted) intervals do not overlap
        — within each interval's own [i1, i2] range the assignment is then
        its own index (gaps between intervals are attributed to the
        preceding interval but never summed into it).  Overlapping batches
        are split into non-overlapping groups by :meth:`calc_error_many`.
        """
        ranks = np.arange(self.npoints)
        return np.maximum(
            0, np.searchsorted(i1, ranks, side="right") - 1).astype(np.int32)

    def calc_error_many(self, bounds_pairs):
        i1, i2 = self._indices(bounds_pairs)
        order = np.argsort(i1, kind="stable")
        i1s, i2s = i1[order], i2[order]

        # Greedily split the sorted probes into non-overlapping groups;
        # a partition sweep (the hot path) is one group = one kernel call.
        group_of = np.empty(len(i1s), np.int64)
        group_end: list = []   # last i2 of each group so far
        for k in range(len(i1s)):
            for g, end in enumerate(group_end):
                if i1s[k] > end:
                    group_of[k] = g
                    group_end[g] = i2s[k]
                    break
            else:
                group_of[k] = len(group_end)
                group_end.append(i2s[k])

        out = np.empty(len(i1s))
        for g in range(len(group_end)):
            sel = np.nonzero(group_of == g)[0]
            # The partition map (which interval's fit each rank carries)
            # is derived on device from i1 inside the kernel.
            out[sel] = self.kernel.costs(i1s[sel], i2s[sel])

        inv = np.argsort(order, kind="stable")
        return out[inv]

    def calc_error(self, bound1: float, bound2: float) -> float:
        return float(self.calc_error_many([(bound1, bound2)])[0])
