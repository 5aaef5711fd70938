"""Wavenumber-sharded g-point averaging over a device mesh.

The multi-chip form of ops.average.average_od_to_gpoints (SURVEY.md §5
"long-context" mapping): the wavenumber axis — the reference's analogue of
sequence length, up to ~5.6M points — is sharded over the mesh's spectral
axis; every device reduces its local shard into per-g-point weighted
partial sums with one-hot matmuls, and the partials are combined with
``psum``/``pmin``/``pmax`` collectives.  The layer axis (~50) and
the tiny (nz, ng) outputs stay replicated.  All 8 averaging methods of
average_optical_depth.cpp:120-197 are supported — the per-shard partials
are shared with the single-host streaming path (ops.streaming), which this
is the psum-reduced equivalent of.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.average import (GPOINT_AVERAGING_METHODS, gpoint_block_partials,
                           finalize_gpoint_partials)

SUPPORTED_METHODS = GPOINT_AVERAGING_METHODS


def _check_method(averaging_method: str):
    if averaging_method not in SUPPORTED_METHODS:
        raise ValueError(
            f"sharded averaging does not support {averaging_method!r}; "
            f"choose from {SUPPORTED_METHODS}")


def _sharded_block_partials(mesh, ng: int, g_point, optical_depth, weight,
                            averaging_method: str, axis: str):
    """Mesh-reduced per-g-point partial sums of one wavenumber block.

    Shards the block's wavenumber axis over the mesh's ``axis``, reduces
    each shard with one-hot matmuls (ops.average.gpoint_block_partials)
    and combines shard partials with psum/pmin/pmax.  Returns the
    replicated partials dict as host numpy arrays — the same quantities
    ops.streaming accumulates across blocks, so streaming and mesh
    sharding COMPOSE: stream blocks from disk, reduce each on the mesh,
    combine on host (see streaming_sharded_average_od_to_gpoints).
    """
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    od = jnp.asarray(optical_depth)
    w = jnp.broadcast_to(jnp.asarray(weight), od.shape)
    gp = jnp.asarray(g_point, jnp.int32)

    nshard = mesh.shape[axis]
    pad = (-od.shape[1]) % nshard
    if pad:
        od = jnp.pad(od, ((0, 0), (0, pad)))
        w = jnp.pad(w, ((0, 0), (0, pad)))
        gp = jnp.pad(gp, (0, pad), constant_values=-1)  # unassigned

    def local(od_l, w_l, gp_l):
        parts = gpoint_block_partials(ng, gp_l, od_l, w_l, averaging_method)
        # Combine shard partials over the spectral mesh axis:
        # extremum keys ride pmin/pmax, everything else psum.
        return {k: (jax.lax.pmin(v, axis) if k == "min"
                    else jax.lax.pmax(v, axis) if k == "max"
                    else jax.lax.psum(v, axis))
                for k, v in parts.items()}

    acc = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(None, axis), P(None, axis), P(axis)),
        out_specs=P()))(od, w, gp)
    return jax.device_get(acc)


def sharded_average_od_to_gpoints(mesh, ng: int, g_point, optical_depth,
                                  weight, averaging_method: str,
                                  axis: str = "spectral",
                                  pressure_fl=None
                                  ) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
    """Average spectral od into g-points with the wavenumber axis sharded.

    Args:
      mesh: jax.sharding.Mesh with a named spectral axis.
      ng: static number of g-points.
      g_point: (nwav,) int map wavenumber -> g-point (<0 = unassigned).
      optical_depth: (nz, nwav).
      weight: (nwav,) or (nz, nwav) Planck/SSI weights.
      averaging_method: any of ops.average.GPOINT_AVERAGING_METHODS.
      axis: mesh axis name to shard wavenumbers over.
      pressure_fl: (nz,) full-level pressure (hybrid method only).

    Returns:
      (od_fit, min_od, max_od), each (nz, ng) — same semantics as
      ops.average.average_od_to_gpoints.
    """
    _check_method(averaging_method)
    acc = _sharded_block_partials(mesh, ng, g_point, optical_depth, weight,
                                  averaging_method, axis)
    return finalize_gpoint_partials(acc, averaging_method,
                                    pressure_fl=pressure_fl)


def streaming_sharded_average_od_to_gpoints(mesh, reader, ng: int, g_point,
                                            weight_fn,
                                            averaging_method: str,
                                            block_wav: int = 1 << 20,
                                            axis: str = "spectral",
                                            pressure_fl=None
                                            ) -> Tuple[np.ndarray,
                                                       np.ndarray,
                                                       np.ndarray]:
    """Streamed AND mesh-sharded g-point averaging — the multi-hundred-GB
    multi-chip execution the reference's design centers on
    (create_look_up_table.cpp:242-340; doc/ecckd_documentation.tex:225-228:
    spectra too large to be resident even on a whole pod slice's HBM).

    The host streams wavenumber blocks from disk (``reader.iter_blocks``,
    double-buffered when backed by the native loader); each block is
    sharded over the mesh's spectral axis and reduced to per-g-point
    partials with psum/pmin/pmax; the tiny (nz, ng) partials
    accumulate on host across blocks exactly as in the single-device
    streaming path (ops.streaming), so all three reductions commute and
    any block size / shard count gives the same result.

    Args mirror ops.streaming.streaming_average_od_to_gpoints plus
    ``mesh``/``axis``.
    """
    from ..ops.streaming import _combine

    _check_method(averaging_method)
    acc = None
    for iwav0, od_block in reader.iter_blocks(block_wav=block_wav):
        nb = od_block.shape[1]
        part = _sharded_block_partials(
            mesh, ng, g_point[iwav0:iwav0 + nb], od_block,
            weight_fn(iwav0, nb), averaging_method, axis)
        acc = part if acc is None else _combine(acc, part)
    return finalize_gpoint_partials(acc, averaging_method,
                                    pressure_fl=pressure_fl)


def sharded_average_od_to_gpoints_multihost(mesh, ng: int, g_point_local,
                                            od_local, weight_local,
                                            averaging_method: str,
                                            axis: str = "spectral",
                                            pressure_fl=None
                                            ) -> Tuple[np.ndarray,
                                                       np.ndarray,
                                                       np.ndarray]:
    """Multi-controller form: every PROCESS passes only its own contiguous
    wavenumber slice.

    Each host streams its share of the spectrum from local disk
    (distributed.local_shard_range), the local slices are assembled into a
    global array with ``jax.make_array_from_process_local_data`` (no
    cross-host data movement — each host's shards land on its own
    devices), and the same psum/pmin/pmax shard_map reduction runs over
    the global mesh.  The global wavenumber count is
    ``process_count * nwav_local`` and every process must pass the same
    local length, divisible by its local device count along ``axis``.
    """
    import jax

    if averaging_method not in SUPPORTED_METHODS:
        raise ValueError(
            f"sharded averaging does not support {averaging_method!r}; "
            f"choose from {SUPPORTED_METHODS}")
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    od_local = np.asarray(od_local)
    nz, nwav_local = od_local.shape
    w_local = np.broadcast_to(np.asarray(weight_local), od_local.shape)
    gp_local = np.asarray(g_point_local, np.int32)
    nproc = jax.process_count()
    nwav = nproc * nwav_local

    od_g = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(None, axis)), od_local, (nz, nwav))
    w_g = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(None, axis)), w_local, (nz, nwav))
    gp_g = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(axis)), gp_local, (nwav,))

    def local(od_l, w_l, gp_l):
        parts = gpoint_block_partials(ng, gp_l, od_l, w_l, averaging_method)
        return {k: (jax.lax.pmin(v, axis) if k == "min"
                    else jax.lax.pmax(v, axis) if k == "max"
                    else jax.lax.psum(v, axis))
                for k, v in parts.items()}

    acc = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(None, axis), P(None, axis), P(axis)),
        out_specs=P()))(od_g, w_g, gp_g)
    # Outputs are replicated -> addressable on every process
    acc = {k: np.asarray(jax.device_get(
        v.addressable_data(0))) for k, v in acc.items()}
    return finalize_gpoint_partials(acc, averaging_method,
                                    pressure_fl=pressure_fl)


def streaming_sharded_average_od_to_gpoints_multihost(
        mesh, ng: int, g_point_local, read_block_local, nwav_local: int,
        weight_fn, averaging_method: str, block_wav: int = 1 << 20,
        axis: str = "spectral", pressure_fl=None
        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Multi-controller streamed+sharded averaging: every PROCESS streams
    its own contiguous wavenumber slice from local disk in blocks.

    Per round, each process reads one local block
    (``read_block_local(iwav0, nb)`` -> (nz, nb), local indices), the
    blocks assemble into a global device array with
    ``jax.make_array_from_process_local_data`` (each host's data lands on
    its own devices — no cross-host block movement), the psum/pmin/pmax
    shard_map reduction runs over the global mesh, and the replicated
    (nz, ng) partials accumulate on every host across rounds.  The
    per-g-point partials are position-independent, so interleaving the
    processes' blocks in the assembled array is exact.

    Every process MUST pass the same ``nwav_local`` and ``block_wav``
    (collectives require identical round counts and block shapes).
    ``g_point_local``/``weight_fn`` use LOCAL indices, like
    ops.streaming's ``weight_fn``.
    """
    from ..ops.streaming import _combine
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    _check_method(averaging_method)
    nproc = jax.process_count()
    if nproc > 1 and mesh.shape[axis] != jax.device_count():
        # Same guard as _CandidateCostBase._shard_arrays: with
        # a data-parallel mesh the per-block padding below would mis-size
        # nloc_dev and the P(None, axis) process-local assembly misaligns.
        raise ValueError(
            "multi-controller streamed+sharded averaging needs the "
            "spectral mesh axis to span ALL devices (data_parallel=1); "
            f"got {axis}={mesh.shape[axis]} of {jax.device_count()} "
            "devices")
    gp_local = np.asarray(g_point_local, np.int32)

    def reduce_block(od_b, w_b, gp_b):
        nz, nb = od_b.shape
        # Pad to the local device count along ``axis`` so the global
        # assembly shards evenly; padded entries are unassigned (-1).
        nloc_dev = mesh.shape[axis] // nproc
        pad = (-nb) % max(nloc_dev, 1)
        if pad:
            od_b = np.pad(od_b, ((0, 0), (0, pad)))
            w_b = np.pad(w_b, ((0, 0), (0, pad)))
            gp_b = np.pad(gp_b, (0, pad), constant_values=-1)
        nbp = nb + pad
        od_g = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P(None, axis)), od_b, (nz, nproc * nbp))
        w_g = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P(None, axis)), w_b, (nz, nproc * nbp))
        gp_g = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P(axis)), gp_b, (nproc * nbp,))

        def local(od_l, w_l, gp_l):
            parts = gpoint_block_partials(ng, gp_l, od_l, w_l,
                                          averaging_method)
            return {k: (jax.lax.pmin(v, axis) if k == "min"
                        else jax.lax.pmax(v, axis) if k == "max"
                        else jax.lax.psum(v, axis))
                    for k, v in parts.items()}

        acc = jax.jit(shard_map(
            local, mesh=mesh,
            in_specs=(P(None, axis), P(None, axis), P(axis)),
            out_specs=P()))(od_g, w_g, gp_g)
        return {k: np.asarray(jax.device_get(v.addressable_data(0)))
                for k, v in acc.items()}

    acc = None
    for i0 in range(0, nwav_local, block_wav):
        nb = min(block_wav, nwav_local - i0)
        od_b = np.asarray(read_block_local(i0, nb), np.float64)
        w_b = np.broadcast_to(np.asarray(weight_fn(i0, nb)), od_b.shape)
        part = reduce_block(od_b, w_b, gp_local[i0:i0 + nb])
        acc = part if acc is None else _combine(acc, part)
    return finalize_gpoint_partials(acc, averaging_method,
                                    pressure_fl=pressure_fl)
