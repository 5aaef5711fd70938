"""Streaming g-point averaging over spectral shards.

The multi-hundred-GB analogue of ops.average.average_od_to_gpoints: consume
wavenumber blocks from a ShardReader (double-buffered native reads) and
accumulate the per-g-point weighted sums on device, so host I/O overlaps
device compute.  Every averaging reduction (all 8 methods of
average_optical_depth.cpp:120-197, including logarithmic zero-counting and
the pressure-switched hybrid) is expressible as accumulated weighted sums
over wavenumber blocks plus a final transform, and the per-block partial
sums are exactly the quantities that would be psum-reduced across a
wavenumber-sharded mesh in the multi-host setting
(parallel.sharded_average).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from .average import (GPOINT_AVERAGING_METHODS, gpoint_block_partials,
                      finalize_gpoint_partials)

# One compiled dispatch per block instead of ~10 eager ops, so the
# per-block cost is bandwidth, not dispatch latency.  ng and the method string are static; distinct block
# shapes (the final partial block) compile separately and hit the cache
# on subsequent profiles/gases.
_block_partials_jit = jax.jit(gpoint_block_partials, static_argnums=(0, 4))


def _block_accumulate(ng, g_point_block, od_block, weight_block,
                      averaging_method):
    """Partial sums for one wavenumber block -> dict of (nz, ng) np arrays."""
    # No ascontiguousarray anywhere: jnp.asarray copies host arrays into
    # device buffers regardless of their strides, so forcing a contiguous
    # host copy first (even of od_block, the large transposed view from
    # ShardReader.read_block) would only add a second pass over the data.
    out = _block_partials_jit(ng, g_point_block, od_block, weight_block,
                              averaging_method)
    # Single batched device->host sync for the whole (tiny) partials dict.
    return jax.device_get(out)


def _combine(acc, part):
    """In-place combination of per-block partials: min/max by elementwise
    extremum, every other key by addition."""
    for key, v in part.items():
        if key == "min":
            acc[key] = np.minimum(acc[key], v)
        elif key == "max":
            acc[key] = np.maximum(acc[key], v)
        else:
            acc[key] = acc[key] + v
    return acc


def streaming_average_od_to_gpoints(reader, ng, g_point, weight_fn,
                                    averaging_method,
                                    block_wav: int = 1 << 16,
                                    pressure_fl=None):
    """Average a shard's od into g-points, streaming wavenumber blocks.

    Args:
      reader: io.shards.ShardReader (anything with ``iter_blocks``).
      g_point: (nwav,) map in the shard's wavenumber order.
      weight_fn: callable (iwav0, nwav_block) -> (nz, block) or (block,)
        weights (Planck or SSI slice).
      averaging_method: any of ops.average.GPOINT_AVERAGING_METHODS.
      pressure_fl: (nz,) full-level pressure, required for the hybrid
        pressure-switched method.

    Returns (od_fit, min_od, max_od), each (nz, ng) — identical semantics to
    ops.average.average_od_to_gpoints.
    """
    if averaging_method not in GPOINT_AVERAGING_METHODS:
        raise ValueError(
            f"streaming averaging does not support {averaging_method!r}; "
            f"choose from {GPOINT_AVERAGING_METHODS}")
    from ..io.prefetch import prefetch_iter
    acc = None
    # One block read ahead on a background thread: overlaps h5py/NetCDF
    # reads with device accumulation (the native .spbin loader already
    # double-buffers below this layer; this covers every other source).
    for iwav0, od_block in prefetch_iter(
            reader.iter_blocks(block_wav=block_wav), depth=2):
        nb = od_block.shape[1]
        gp_block = g_point[iwav0:iwav0 + nb]
        w_block = weight_fn(iwav0, nb)
        part = _block_accumulate(ng, gp_block, od_block, w_block,
                                 averaging_method)
        acc = part if acc is None else _combine(acc, part)
    return finalize_gpoint_partials(acc, averaging_method,
                                    pressure_fl=pressure_fl)
