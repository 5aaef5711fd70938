"""Contiguous-interval reductions via prefix sums.

The framework's core reduction primitive.  In the reference, g-point and
candidate-interval reductions are serial loops or OpenMP loops over ``find()``
index vectors (e.g. average_optical_depth.cpp:37-44,
find_g_points.cpp:54-204).  Here every such reduction is over a
*contiguous* range of rank-ordered wavenumbers, so a sum over interval
[i1, i2] (inclusive) is a difference of prefix sums: O(nwav) total for any
number of intervals, fully parallel, no scatters.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp


def _member_dot(v, member):
    """``v @ member`` where ``member`` contains only exact 0/1 values, at
    ``Precision.HIGHEST``: true f32 (or f64) products.  At the default
    precision an f32 dot may run in TF32 on a GPU, which keeps a 10-bit
    mantissa of the data operand (~2^-11 relative error on every interval
    sum); the 0/1 operand is exact either way."""
    return jnp.matmul(v, member.astype(v.dtype),
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=v.dtype)


def interval_sum_fused(parts: Sequence[Callable], n: int, i1, i2,
                       dtype=None, tile: int = 8192):
    """Stacked interval sums with per-tile operand construction.

    Each element of ``parts`` is a callable ``part(start, size) ->
    (rows, size)`` returning its block of operand rows for the wavenumber
    range [start, start+size) — typically a ``lax.dynamic_slice_in_dim`` of
    a bound array, possibly combined elementwise with others (weights,
    masks, logs).  The blocks of all parts are reduced against ONE
    (size, nseg) membership matrix per tile, so arbitrarily many weighted
    reductions share a single pass over the spectrum and NOTHING of size n
    is ever materialized beyond the inputs themselves: no concatenated
    copies, no padded/transposed relayouts (at nwav ~ 10^6 and ~100 rows
    those copies are multi-GB of HBM traffic per sweep, several times the
    mandatory input reads).

    Args:
      parts: callables producing (rows_k, size) blocks; 1-D producers must
        return (1, size).
      n: length of the reduced axis (static).
      i1, i2: (nseg,) inclusive interval bounds.
      dtype: accumulator dtype (default: dtype of the first part's block).

    Returns:
      (sum(rows_k), nseg) stacked per-interval sums, parts in order.
    """
    i1 = jnp.asarray(i1, jnp.int32)
    i2 = jnp.asarray(i2, jnp.int32)
    nseg = i1.shape[0]

    def block(start, size):
        rows = [p(start, size) for p in parts]
        return jnp.concatenate(rows, axis=0) if len(rows) > 1 else rows[0]

    if dtype is None:
        dtype = jax.eval_shape(lambda: block(0, min(tile, n))).dtype

    def reduce_tile(start, size):
        idx = (jax.lax.broadcasted_iota(jnp.int32, (size, nseg), 0)
               + start)
        member = (idx >= i1[None, :]) & (idx <= i2[None, :])
        return _member_dot(block(start, size).astype(dtype), member)

    nfull = n // tile
    rem = n - nfull * tile
    out_rows = jax.eval_shape(lambda: block(0, min(tile, n))).shape[0]
    acc = jnp.zeros((out_rows, nseg), dtype)
    if nfull == 1 and rem == 0:
        return reduce_tile(0, n)
    if nfull > 0:
        acc = jax.lax.fori_loop(
            0, nfull,
            lambda k, a: a + reduce_tile(k * tile, tile), acc)
    if rem:
        acc = acc + reduce_tile(nfull * tile, rem)
    return acc


def _two_sum(a, b):
    """Error-free f32/f64 addition (Knuth): s + err == a + b exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _df_add(x, y):
    """Double-float addition of (hi, lo) pairs: ~2x-precision accumulate."""
    xh, xl = x
    yh, yl = y
    s, e = _two_sum(xh, yh)
    e = e + (xl + yl)
    hi = s + e
    lo = e - (hi - s)
    return hi, lo


@jax.jit
def _df_cumsum(v):
    """Inclusive double-float prefix sums along the last axis.

    Returns (hi, lo) with hi + lo ~= exact prefix sum to ~2x working
    precision: each associative-scan combine is a compensated (two-sum)
    double-float add, so the error after n elements is O(log n * eps^2)
    relative to the prefix magnitude instead of O(n * eps)."""
    return jax.lax.associative_scan(_df_add, (v, jnp.zeros_like(v)),
                                    axis=-1)


def build_prefix_sums(parts: Sequence[Callable], n: int, row_chunk: int = 64):
    """Precompute double-float prefix sums of fused-reduction parts.

    The repeated-sweep complement of :func:`interval_sum_fused`: when the
    SAME operand rows are reduced over many different interval sets (the
    g-point candidate search probes hundreds of bound sets per band), the
    O(rows * n) reduction pass can be paid ONCE — each subsequent interval
    sum is a pair of gathers into the prefix arrays
    (:func:`interval_sum_from_prefix`), O(rows * nseg).

    Precision: plain f32 prefix differences lose up to n*eps relative to
    the interval sum; the double-float (hi, lo) representation keeps the
    difference error at ~(C/S) * 2^-45 for f32 (C = prefix magnitude,
    S = interval sum).

    Parts are materialized eagerly (device ops, NOT inside jit — their
    closed-over operand arrays must never become XLA constants) and
    scanned in ``row_chunk`` row blocks to bound transient memory.  The
    scanned shape is bucketed (rows padded to a ``row_chunk`` multiple,
    columns to a power of two) so the jitted scan compiles at most once
    per bucket across bands.

    Returns (hi, lo), each (total_rows, n + 1) with a leading zero column,
    so the sum over inclusive [i1, i2] is C[i2 + 1] - C[i1].
    """
    npad = max(256, 1 << (n - 1).bit_length()) - n
    his, los = [], []
    for p in parts:
        block = p(0, n)
        rows = block.shape[0]
        rpad = (-rows) % row_chunk
        if npad or rpad:
            # Zero column padding leaves the first n prefixes unchanged;
            # zero rows are sliced back off below.
            block = jnp.pad(block, ((0, rpad), (0, npad)))
        for r0 in range(0, rows, row_chunk):
            hi, lo = _df_cumsum(block[r0:r0 + row_chunk])
            his.append(hi[:min(row_chunk, rows - r0), :n])
            los.append(lo[:min(row_chunk, rows - r0), :n])
    hi = jnp.concatenate(his, axis=0) if len(his) > 1 else his[0]
    lo = jnp.concatenate(los, axis=0) if len(los) > 1 else los[0]
    zero = jnp.zeros((hi.shape[0], 1), hi.dtype)
    return (jnp.concatenate([zero, hi], axis=1),
            jnp.concatenate([zero, lo], axis=1))


def interval_sum_from_prefix(hi, lo, i1, i2):
    """Interval sums over inclusive [i1, i2] from double-float prefix sums.

    ``hi``/``lo`` come from :func:`build_prefix_sums`.  The hi difference
    of nearby prefixes is exact (Sterbenz) or correctly rounded; adding the
    lo difference restores the compensated tail."""
    j1 = jnp.asarray(i1, jnp.int32)
    j2 = jnp.asarray(i2, jnp.int32) + 1
    h = jnp.take(hi, j2, axis=1) - jnp.take(hi, j1, axis=1)
    l = jnp.take(lo, j2, axis=1) - jnp.take(lo, j1, axis=1)
    return h + l


def part_of(*arrays):
    """Fused-reduction part: the elementwise product of ``arrays`` (each
    (rows, n) or (n,); 1-D arrays broadcast across rows), sliced per tile.
    With one array this is a plain row block."""
    def part(start, size):
        out = None
        for a in arrays:
            a = jnp.asarray(a)
            sl = jax.lax.dynamic_slice_in_dim(a, start, size, axis=a.ndim - 1)
            if a.ndim == 1:
                sl = sl[None, :]
            out = sl if out is None else out * sl
        return out
    return part


def interval_sum(values, i1, i2, tile: int = 8192):
    """Sum ``values`` over inclusive index intervals along the last axis.

    Implemented as tiled membership matmuls: per wavenumber tile a
    (tile, nseg) membership matrix ``i1 <= idx <= i2`` is built on the fly
    and reduced by one full-precision matmul.  Exact for arbitrary
    (overlapping) intervals, O(n * nseg) MACs, no prefix sums.

    Args:
      values: (..., n) data.
      i1, i2: (nseg,) int interval bounds, inclusive, 0 <= i1 <= i2 < n.

    Returns:
      (..., nseg) per-interval sums.
    """
    v = jnp.asarray(values)
    n = v.shape[-1]
    lead = v.shape[:-1]
    v2 = v.reshape((-1, n))
    out = interval_sum_fused([part_of(v2)], n, i1, i2, dtype=v.dtype,
                             tile=tile)
    return out.reshape(lead + (out.shape[-1],))


def interval_count(mask, i1, i2, dtype=None):
    """Count of True values in each interval of the last axis."""
    m = jnp.asarray(mask)
    if dtype is None:
        dtype = jnp.result_type(float)
    return interval_sum(m.astype(dtype), i1, i2)


def segment_matmul(values, onehot):
    """Segment reduction as a matmul: (..., n) @ (n, nseg).

    For non-contiguous segment maps (e.g. g-point membership after base_split
    dissection), use a one-hot membership matrix; preferred when nseg is
    small and values has many rows.  Full precision (never TF32).
    """
    return jnp.matmul(values, onehot, precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=values.dtype)


def gpoint_onehot(g_point, ng, dtype=jnp.float32):
    """One-hot (nwav, ng) membership matrix from a per-wavenumber g-point map.

    Entries with g_point < 0 (unassigned) contribute to no g-point.
    """
    gp = jnp.asarray(g_point)
    return (gp[:, None] == jnp.arange(ng)[None, :]).astype(dtype)
