"""Cross-band batching of equipartition candidate probes.

The reference partitions bands strictly sequentially
(find_g_points.cpp:1152): each equipartition probe is a separate
evaluation, so a gas with nband bands pays nband times the serial
host->device decision latency.  Bands are
independent, so their searches can run concurrently with every device
dispatch carrying the pending probes of ALL bands.

Design: one gas-level candidate-cost kernel spans the full rank axis
(bands are disjoint, contiguous rank ranges, so a band probe is just a
global interval — the kernel's per-interval reductions and the per-
wavenumber flux recurrence never mix intervals, making merged evaluation
bit-identical to per-band evaluation on the same kernel).  Each band's
search runs on its own thread against a :class:`BandKernelView`; a
:class:`ProbeScheduler` implements a dynamic barrier — a merged kernel
dispatch fires exactly when every live band thread is blocked on a
pending probe batch, so batch composition never changes any band's
sequence of results (each probe's cost is independent of what else rides
the dispatch).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np


class ProbeScheduler:
    """Dynamic barrier merging concurrent per-band probes into single
    whole-gas kernel dispatches.

    Threads register, repeatedly call :meth:`costs` (blocking until the
    merged result arrives), and deregister via :meth:`done`.  A merged
    dispatch fires when every registered thread has a pending batch; a
    thread finishing its search lowers the bar for the rest.
    """

    def __init__(self, kernel):
        self.kernel = kernel
        self._cv = threading.Condition()
        self._active = 0
        self._pending: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._results: Dict[int, np.ndarray] = {}
        self._err: Optional[BaseException] = None
        self.dispatches = 0

    def register(self):
        with self._cv:
            self._active += 1

    def done(self):
        with self._cv:
            self._active -= 1
            self._maybe_dispatch()

    def costs(self, jband: int, i1: np.ndarray, i2: np.ndarray
              ) -> np.ndarray:
        with self._cv:
            assert jband not in self._pending
            self._pending[jband] = (np.asarray(i1, np.int64),
                                    np.asarray(i2, np.int64))
            self._maybe_dispatch()
            while jband not in self._results and self._err is None:
                self._cv.wait()
            if self._err is not None and jband not in self._results:
                raise RuntimeError(
                    "merged candidate-sweep dispatch failed") from self._err
            return self._results.pop(jband)

    def _maybe_dispatch(self):
        """Called with the lock held."""
        if not self._pending or len(self._pending) < self._active:
            return
        items = sorted(self._pending.items())   # ascending band = rank order
        self._pending = {}
        counts = [len(i1) for _, (i1, _) in items]
        i1 = np.concatenate([i1 for _, (i1, _) in items])
        i2 = np.concatenate([i2 for _, (_, i2) in items])
        try:
            out = self.kernel.costs(i1.astype(np.int32),
                                    i2.astype(np.int32))
        except BaseException as e:   # noqa: BLE001 — fanned out to waiters
            self._err = e
            self._cv.notify_all()
            raise
        self.dispatches += 1
        pos = 0
        for (jband, _), n in zip(items, counts):
            self._results[jband] = out[pos:pos + n]
            pos += n
        self._cv.notify_all()


class BandKernelView:
    """Band-local facade over a gas-level candidate-cost kernel.

    Exposes the ``npoints``/``costs`` surface CkdEquipartition needs, with
    rank bounds shifted by the band's global offset.  With a scheduler the
    probes join the merged cross-band dispatches; without one they
    evaluate immediately on the gas kernel (the sequential validation
    mode, band_parallel=serial — bit-identical cost math to the parallel
    mode by construction).
    """

    def __init__(self, kernel, offset: int, npoints: int,
                 scheduler: Optional[ProbeScheduler] = None,
                 jband: Optional[int] = None):
        self.kernel = kernel
        self.offset = int(offset)
        self.npoints = int(npoints)
        self.scheduler = scheduler
        self.jband = jband

    def costs(self, i1, i2, seg_of_wav=None) -> np.ndarray:
        # The partition map is derived on device from the GLOBAL bounds
        # inside the kernel; the band-local map from CkdEquipartition is
        # ignored.
        g1 = np.asarray(i1, np.int64) + self.offset
        g2 = np.asarray(i2, np.int64) + self.offset
        if self.scheduler is not None:
            return self.scheduler.costs(self.jband, g1, g2)
        return self.kernel.costs(g1.astype(np.int32), g2.astype(np.int32))
