"""Flat binary spectral shards for high-throughput streaming.

The CKDMIP database is ~700 GB of HDF5 spectra and the reference's wall
clock is dominated by reading it (doc/ecckd_documentation.tex:225-228).
For the streaming compute path this module converts spectra into a flat
binary layout optimized for the access pattern of the device pipeline —
contiguous *wavenumber blocks* of all layers — and iterates them with
double-buffered asynchronous reads (native thread pool, io/native.py)
overlapping host I/O with device compute.

Format (one ``.spbin`` file per profile):
  [8-byte little-endian header length][JSON header]
  [wavenumber float64 array][d_wavenumber float64 array]
  [optical depth, shape (nwav, nlay), dtype from header, C order]

Storing od transposed makes a contiguous byte range equal a contiguous
wavenumber block across all layers.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

from .native import NativeFile, PrefetchPool
from .spectrum import Spectrum, read_spectrum

_MAGIC = "ecckd_tpu-spbin-v1"


def write_shard(path: str, spectrum: Spectrum, dtype=np.float32):
    """Write one profile's spectrum as a flat binary shard."""
    od_t = np.ascontiguousarray(spectrum.optical_depth.T.astype(dtype))
    nwav, nlay = od_t.shape
    header = dict(
        magic=_MAGIC, dtype=np.dtype(dtype).name, nlay=nlay, nwav=nwav,
        molecule=spectrum.molecule,
        reference_surface_vmr=float(spectrum.reference_surface_vmr),
        pressure_hl=list(map(float, spectrum.pressure_hl)),
        temperature_hl=list(map(float, spectrum.temperature_hl)),
        vmr_fl=(list(map(float, np.atleast_1d(spectrum.vmr_fl)))
                if spectrum.vmr_fl is not None else None),
    )
    hjson = json.dumps(header).encode()
    # Write-then-rename so an interrupted write never leaves a truncated
    # shard at the final path (callers cache shards by existence).
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<q", len(hjson)))
        f.write(hjson)
        f.write(np.asarray(spectrum.wavenumber, np.float64).tobytes())
        f.write(np.asarray(spectrum.d_wavenumber, np.float64).tobytes())
        f.write(od_t.tobytes())
    os.replace(tmp, path)
    return path


def convert_spectrum_file(h5_path: str, out_prefix: str, iprofiles=None,
                          dtype=np.float32):
    """Convert profiles of a CKDMIP HDF5 spectrum file to shards."""
    sp0 = read_spectrum(h5_path, 0)
    n = sp0.ncol
    if iprofiles is None:
        iprofiles = range(n)
    paths = []
    for iprof in iprofiles:
        sp = sp0 if iprof == 0 else read_spectrum(h5_path, iprof)
        paths.append(write_shard(f"{out_prefix}_{iprof:03d}.spbin", sp,
                                 dtype))
    return paths


class ShardReader:
    """Read a shard's metadata eagerly and stream od wavenumber blocks."""

    def __init__(self, path: str):
        self.path = path
        self._file = NativeFile(path)
        hlen = struct.unpack("<q", bytes(self._file.read(0, 8)))[0]
        self.header = json.loads(bytes(self._file.read(8, hlen)))
        if self.header.get("magic") != _MAGIC:
            raise ValueError(f"{path} is not a spectral shard")
        self.nlay = self.header["nlay"]
        self.nwav = self.header["nwav"]
        self.dtype = np.dtype(self.header["dtype"])
        self.pressure_hl = np.asarray(self.header["pressure_hl"])
        self.temperature_hl = np.asarray(self.header["temperature_hl"])
        off = 8 + hlen
        self.wavenumber = np.frombuffer(
            bytes(self._file.read(off, self.nwav * 8)), np.float64)
        off += self.nwav * 8
        self.d_wavenumber = np.frombuffer(
            bytes(self._file.read(off, self.nwav * 8)), np.float64)
        self._od_offset = off + self.nwav * 8
        self._row_bytes = self.nlay * self.dtype.itemsize

    def read_block(self, iwav0: int, nwav_block: int) -> np.ndarray:
        """Synchronously read a (nlay, nwav_block) od block."""
        raw = self._file.read(self._od_offset + iwav0 * self._row_bytes,
                              nwav_block * self._row_bytes)
        block = np.frombuffer(bytes(raw), self.dtype).reshape(
            -1, self.nlay)
        return block.T

    def iter_blocks(self, block_wav: int = 1 << 16,
                    pool: Optional[PrefetchPool] = None
                    ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (iwav0, od_block) with double-buffered prefetch.

        While block k is being processed on device, block k+1 is being read
        by the native thread pool.
        """
        own_pool = pool is None
        if own_pool:
            pool = PrefetchPool(nthreads=2)
        try:
            starts = list(range(0, self.nwav, block_wav))
            # Prime the pipeline
            if starts:
                n0 = min(block_wav, self.nwav - starts[0])
                pool.submit(self._file,
                            self._od_offset + starts[0] * self._row_bytes,
                            n0 * self._row_bytes, tag=0)
            for k, iwav0 in enumerate(starts):
                if k + 1 < len(starts):
                    nxt = starts[k + 1]
                    nn = min(block_wav, self.nwav - nxt)
                    pool.submit(self._file,
                                self._od_offset + nxt * self._row_bytes,
                                nn * self._row_bytes, tag=k + 1)
                raw = pool.wait(k)
                block = np.frombuffer(bytes(raw), self.dtype).reshape(
                    -1, self.nlay).T
                yield iwav0, block
        finally:
            if own_pool:
                pool.close()

    def close(self):
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
