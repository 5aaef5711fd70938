"""NetCDF file I/O.

Replacement for the reference's DataFile/OutputDataFile layer
(src/include/DataFile.h:49-337, src/include/OutputDataFile.h:47-193,
src/tools/DataFileEngineNetcdf.cpp, src/tools/OutputDataFile.cpp) on top of
packages every installation has:

* The pipeline writes its own files (order, g-points, LUT, ckd-definition,
  fluxes) as NetCDF-3 64-bit-offset files through ``scipy.io.netcdf_file``.
  Every netCDF reader, ecRad included, reads that format.
* :class:`NcFile` reads NetCDF-3 files through the same module, and
  HDF5-based NetCDF-4 files (the CKDMIP database's own format) through
  ``h5py``, imported only when a file carries the HDF5 signature.

Write-side parity features (ref OutputDataFile.cpp):
* define_dimension (one unlimited dimension, the first of its variables)
* typed variables: double/float/int/short/byte; strings as char arrays
* ``append_history``: timestamped command line appended to the global
  ``history`` attribute (ref OutputDataFile.cpp:1005-1048)
"""

from __future__ import annotations

import datetime
import os
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.io import netcdf_file

_TYPE_MAP = {
    "double": np.float64,
    "float": np.float32,
    "int": np.int32,
    "short": np.int16,
    "byte": np.int8,
}

_HDF5_SIGNATURE = b"\x89HDF\r\n\x1a\n"


def _decode(value):
    if isinstance(value, bytes):
        return value.decode("utf-8", "replace")
    if isinstance(value, np.ndarray) and value.dtype.kind in ("S", "O"):
        if value.size == 1:
            return _decode(value.reshape(-1)[0])
        return [_decode(v) for v in value]
    if isinstance(value, np.generic):
        return value.item() if value.dtype.kind in "iufb" else _decode(value.item())
    return value


def _native(a: np.ndarray) -> np.ndarray:
    """Copy into native byte order (NetCDF-3 data are big-endian)."""
    a = np.asarray(a)
    return np.array(a, dtype=a.dtype.newbyteorder("="))


class NcFile:
    """Read-only NetCDF file (DataFile equivalent).

    ``NcFile(path)`` opens NetCDF-3 files with scipy and HDF5-based
    NetCDF-4 files with h5py; both readers share this interface."""

    def __new__(cls, path: str):
        if cls is not NcFile:
            return super().__new__(cls)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        with open(path, "rb") as fh:
            magic = fh.read(8)
        if magic.startswith(b"CDF"):
            return super().__new__(_Nc3File)
        if magic == _HDF5_SIGNATURE:
            return super().__new__(_Hdf5File)
        raise ValueError(f"{path}: not a NetCDF-3 or NetCDF-4 file")

    def read_scalar(self, name: str) -> float:
        val = self.read(name)
        if isinstance(val, np.ndarray):
            return val.reshape(-1)[0].item()
        return val

    def read_string(self, name: str) -> str:
        return str(self.read(name))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Nc3Reader(netcdf_file):
    """``netcdf_file`` reading sizes from the dimensions, not from the
    32-bit size field, which holds 2^32 - 1 for variables over 4 GiB and
    which scipy reads as signed; a lone record variable is not padded
    between records, as the format specifies."""

    _lone_record = False

    def _read_var_array(self):
        pos = self.fp.tell()
        self.fp.read(4)
        shapes = [self._read_var()[2] for _ in range(self._unpack_int())]
        self._lone_record = sum(bool(s) and s[0] is None
                                for s in shapes) == 1
        self.fp.seek(pos)
        super()._read_var_array()

    def _read_var(self):
        return self._true_vsize(super()._read_var())

    def _true_vsize(self, var):
        var = list(var)
        shape, itemsize = var[2], var[5]
        isrec = bool(shape) and shape[0] is None
        nbytes = int(np.prod(shape[1:] if isrec else shape,
                             dtype=np.int64)) * itemsize
        var[8] = nbytes if isrec and self._lone_record else _pad4(nbytes)
        return tuple(var)


class _Nc3File(NcFile):
    """NetCDF-3 (classic or 64-bit offset) reader over scipy."""

    def __init__(self, path: str):
        self.path = path
        self._f = _Nc3Reader(path, "r", mmap=True)

    def exist(self, name: str) -> bool:
        return name in self._f.variables

    def size(self, name: str) -> Tuple[int, ...]:
        return tuple(self._f.variables[name].shape)

    def names(self) -> List[str]:
        return list(self._f.variables)

    def read(self, name: str, index: Optional[int] = None,
             index2: Optional[int] = None) -> np.ndarray:
        """Read a variable; ``index`` selects along the leading dimension
        (matching DataFile's slice-read convention, DataFile.h:140-220)."""
        data = self._f.variables[name].data
        if data.dtype.kind == "S":          # char array: one string
            return b"".join(np.asarray(data).reshape(-1)).rstrip(
                b"\x00").decode("utf-8", "replace")
        if data.shape == ():
            return _decode(_native(data)[()])
        if index is None:
            return _native(data)
        if index2 is None:
            return _native(data[index, ...])
        return _native(data[index, index2, ...])

    def read_slice(self, name: str, index: Optional[int],
                   start: int, stop: int) -> np.ndarray:
        """Hyperslab read along the LAST axis of one leading-index record
        (``var[index, ..., start:stop]``) — the streaming-read primitive:
        at CKDMIP scale a (nlay, nwav) profile is several GB, so the
        wavenumber axis is consumed in blocks."""
        data = self._f.variables[name].data
        if index is None:
            return _native(data[..., start:stop])
        return _native(data[index, ..., start:stop])

    def attribute(self, attr: str, var: Optional[str] = None,
                  default: Any = None) -> Any:
        obj = self._f if var is None else self._f.variables[var]
        if attr in obj._attributes:
            return _decode(obj._attributes[attr])
        return default

    def global_attributes(self) -> Dict[str, Any]:
        return {k: _decode(v) for k, v in self._f._attributes.items()
                if not k.startswith("_")}

    def close(self):
        self._f.close()


class _Hdf5File(NcFile):
    """HDF5-based NetCDF-4 reader (CKDMIP inputs) over h5py."""

    def __init__(self, path: str):
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                f"{path} is an HDF5-based NetCDF-4 file; reading it needs "
                "the h5py package") from e
        self.path = path
        self._h5py = h5py
        self._f = h5py.File(path, "r")

    def _resolve(self, name: str) -> str:
        """Resolve a netCDF variable name to its HDF5 dataset: variables that
        clash with a dimension name are stored as _nc4_non_coord_<name>
        (netcdf-c convention)."""
        alt = "_nc4_non_coord_" + name
        if alt in self._f:
            return alt
        return name

    def _is_dataset(self, name: str) -> bool:
        return isinstance(self._f[name], self._h5py.Dataset)

    def exist(self, name: str) -> bool:
        name = self._resolve(name)
        if name not in self._f or not self._is_dataset(name):
            return False
        # A pure dimension scale with no data is not a netCDF variable
        nm = self._f[name].attrs.get("NAME")
        if nm is not None and bytes(nm).startswith(
                b"This is a netCDF dimension but not a netCDF variable"):
            return False
        return True

    def size(self, name: str) -> Tuple[int, ...]:
        return tuple(self._f[self._resolve(name)].shape)

    def names(self) -> List[str]:
        return [k for k in self._f.keys() if self._is_dataset(k)]

    def read(self, name: str, index: Optional[int] = None,
             index2: Optional[int] = None) -> np.ndarray:
        ds = self._f[self._resolve(name)]
        if ds.shape == ():  # scalar
            return _decode(ds[()])
        if index is None:
            data = ds[...]
        elif index2 is None:
            data = ds[index, ...]
        else:
            data = ds[index, index2, ...]
        if data.dtype.kind in ("S", "O"):
            return _decode(data)
        return data

    def read_slice(self, name: str, index: Optional[int],
                   start: int, stop: int) -> np.ndarray:
        ds = self._f[self._resolve(name)]
        if index is None:
            return ds[..., start:stop]
        return ds[index, ..., start:stop]

    def attribute(self, attr: str, var: Optional[str] = None,
                  default: Any = None) -> Any:
        obj = self._f if var is None else self._f[self._resolve(var)]
        if attr in obj.attrs:
            return _decode(obj.attrs[attr])
        return default

    def global_attributes(self) -> Dict[str, Any]:
        return {k: _decode(v) for k, v in self._f.attrs.items()
                if not k.startswith("_")}

    def close(self):
        self._f.close()


# NetCDF-3 header tags and types (NetCDF Users Guide, "File format
# specifications"; CDF-2 is the 64-bit-offset variant)
_NC_DIMENSION, _NC_VARIABLE, _NC_ATTRIBUTE = 10, 11, 12
_NC_TYPES = {np.dtype("int8"): 1, np.dtype("S1"): 2, np.dtype("int16"): 3,
             np.dtype("int32"): 4, np.dtype("float32"): 5,
             np.dtype("float64"): 6}
# A variable's size (per record for record variables) is stored in 32 bits.
# Larger variables store 2^32 - 1 and are allowed only as the last variable
# of their section: the last fixed-size one when there are no record
# variables, or the last record variable.
_VSIZE_MAX = 2 ** 32 - 4
_VSIZE_LARGE = 2 ** 32 - 1
# Leading-axis rows converted and written per call (bounds the temporary)
_WRITE_CHUNK_BYTES = 64 << 20


def _pad4(n: int) -> int:
    return n + (-n % 4)


def _pack_name(name: str) -> bytes:
    raw = name.encode("utf-8")
    return struct.pack(">i", len(raw)) + raw + b"\0" * (-len(raw) % 4)


def _attr_value(value: Any):
    """NetCDF-3 attribute value: text as UTF-8 chars, numbers as arrays."""
    if isinstance(value, str):
        return value.encode("utf-8")
    if isinstance(value, (bool, np.bool_)):
        return np.int8(value)
    arr = np.asarray(value)
    if arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    return arr


def _pack_attributes(attrs: Dict[str, Any]) -> bytes:
    if not attrs:
        return b"\0" * 8                       # ABSENT
    out = [struct.pack(">ii", _NC_ATTRIBUTE, len(attrs))]
    for name, value in attrs.items():
        if isinstance(value, bytes):
            nc_type, n, raw = 2, len(value), value
        else:
            arr = np.asarray(value).reshape(-1)
            native = arr.dtype.newbyteorder("=")
            if native not in _NC_TYPES:
                raise ValueError(f"attribute {name!r}: NetCDF-3 has no "
                                 f"type for {arr.dtype}")
            nc_type, n = _NC_TYPES[native], arr.size
            raw = arr.astype(arr.dtype.newbyteorder(">")).tobytes()
        out += [_pack_name(name), struct.pack(">ii", nc_type, n), raw,
                b"\0" * (-len(raw) % 4)]
    return b"".join(out)


class _Var:
    """One variable of an :class:`NcWriter`: its definition and layout."""

    def __init__(self, name: str, dtype, dims: Tuple[str, ...],
                 shape: Tuple[Optional[int], ...]):
        self.name = name
        self.dtype = np.dtype(dtype).newbyteorder(">")
        self.dims = dims
        self.shape = shape
        self.isrec = bool(shape) and shape[0] is None
        self.attrs: Dict[str, Any] = {}
        self.begin = 0
        inner = shape[1:] if self.isrec else shape
        self.nbytes = int(np.prod(inner, dtype=np.int64)) * self.dtype.itemsize
        self.vsize = _pad4(self.nbytes)   # bytes (per record if isrec)


class NcWriter:
    """NetCDF-3 64-bit-offset writer (OutputDataFile equivalent).

    Follows the reference's two-phase model: dimensions, variables and
    attributes are defined first, then data are written.  Until
    :meth:`end_define` the data written are kept in memory and definitions
    may be interleaved with them; :meth:`end_define` (or :meth:`close`)
    writes the header and the kept data, after which every write goes
    straight to its place in the file and nothing more can be defined.
    Writers of spectrum-sized files call :meth:`end_define` once their
    definitions are complete, so no more than one write is ever held in
    memory.  Data never written read back as zeros.
    """

    def __init__(self, path: str):
        self.path = path
        self._fp = open(path, "wb")
        self._dims: Dict[str, Optional[int]] = {}
        self._vars: Dict[str, _Var] = {}
        self._attrs: Dict[str, Any] = {}
        self._unlimited: Optional[str] = None
        self._pending: List[Tuple[str, Optional[int], np.ndarray]] = []
        self._defining = True
        self._numrecs = 0
        self._recsize = 0
        self._end = 0

    def _check_defining(self, what: str):
        if not self._defining:
            raise ValueError(f"{self.path}: cannot define {what} after "
                             "end_define()")

    # -- dimensions ------------------------------------------------------
    def define_dimension(self, name: str, length: Optional[int] = None):
        """Define a dimension; ``length=None`` means unlimited (at most one
        per file, the NetCDF-3 rule)."""
        if name in self._dims:
            return
        self._check_defining(f"dimension {name!r}")
        if length is None:
            if self._unlimited is not None:
                raise ValueError(
                    f"{self.path}: NetCDF-3 allows one unlimited dimension; "
                    f"{self._unlimited!r} already is")
            self._unlimited = name
        self._dims[name] = None if length is None else int(length)

    # -- variables -------------------------------------------------------
    def define_variable(self, name: str, dtype: str = "float", *dims: str):
        for d in dims:
            if d not in self._dims:
                raise ValueError(f"Dimension {d!r} not defined")
        if name in self._vars:
            raise ValueError(f"Variable {name!r} already defined")
        if self._unlimited in dims[1:]:
            raise ValueError(f"{name!r}: the unlimited dimension "
                             f"{self._unlimited!r} must come first")
        self._check_defining(f"variable {name!r}")
        self._vars[name] = _Var(name, _TYPE_MAP[dtype], tuple(dims),
                                tuple(self._dims[d] for d in dims))

    def write(self, data: Any, name: str, index: Optional[int] = None):
        """Write data to a defined variable (or define-and-write a scalar
        or string).

        ``index`` writes one slice along the leading dimension, growing it if
        unlimited (the reference's per-concentration LUT writes and lw_spectra
        unlimited-column writes).
        """
        if name not in self._vars:
            if isinstance(data, str):
                raw = np.frombuffer(data.encode("utf-8") or b"\0", "S1")
                dim = f"{name}_length"
                self.define_dimension(dim, raw.size)
                self._check_defining(f"variable {name!r}")
                self._vars[name] = _Var(name, "S1", (dim,), (raw.size,))
                return self.write(raw, name)
            arr = np.asarray(data)
            if arr.ndim != 0:
                raise ValueError(f"Variable {name!r} not defined")
            if arr.dtype == np.int64:
                arr = arr.astype(np.int32)
            elif arr.dtype == np.bool_:
                arr = arr.astype(np.int8)
            self._check_defining(f"variable {name!r}")
            self._vars[name] = _Var(name, arr.dtype, (), ())
            return self.write(arr, name)
        var = self._vars[name]
        if index is not None and not var.isrec \
                and not 0 <= index < var.shape[0]:
            raise IndexError(f"{name!r}: index {index} outside "
                             f"{var.dims[0]!r} of length {var.shape[0]}")
        if var.isrec:
            self._numrecs = max(self._numrecs, index + 1 if index is not None
                                else np.shape(data)[0])
        if self._defining:
            self._pending.append((name, index, np.array(data)))
        else:
            self._write_data(var, index, data)

    def _write_data(self, var: _Var, index: Optional[int], data: Any):
        arr = np.asarray(data)
        if var.isrec:
            inner = var.shape[1:]
            if index is not None:
                self._write_rows(var.begin + index * self._recsize,
                                 np.broadcast_to(arr, inner), var.dtype)
                return
            for r in range(arr.shape[0]):
                self._write_rows(var.begin + r * self._recsize,
                                 np.broadcast_to(arr[r], inner), var.dtype)
            return
        if index is None:
            self._write_rows(var.begin, np.broadcast_to(arr, var.shape),
                             var.dtype)
        else:
            row = var.nbytes // var.shape[0]
            self._write_rows(var.begin + index * row,
                             np.broadcast_to(arr, var.shape[1:]), var.dtype)

    def _write_rows(self, offset: int, arr: np.ndarray, dtype: np.dtype):
        """Write ``arr`` as ``dtype`` at ``offset``, converting a bounded
        number of leading-axis rows at a time."""
        self._fp.seek(offset)
        if arr.ndim == 0:
            self._fp.write(np.asarray(arr, dtype).tobytes())
            return
        row = max(int(np.prod(arr.shape[1:], dtype=np.int64))
                  * dtype.itemsize, 1)
        step = max(_WRITE_CHUNK_BYTES // row, 1)
        for i in range(0, arr.shape[0], step):
            chunk = np.ascontiguousarray(arr[i:i + step], dtype)
            self._fp.write(memoryview(chunk.reshape(-1).view(np.uint8)))

    # -- layout ------------------------------------------------------------
    def _ordered(self) -> List[_Var]:
        """Variables in file order: fixed-size before record variables,
        each section in definition order except that one variable over
        the 32-bit size limit goes last in its section."""
        fixed = [v for v in self._vars.values() if not v.isrec]
        rec = [v for v in self._vars.values() if v.isrec]
        for section, kind in ((fixed, "fixed-size"), (rec, "record")):
            large = [v for v in section if v.vsize > _VSIZE_MAX]
            if len(large) > 1 or (large and kind == "fixed-size" and rec):
                v = large[-1]
                raise ValueError(
                    f"{self.path}: {kind} variable {v.name!r} takes "
                    f"{v.nbytes} bytes{' per record' if v.isrec else ''}; a "
                    f"NetCDF-3 64-bit-offset file allows more than "
                    f"{_VSIZE_MAX} bytes only for the last fixed-size "
                    "variable of a file without record variables, or the "
                    "last record variable")
            if large:
                section.remove(large[0])
                section.append(large[0])
        return fixed + rec

    def _header(self, order: List[_Var]) -> bytes:
        dim_ids = {d: i for i, d in enumerate(self._dims)}
        out = [b"CDF\x02", struct.pack(">i", self._numrecs)]
        if self._dims:
            out.append(struct.pack(">ii", _NC_DIMENSION, len(self._dims)))
            for d, n in self._dims.items():
                out += [_pack_name(d), struct.pack(">i", n or 0)]
        else:
            out.append(b"\0" * 8)
        out.append(_pack_attributes(self._attrs))
        if order:
            out.append(struct.pack(">ii", _NC_VARIABLE, len(order)))
        else:
            out.append(b"\0" * 8)
        for v in order:
            out += [_pack_name(v.name), struct.pack(">i", len(v.dims)),
                    b"".join(struct.pack(">i", dim_ids[d]) for d in v.dims),
                    _pack_attributes(v.attrs),
                    struct.pack(">iIq", _NC_TYPES[v.dtype.newbyteorder("=")],
                                _VSIZE_LARGE if v.vsize > _VSIZE_MAX
                                else v.vsize, v.begin)]
        return b"".join(out)

    def end_define(self):
        """Fix the layout, write the header and every write kept so far;
        later writes go straight to the file."""
        if not self._defining:
            return
        order = self._ordered()
        offset = len(self._header(order))   # begins are fixed-width
        for v in order:
            if not v.isrec:
                v.begin = offset
                offset += v.vsize
        rec = [v for v in order if v.isrec]
        for v in rec:
            v.begin = offset
            offset += v.vsize
        # A lone record variable is not padded between records
        self._recsize = rec[0].nbytes if len(rec) == 1 else \
            sum(v.vsize for v in rec)
        self._end = rec[0].begin if rec else offset
        self._fp.write(self._header(order))
        self._defining = False
        pending, self._pending = self._pending, []
        for name, index, arr in pending:
            self._write_data(self._vars[name], index, arr)

    # -- attributes ------------------------------------------------------
    def write_attribute(self, value: Any, attr: str,
                        var: Optional[str] = None):
        self._check_defining(f"attribute {attr!r}")
        attrs = self._attrs if var is None else self._vars[var].attrs
        attrs[attr] = _attr_value(value)

    def write_units(self, units: str, var: str):
        self.write_attribute(units, "units", var)

    def write_long_name(self, long_name: str, var: str):
        self.write_attribute(long_name, "long_name", var)

    def write_comment(self, comment: str, var: str):
        self.write_attribute(comment, "comment", var)

    def append_history(self, argv: Sequence[str],
                       existing: Optional[str] = None):
        """Append 'timestamp: command line' to the global history attribute
        (ref OutputDataFile.cpp:1005-1048)."""
        from ..config import command_line_string
        stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S %z").strip()
        entry = f"{stamp}: {command_line_string(argv)}"
        prev = existing
        if prev is None and "history" in self._attrs:
            prev = _decode(self._attrs["history"])
        history = f"{prev}\n{entry}" if prev else entry
        self.write_attribute(history, "history")

    def close(self):
        if self._fp.closed:
            return
        try:
            self.end_define()
            # The record count, then the full length (unwritten data read
            # as zeros)
            self._fp.seek(4)
            self._fp.write(struct.pack(">i", self._numrecs))
            self._fp.truncate(max(self._fp.seek(0, os.SEEK_END),
                                  self._end + self._numrecs * self._recsize))
        finally:
            self._fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_standard_attributes(writer: NcWriter, title: str):
    """Write title/institution/conventions globals
    (ref src/ecckd/write_standard_attributes.h)."""
    writer.write_attribute("CF-1.7", "Conventions")
    writer.write_attribute(title, "title")
    writer.write_attribute("ecckd_tpu gas-optics toolkit", "source")
