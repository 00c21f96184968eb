"""The native I/O fast paths of the port (port of ekpnp/io/native.py):
the tecplot body, the reference-ASCII table and its parser, in C++
(csrc/ekio.cpp), called through ctypes.

`g++ -O3 -shared` builds the source of this checkout at first use into
`ekpnp_torch/_build/`, under a key from a hash of the source and flags
(a temporary file, then `os.replace`, so processes that build at once do
not see a half-written library).  A failed build raises with g++'s
output: there is no quiet fallback to Python.  The plain Python
formatters (`format_tecplot_plain`, `format_table_plain`) are the
reference the tests hold the library to, byte for byte.

ctypes releases the interpreter lock for each call, so a writer thread
formats while the main thread launches work.
"""
from __future__ import annotations

import ctypes
import hashlib
import io
import os
import subprocess
import tempfile

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "ekio.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_i64 = ctypes.c_int64
_dp = ctypes.POINTER(ctypes.c_double)
_dpp = ctypes.POINTER(_dp)
_lib = None

# reference row formats: tecplot 8 '%g' + 6 '%10.6f' columns
# (LBM.cu:2555-2562); data_end.dat all '%10.6f' (LBM.cu:2613-2624)
TECPLOT_ROW = ("%g %g %g %g %g %g %g %g %10.6f %10.6f %10.6f %10.6f "
               "%10.6f %10.6f\n")


def library_path() -> str:
    with open(SOURCE, "rb") as fh:
        key = hashlib.sha256(fh.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"ekio_{key.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/ekio.cpp unless this source's build exists; returns the
    library's path.  Raises with g++'s output on failure."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, SOURCE],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                               f"{SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _load():
    """The library, built and loaded at first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    lib.ekio_format_tecplot.restype = ctypes.c_void_p
    lib.ekio_format_tecplot.argtypes = [_dpp, _i64, ctypes.POINTER(_i64)]
    lib.ekio_format_table.restype = ctypes.c_void_p
    lib.ekio_format_table.argtypes = [_dpp, _i64, _i64, ctypes.POINTER(_i64)]
    lib.ekio_parse_floats.restype = _i64
    lib.ekio_parse_floats.argtypes = [ctypes.c_char_p, _i64, _dp, _i64]
    lib.ekio_free.restype = None
    lib.ekio_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _columns(cols):
    """Contiguous float64 columns of equal length (a 2-D table is split
    into its columns)."""
    if isinstance(cols, np.ndarray) and cols.ndim == 2:
        cols = [cols[:, j] for j in range(cols.shape[1])]
    arrs = [np.ascontiguousarray(np.asarray(c, np.float64).ravel())
            for c in cols]
    if len({a.size for a in arrs}) > 1:
        raise ValueError("columns of unequal length")
    return arrs


def _call(fn, arrs, *extra, sink=None):
    """fn(column pointers, n, *extra, &length) -> malloc'd text.  Returns
    the text as a str, or with `sink` hands sink() a view of the C buffer
    (no copy: a zone at 256^3 is 2.4 GB) and returns None.  The column
    arrays stay referenced until the call returns."""
    lib = _load()
    ptrs = (_dp * len(arrs))(*[a.ctypes.data_as(_dp) for a in arrs])
    length = _i64()
    ptr = fn(ptrs, arrs[0].size if arrs else 0, *extra, ctypes.byref(length))
    if not ptr:
        raise MemoryError(fn.__name__)
    try:
        # a char array over the buffer: ctypes.string_at takes a C int
        # length and fails above 2 GiB
        buf = (ctypes.c_char * length.value).from_address(ptr)
        if sink is None:
            return buf.raw.decode("ascii")
        sink(memoryview(buf).cast("B"))
        return None
    finally:
        lib.ekio_free(ptr)


def format_tecplot(cols) -> str:
    """14 flat float64 columns -> the reference tecplot body, one row a
    node."""
    return _call(_load().ekio_format_tecplot, _tecplot_columns(cols))


def _tecplot_columns(cols):
    arrs = _columns(cols)
    if len(arrs) != 14:
        raise ValueError(f"tecplot rows have 14 columns, got {len(arrs)}")
    return arrs


def format_table(cols) -> str:
    """Columns (or an (n, ncols) table) -> all-'%10.6f' rows, the
    data_end.dat layout."""
    arrs = _columns(cols)
    return _call(_load().ekio_format_table, arrs, len(arrs))


def write_tecplot(fout, cols) -> None:
    """`format_tecplot(cols)` written to the text file `fout`: from the C
    buffer straight into its binary buffer where it has one."""
    if not hasattr(fout, "buffer"):
        fout.write(format_tecplot(cols))
        return
    fout.flush()
    _call(_load().ekio_format_tecplot, _tecplot_columns(cols),
          sink=fout.buffer.write)


def write_table(path: str, cols) -> None:
    """`format_table(cols)` written to the file `path`, from the C buffer."""
    arrs = _columns(cols)
    with open(path, "wb") as f:
        _call(_load().ekio_format_table, arrs, len(arrs), sink=f.write)


def parse_table(text, rows: int, cols: int) -> np.ndarray:
    """A whitespace-separated float table (str or bytes) -> (rows, cols)
    float64; raises unless it holds exactly rows x cols values."""
    raw = text if isinstance(text, bytes) else text.encode("ascii")
    # one slot more than wanted, so that a longer table shows
    out = np.empty(rows * cols + 1, dtype=np.float64)
    k = _load().ekio_parse_floats(raw, len(raw), out.ctypes.data_as(_dp),
                                  out.size)
    if k != rows * cols:
        raise ValueError(f"expected {rows * cols} values, parsed {k}")
    return out[:-1].reshape(rows, cols)


def format_tecplot_plain(cols) -> str:
    """The plain version of `format_tecplot` (Python's printf)."""
    data = np.stack(_columns(cols), axis=1)
    buf = io.StringIO()
    for row in data:
        buf.write(TECPLOT_ROW % tuple(row))
    return buf.getvalue()


def format_table_plain(cols) -> str:
    """The plain version of `format_table`."""
    data = np.stack(_columns(cols), axis=1)
    return "".join(" ".join(f"{v:10.6f}" for v in row) + "\n" for row in data)
