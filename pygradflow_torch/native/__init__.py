"""Native (C++) runtime components, bound with ctypes (counterpart of
``pygradflow_tpu/native``).

The MPS reader ``mps_reader.cpp`` (the port's own copy of the source) is
compiled with ``g++`` at first use into
``pygradflow_torch/_build/mps-<hash>/libmpsreader.so``, the hash covering
the source and the flags, and loaded from there.  Where no compiler is
found the reader is not ``available()`` and ``parse_mps`` reads with the
Python parser.  Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "mps_reader.cpp"
_BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_build_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_ROOT / f"mps-{digest}" / "libmpsreader.so"


def _build(lib_path: Path):
    """Compile into a temporary file beside the library and move it into
    place, so that processes building at once never load a partial file."""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib_path.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, str(_SRC)], check=True, capture_output=True)
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except Exception:
            _build_failed = True
            return None

        lib.mps_parse.restype = ctypes.c_void_p
        lib.mps_parse.argtypes = [ctypes.c_char_p]
        lib.mps_free.argtypes = [ctypes.c_void_p]
        for fn in ["mps_num_rows", "mps_num_cols", "mps_num_entries", "mps_num_obj_entries"]:
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.mps_obj_offset.restype = ctypes.c_double
        lib.mps_obj_offset.argtypes = [ctypes.c_void_p]
        lib.mps_name.restype = ctypes.c_char_p
        lib.mps_name.argtypes = [ctypes.c_void_p]

        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.mps_entries.argtypes = [ctypes.c_void_p, i64p, i64p, f64p]
        lib.mps_obj.argtypes = [ctypes.c_void_p, i64p, f64p]
        lib.mps_cons_bounds.argtypes = [ctypes.c_void_p, f64p, f64p]
        lib.mps_var_bounds.argtypes = [ctypes.c_void_p, f64p, f64p]

        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def parse_mps_native(path: str):
    """Parse an MPS file with the C++ reader; returns the same ``MPSData``
    as ``runners.mps.parse_mps_py``, or None when the library is not
    available."""
    lib = _load()
    if lib is None:
        return None

    handle = lib.mps_parse(path.encode())
    if not handle:
        raise FileNotFoundError(path)

    try:
        m = lib.mps_num_rows(handle)
        n = lib.mps_num_cols(handle)
        nnz = lib.mps_num_entries(handle)
        obj_nnz = lib.mps_num_obj_entries(handle)

        rows = np.empty(nnz, dtype=np.int64)
        cols = np.empty(nnz, dtype=np.int64)
        vals = np.empty(nnz, dtype=np.float64)
        lib.mps_entries(handle, rows, cols, vals)

        obj_cols = np.empty(obj_nnz, dtype=np.int64)
        obj_vals = np.empty(obj_nnz, dtype=np.float64)
        lib.mps_obj(handle, obj_cols, obj_vals)

        cons_lb = np.empty(m, dtype=np.float64)
        cons_ub = np.empty(m, dtype=np.float64)
        lib.mps_cons_bounds(handle, cons_lb, cons_ub)

        var_lb = np.empty(n, dtype=np.float64)
        var_ub = np.empty(n, dtype=np.float64)
        lib.mps_var_bounds(handle, var_lb, var_ub)

        name = lib.mps_name(handle).decode()
        obj_offset = lib.mps_obj_offset(handle)
    finally:
        lib.mps_free(handle)

    A = np.zeros((m, n))
    np.add.at(A, (rows, cols), vals)

    c = np.zeros(n)
    np.add.at(c, obj_cols, obj_vals)

    from ..runners.mps import MPSData

    return MPSData(
        name=name,
        c=c,
        A=A,
        cons_lb=cons_lb,
        cons_ub=cons_ub,
        var_lb=var_lb,
        var_ub=var_ub,
        obj_offset=obj_offset,
        col_names=[],
        row_names=[],
    )
