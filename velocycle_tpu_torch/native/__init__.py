"""Native (C++) ingest for the port, with numpy fallbacks.

Port of the ctypes loader of `velocycle_tpu/native/__init__.py` over the
port's own copy of its source, `native/ingest.cpp`: sparse densification
into the model's (genes, cells) layout, MatrixMarket parsing, size factors
and one-hot designs, multi-threaded and bound through a plain C interface.

The library is built with ``g++`` at first use into
``build/velocycle_tpu_torch/`` (where `ops/cuda_build.py` puts the CUDA
libraries; git-ignored), named by a hash of the source and the compiler
flags, and never next to the source.  Without a C++ compiler every entry
point computes the same result with numpy/scipy; `available()` says which
route runs and `build_error()` why the native one does not.  Nothing here
runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from ..ops.cuda_build import BUILD_DIR

__all__ = [
    "available",
    "build_error",
    "build_seconds",
    "csr_to_dense",
    "size_factors",
    "one_hot",
    "read_mtx",
]

SRC = Path(__file__).resolve().with_name("ingest.cpp")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_LOCK = threading.Lock()
_STATE = {"lib": None, "tried": False, "seconds": None, "error": None}


def _target() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libvct_ingest_{h.hexdigest()[:12]}.so"


def _compile():
    """(path of the built library, seconds spent building it); builds it
    unless it exists.  No -march=native: a checkout (with its build
    directory) may be copied to another machine."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise OSError("no C++ compiler (CXX, g++ on PATH)")
    target = _target()
    if target.exists():
        return target, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)], check=True,
                       capture_output=True, text=True, timeout=300)
    except subprocess.CalledProcessError as e:
        raise OSError(f"{cxx} failed on {SRC.name}: {e.stderr}") from e
    os.replace(tmp, target)   # atomic: a concurrent build sees all or nothing
    return target, time.perf_counter() - t0


def _lib():
    with _LOCK:
        if _STATE["tried"]:
            return _STATE["lib"]
        _STATE["tried"] = True
        try:
            path, seconds = _compile()
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError) as e:
            _STATE["error"] = str(e)
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i8p = ctypes.POINTER(ctypes.c_int8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.vct_csr_to_dense.argtypes = [
            i64p, i32p, f32p, ctypes.c_int64, ctypes.c_int64, f32p, ctypes.c_int,
        ]
        lib.vct_csr_to_dense_t.argtypes = lib.vct_csr_to_dense.argtypes
        lib.vct_size_factors.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int64, f32p, f32p, ctypes.c_int,
        ]
        lib.vct_one_hot.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int64, i8p, ctypes.c_int,
        ]
        lib.vct_mtx_header.argtypes = [ctypes.c_char_p, i64p, i64p, i64p]
        lib.vct_mtx_read.argtypes = [
            ctypes.c_char_p, i32p, i32p, f32p, ctypes.c_int64, ctypes.c_int,
        ]
        lib.vct_version.argtypes = []
        for fn in (
            lib.vct_csr_to_dense, lib.vct_csr_to_dense_t, lib.vct_size_factors,
            lib.vct_one_hot, lib.vct_mtx_header, lib.vct_mtx_read,
            lib.vct_version,
        ):
            fn.restype = ctypes.c_int
        _STATE.update(lib=lib, seconds=seconds)
        return lib


def available() -> bool:
    """True when the native library built (or was built) and loaded."""
    return _lib() is not None


def build_seconds():
    """Seconds this process spent building the library (0.0 when it was
    already built), None when it is not available."""
    _lib()
    return _STATE["seconds"]


def build_error():
    """Why the native library is not available (None when it is)."""
    _lib()
    return _STATE["error"]


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def csr_to_dense(matrix, transpose=False, nthreads=0):
    """Dense float32 array from a scipy CSR/CSC/COO (cells x genes) matrix.

    ``transpose=True`` writes the (genes x cells) model layout directly,
    without a separate host transpose pass."""
    import scipy.sparse as sp

    if not sp.issparse(matrix):
        dense = np.ascontiguousarray(np.asarray(matrix, np.float32))
        return dense.T.copy() if transpose else dense
    csr = matrix.tocsr()
    lib = _lib()
    n_rows, n_cols = csr.shape
    if lib is None:
        dense = np.asarray(csr.todense(), np.float32)
        return np.ascontiguousarray(dense.T) if transpose else dense
    indptr = np.ascontiguousarray(csr.indptr, np.int64)
    indices = np.ascontiguousarray(csr.indices, np.int32)
    data = np.ascontiguousarray(csr.data, np.float32)
    shape = (n_cols, n_rows) if transpose else (n_rows, n_cols)
    out = np.empty(shape, np.float32)
    fn = lib.vct_csr_to_dense_t if transpose else lib.vct_csr_to_dense
    rc = fn(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(data, ctypes.c_float), n_rows, n_cols,
        _ptr(out, ctypes.c_float), nthreads,
    )
    if rc != 0:
        raise RuntimeError(f"vct_csr_to_dense failed with code {rc}")
    return out


def size_factors(dense, nthreads=0):
    """(totals, count_factor) per cell from a dense (Nc, Ng) count matrix:
    ``count_factor_c = log(UMI_c / mean UMI)``."""
    dense = np.ascontiguousarray(dense, np.float32)
    n_cells, n_genes = dense.shape
    lib = _lib()
    if lib is None:
        totals = dense.sum(1)
        return totals, np.log(totals / totals.mean()).astype(np.float32)
    totals = np.empty((n_cells,), np.float32)
    cf = np.empty((n_cells,), np.float32)
    rc = lib.vct_size_factors(
        _ptr(dense, ctypes.c_float), n_cells, n_genes,
        _ptr(totals, ctypes.c_float), _ptr(cf, ctypes.c_float), nthreads,
    )
    if rc != 0:
        raise RuntimeError(f"vct_size_factors failed with code {rc}")
    return totals, cf


def one_hot(codes, k=None, nthreads=0):
    """(n, k) int8 one-hot design from integer category codes in [0, k)."""
    codes = np.ascontiguousarray(codes, np.int32)
    if k is None:
        k = int(codes.max()) + 1 if codes.size else 0
    lib = _lib()
    if lib is None:
        return (codes[:, None] == np.arange(k)[None, :]).astype(np.int8)
    out = np.empty((codes.shape[0], k), np.int8)
    rc = lib.vct_one_hot(
        _ptr(codes, ctypes.c_int32), codes.shape[0], k,
        _ptr(out, ctypes.c_int8), nthreads,
    )
    if rc != 0:
        raise RuntimeError(f"vct_one_hot failed with code {rc}")
    return out


def read_mtx(path, nthreads=0):
    """scipy COO matrix from a MatrixMarket coordinate file (the 10x /
    Stereo-seq distribution format), parsed chunk-parallel natively."""
    import scipy.sparse as sp

    lib = _lib()
    if lib is None:
        import scipy.io as sio

        return sio.mmread(str(path)).tocoo()
    n_rows = ctypes.c_int64()
    n_cols = ctypes.c_int64()
    nnz = ctypes.c_int64()
    rc = lib.vct_mtx_header(
        str(path).encode(), ctypes.byref(n_rows), ctypes.byref(n_cols),
        ctypes.byref(nnz),
    )
    if rc != 0:
        raise RuntimeError(f"vct_mtx_header failed with code {rc} on {path}")
    rows = np.empty((nnz.value,), np.int32)
    cols = np.empty((nnz.value,), np.int32)
    vals = np.empty((nnz.value,), np.float32)
    rc = lib.vct_mtx_read(
        str(path).encode(), _ptr(rows, ctypes.c_int32),
        _ptr(cols, ctypes.c_int32), _ptr(vals, ctypes.c_float),
        nnz.value, nthreads,
    )
    if rc != 0:
        raise RuntimeError(f"vct_mtx_read failed with code {rc} on {path}")
    return sp.coo_matrix(
        (vals, (rows, cols)), shape=(n_rows.value, n_cols.value)
    )
