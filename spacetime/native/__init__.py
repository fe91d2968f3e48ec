"""ctypes loader for the native C++ assembly core (see assembler.cpp).

Compiles the shared library on first use with g++ (cached next to the
source); falls back to the NumPy assembler transparently if no compiler is
available. Enable as the default assembly engine with
``SPACETIME_NATIVE=1`` or by passing ``engine="native"``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "assembler.cpp")
_LIB = os.path.join(_HERE, "_assembler.so")
_lib = None
_load_error: str | None = None


def _build() -> None:
    cmd = [
        "g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
        _SRC, "-o", _LIB,
    ]
    subprocess.run(cmd, check=True, capture_output=True)


def load():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            _build()
        lib = ctypes.CDLL(_LIB)
        for name in ("assemble_p1_tri", "assemble_p1_tet"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double),  # kv (nullable)
                ctypes.POINTER(ctypes.c_double),  # cv (nullable)
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
            ]
        agf = lib.sa_aggregate
        agf.restype = ctypes.c_int64
        agf.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
    except Exception as e:  # missing compiler, build failure, ...
        _load_error = f"{type(e).__name__}: {e}"
        _lib = None
    return _lib


def available() -> bool:
    return load() is not None


def assemble_p1_native(
    vertices: np.ndarray,
    elements: np.ndarray,
    kv: np.ndarray | None = None,
    cv: np.ndarray | None = None,
):
    """Per-element (rows, cols, mass, stiff) triplets via the C++ core.

    ``kv``/``cv``: optional (ne,) per-element diffusion/reaction values at
    element centroids — the weighted spatial form (stiff carries
    κ·K_el + c·M_el; mass stays the plain mass matrix)."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"native assembler unavailable: {_load_error}")
    dim = vertices.shape[1]
    nloc = dim + 1
    ne = elements.shape[0]
    V = np.ascontiguousarray(vertices, np.float64)
    T = np.ascontiguousarray(elements, np.int32)
    k = ne * nloc * nloc
    rows = np.empty(k, np.int32)
    cols = np.empty(k, np.int32)
    mass = np.empty(k, np.float64)
    stiff = np.empty(k, np.float64)
    fn = lib.assemble_p1_tri if dim == 2 else lib.assemble_p1_tet
    c_d = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    c_i = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    # Keep the contiguous copies referenced through the call — a pointer
    # into an unnamed temporary would dangle once it is collected.
    kv_a = None if kv is None else np.ascontiguousarray(kv, np.float64)
    cv_a = None if cv is None else np.ascontiguousarray(cv, np.float64)
    kv_c = None if kv_a is None else c_d(kv_a)
    cv_c = None if cv_a is None else c_d(cv_a)
    fn(c_d(V), c_i(T), ctypes.c_int64(ne), kv_c, cv_c,
       c_i(rows), c_i(cols), c_d(mass), c_d(stiff))
    return rows, cols, mass, stiff


def sa_aggregate_native(indptr, indices, agg) -> int | None:
    """Greedy SA aggregation passes via the C++ core — bit-exact mirror of
    the Python loops in ops/multigrid.sa_prolongator (same visit order and
    tie-breaks, verified in tests/test_native.py). ``agg`` is the (n,)
    int64 work array pre-filled with -1, modified in place; returns the
    aggregate count, or None when the native library is unavailable (the
    caller then runs the Python reference)."""
    lib = load()
    if lib is None:
        return None
    if np.asarray(indptr)[-1] > np.iinfo(np.int32).max:
        # The C ABI takes int32 CSR indices; a >=2^31-nnz strength graph
        # would wrap negative in the cast below and the C++ loops would
        # read out of bounds. Fall back to the bit-identical Python path.
        return None
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    if agg.dtype != np.int64 or not agg.flags.c_contiguous:
        raise ValueError("agg must be a contiguous int64 array")
    c_i = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    return int(lib.sa_aggregate(
        c_i(indptr), c_i(indices), ctypes.c_int64(agg.shape[0]),
        agg.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    ))
