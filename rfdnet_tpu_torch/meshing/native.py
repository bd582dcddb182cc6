"""ctypes bindings of the host marching cubes (`csrc/meshing.cpp`).

Counterpart of the marching-cubes part of `rfdnet_tpu/meshing/native.py`.
The library is built with `g++` at first use by `ops/_native.py`; a missing
compiler or a failed build raises. Every extractor returns vertices (V, 3)
float64 in grid-index space and triangles (T, 3) int32.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..ops import _native

_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_MESH_OUT = [ctypes.POINTER(_F64P), ctypes.POINTER(_I32P), _I32P, _I32P]


@functools.cache
def get_lib() -> ctypes.CDLL:
    lib = _native.load("meshing")
    lib.mc_extract.restype = ctypes.c_int
    lib.mc_extract.argtypes = [
        _F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        *_MESH_OUT]
    lib.mc_extract_padded.restype = ctypes.c_int
    lib.mc_extract_padded.argtypes = [
        _F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, *_MESH_OUT]
    lib.mesh_free.restype = None
    lib.mesh_free.argtypes = [_F64P, _I32P]
    lib.mc_extract_batch.restype = ctypes.c_void_p
    lib.mc_extract_batch.argtypes = [
        _F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, _U8P, _I32P, _I32P]
    lib.batch_mesh_get.restype = None
    lib.batch_mesh_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(_F64P),
        ctypes.POINTER(_I32P)]
    lib.batch_result_free.restype = None
    lib.batch_result_free.argtypes = [ctypes.c_void_p]
    lib.mesh_threads.restype = ctypes.c_int
    lib.mesh_threads.argtypes = [ctypes.c_int]
    return lib


def _grid(grid, ndim: int) -> np.ndarray:
    grid = np.ascontiguousarray(grid, dtype=np.float32)
    if grid.ndim != ndim or 0 in grid.shape:
        raise ValueError(f"grid shape {grid.shape}: expected {ndim} non-empty"
                         " dimensions")
    return grid


def _extract(fn, grid: np.ndarray, *scalars):
    """Call a single-grid extractor and copy its mesh out of native memory."""
    lib = get_lib()
    vp, tp = _F64P(), _I32P()
    nv, nt = ctypes.c_int32(), ctypes.c_int32()
    fn(grid.ctypes.data_as(_F32P), *grid.shape, *scalars,
       ctypes.byref(vp), ctypes.byref(tp), ctypes.byref(nv), ctypes.byref(nt))
    try:
        verts = np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy()
        tris = np.ctypeslib.as_array(tp, shape=(nt.value, 3)).copy()
    finally:
        lib.mesh_free(vp, tp)
    return verts, tris


def marching_cubes(grid: np.ndarray, iso: float):
    """Marching cubes over a dense (nx, ny, nz) grid, with case tables
    whose per-face ambiguity resolution is the same for the two cubes that
    share a face (watertight)."""
    return _extract(get_lib().mc_extract, _grid(grid, 3), ctypes.c_float(iso))


def marching_cubes_padded(grid: np.ndarray, iso: float,
                          pad_val: float = -1e6):
    """Single-grid marching cubes with one boundary layer of `pad_val`
    applied inside the library (no padded copy). Vertices in PADDED index
    space: identical to marching_cubes(np.pad(grid, 1, ...), iso)."""
    return _extract(get_lib().mc_extract_padded, _grid(grid, 3),
                    ctypes.c_float(iso), ctypes.c_float(pad_val))


def mesh_threads(njobs: int) -> int:
    """Worker threads the batch extractor would use for `njobs` grids
    (RFDNET_MESH_THREADS or the hardware's concurrency, at most njobs)."""
    return int(get_lib().mesh_threads(int(njobs)))


def marching_cubes_batch(grids: np.ndarray, iso: float,
                         pad_val: float = -1e6, valid=None):
    """Padded marching cubes over (n, nx, ny, nz) grids in one native call,
    the grids spread over the library's worker threads. Returns a list of
    (verts, tris) in PADDED index space; empty pairs for invalid slots."""
    lib = get_lib()
    grids = _grid(grids, 4)
    n = grids.shape[0]
    vmask, vptr = None, _U8P()
    if valid is not None:
        vmask = np.ascontiguousarray(
            np.asarray(valid).reshape(-1).astype(np.uint8))
        if vmask.shape[0] != n:
            raise ValueError(f"valid has {vmask.shape[0]} flags for {n} grids")
        vptr = vmask.ctypes.data_as(_U8P)
    nv_per = np.zeros(n, np.int32)
    nt_per = np.zeros(n, np.int32)
    handle = lib.mc_extract_batch(
        grids.ctypes.data_as(_F32P), *grids.shape, ctypes.c_float(iso),
        ctypes.c_float(pad_val), vptr, nv_per.ctypes.data_as(_I32P),
        nt_per.ctypes.data_as(_I32P))
    out = []
    vp, tp = _F64P(), _I32P()
    try:
        for i in range(n):
            nv, nt = int(nv_per[i]), int(nt_per[i])
            if nv == 0:
                out.append((np.zeros((0, 3)), np.zeros((0, 3), np.int32)))
                continue
            lib.batch_mesh_get(handle, i, ctypes.byref(vp), ctypes.byref(tp))
            out.append((np.ctypeslib.as_array(vp, shape=(nv, 3)).copy(),
                        np.ctypeslib.as_array(tp, shape=(nt, 3)).copy()))
    finally:
        lib.batch_result_free(handle)
    return out
