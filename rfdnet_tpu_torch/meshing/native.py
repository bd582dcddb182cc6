"""ctypes bindings of the host meshing library (`csrc/meshing.cpp`).

Counterpart of `rfdnet_tpu/meshing/native.py`: marching cubes and
marching tetrahedra over dense grids, the QEM simplification (a library
of its own, `csrc/simplify.cpp`), the MISE octree (`MiseNative`), marching cubes straight from the
device octree's sparse outputs (`mise_marching_cubes(_batch)`), the
surface voxelizer and interior fill of the mesh mAP, the ray-parity
containment test `points_in_mesh` and the KD-tree (`KDTree`,
`kdtree_chamfer`; a library of its own, `csrc/kdtree.cpp`) of the offline
preparation. The libraries are built with `g++` at first use by
`ops/_native.py`; a missing compiler or a failed build raises. Every
extractor returns vertices (V, 3) float64 in grid-index space and
triangles (T, 3) int32.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..ops import _native

_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
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
    lib.mt_extract.restype = ctypes.c_int
    lib.mt_extract.argtypes = [
        _F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        *_MESH_OUT]
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
    lib.mise_mc_extract.restype = ctypes.c_int
    lib.mise_mc_extract.argtypes = [
        _F32P, ctypes.c_int, ctypes.c_int, _I32P, _F32P, _I32P,
        ctypes.c_float, ctypes.c_float, *_MESH_OUT]
    lib.mise_mc_extract_batch.restype = ctypes.c_void_p
    lib.mise_mc_extract_batch.argtypes = [
        _F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _I32P, _F32P, _I32P,
        ctypes.c_float, ctypes.c_float, _U8P, _I32P, _I32P]
    lib.mise_create.restype = ctypes.c_void_p
    lib.mise_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_double]
    lib.mise_destroy.restype = None
    lib.mise_destroy.argtypes = [ctypes.c_void_p]
    lib.mise_query.restype = ctypes.c_int
    lib.mise_query.argtypes = [ctypes.c_void_p, _I64P, ctypes.c_int]
    lib.mise_update.restype = None
    lib.mise_update.argtypes = [ctypes.c_void_p, _I64P, _F64P, ctypes.c_int]
    lib.mise_to_dense.restype = None
    lib.mise_to_dense.argtypes = [ctypes.c_void_p, _F32P]
    lib.voxelize_surface.restype = None
    lib.voxelize_surface.argtypes = [
        _F64P, ctypes.c_int, _I32P, ctypes.c_int, _F64P, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P]
    lib.fill_interior.restype = None
    lib.fill_interior.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P]
    lib.points_in_mesh.restype = None
    lib.points_in_mesh.argtypes = [
        _F64P, ctypes.c_int, _I32P, ctypes.c_int, _F64P, ctypes.c_int, _U8P]
    return lib


@functools.cache
def get_kdtree_lib() -> ctypes.CDLL:
    lib = _native.load("kdtree")
    lib.kdtree_build.restype = ctypes.c_void_p
    lib.kdtree_build.argtypes = [_F64P, ctypes.c_int]
    lib.kdtree_query.restype = None
    lib.kdtree_query.argtypes = [
        ctypes.c_void_p, _F64P, ctypes.c_int, ctypes.c_int, _F64P, _I32P]
    lib.kdtree_free.restype = None
    lib.kdtree_free.argtypes = [ctypes.c_void_p]
    return lib


@functools.cache
def get_simplify_lib() -> ctypes.CDLL:
    lib = _native.load("simplify")
    lib.simplify_qem.restype = ctypes.c_int
    lib.simplify_qem.argtypes = [
        _F64P, ctypes.c_int, _I32P, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, *_MESH_OUT]
    lib.prep_free.restype = None
    lib.prep_free.argtypes = [_F64P, _I32P]
    return lib


def _grid(grid, ndim: int) -> np.ndarray:
    grid = np.ascontiguousarray(grid, dtype=np.float32)
    if grid.ndim != ndim or 0 in grid.shape:
        raise ValueError(f"grid shape {grid.shape}: expected {ndim} non-empty"
                         " dimensions")
    return grid


def _extract(fn, grid: np.ndarray, *scalars):
    """Call a single-grid extractor and copy its mesh out of native memory."""
    return _mesh_call(fn, grid.ctypes.data_as(_F32P), *grid.shape, *scalars)


def _mesh_call(fn, *args, free=None):
    """fn(*args, &verts, &tris, &nv, &nt), its mesh copied out of native
    memory, which `free` (the meshing library's `mesh_free` by default)
    then releases."""
    free = free or get_lib().mesh_free
    vp, tp = _F64P(), _I32P()
    nv, nt = ctypes.c_int32(), ctypes.c_int32()
    fn(*args,
       ctypes.byref(vp), ctypes.byref(tp), ctypes.byref(nv), ctypes.byref(nt))
    try:
        verts = np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy()
        tris = np.ctypeslib.as_array(tp, shape=(nt.value, 3)).copy()
    finally:
        free(vp, tp)
    return verts, tris


def marching_cubes(grid: np.ndarray, iso: float):
    """Marching cubes over a dense (nx, ny, nz) grid, with case tables
    whose per-face ambiguity resolution is the same for the two cubes that
    share a face (watertight)."""
    return _extract(get_lib().mc_extract, _grid(grid, 3), ctypes.c_float(iso))


def marching_tetrahedra(grid: np.ndarray, iso: float):
    """Iso-surface of a dense (nx, ny, nz) grid by marching tetrahedra (six
    tetrahedra a cube around its main diagonal; about three times the
    triangles of marching cubes for the same field)."""
    return _extract(get_lib().mt_extract, _grid(grid, 3), ctypes.c_float(iso))


def _mesh_arrays(verts, tris):
    """verts (V, 3) float64 and tris (T, 3) int32, contiguous and checked."""
    verts = np.ascontiguousarray(verts, dtype=np.float64)
    tris = np.ascontiguousarray(tris, dtype=np.int32)
    if verts.ndim != 2 or verts.shape[1] != 3 or tris.ndim != 2 or (
            tris.shape[1] != 3):
        raise ValueError(f"verts {verts.shape}, tris {tris.shape}: expected "
                         "(V, 3) and (T, 3)")
    if len(tris) and (tris.min() < 0 or tris.max() >= len(verts)):
        raise ValueError("tris index outside verts")
    return verts, tris


def simplify_mesh(verts, tris, target_faces: int,
                  aggressiveness: float = 7.0):
    """Quadric-error-metric simplification of a mesh (V, 3) / (T, 3) toward
    `target_faces` triangles; a higher `aggressiveness` lets each pass
    collapse edges of larger error. Returns (verts (V', 3) float64, tris
    (T', 3) int32), vertices renumbered in order of first use."""
    lib = get_simplify_lib()
    verts, tris = _mesh_arrays(verts, tris)
    return _mesh_call(
        lib.simplify_qem, verts.ctypes.data_as(_F64P), len(verts),
        tris.ctypes.data_as(_I32P), len(tris), int(target_faces),
        ctypes.c_double(aggressiveness), free=lib.prep_free)


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
    vmask, vptr = _valid_mask(valid, n)
    nv_per = np.zeros(n, np.int32)
    nt_per = np.zeros(n, np.int32)
    handle = lib.mc_extract_batch(
        grids.ctypes.data_as(_F32P), *grids.shape, ctypes.c_float(iso),
        ctypes.c_float(pad_val), vptr, nv_per.ctypes.data_as(_I32P),
        nt_per.ctypes.data_as(_I32P))
    return _split_batch(lib, handle, nv_per, nt_per)


def _split_batch(lib, handle, nv_per, nt_per):
    """Copy each mesh out of a batch result, then free the result."""
    out = []
    vp, tp = _F64P(), _I32P()
    try:
        for i in range(len(nv_per)):
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


def _valid_mask(valid, n: int):
    """(mask array or None, pointer) of `valid` flags for n proposals."""
    if valid is None:
        return None, _U8P()
    vmask = np.ascontiguousarray(np.asarray(valid).reshape(-1).astype(np.uint8))
    if vmask.shape[0] != n:
        raise ValueError(f"valid has {vmask.shape[0]} flags for {n} grids")
    return vmask, vmask.ctypes.data_as(_U8P)


def _mise_levels(level_idx, level_vals):
    """(idx (M,) int32, vals (M, 27) f32) of per-level lists, concatenated."""
    idx = np.ascontiguousarray(np.concatenate(
        [np.asarray(i, np.int32).ravel() for i in level_idx])
        if len(level_idx) else np.zeros(0, np.int32), dtype=np.int32)
    vals = np.ascontiguousarray(np.concatenate(
        [np.asarray(v, np.float32).reshape(-1, 27) for v in level_vals])
        if len(level_vals) else np.zeros((0, 27), np.float32),
        dtype=np.float32)
    return idx, vals


def mise_marching_cubes(lvl0: np.ndarray, resolution_0: int,
                        upsampling_steps: int, level_idx, level_vals,
                        iso: float, pad_val: float = -1e6):
    """Marching cubes straight from ONE proposal's octree outputs: the
    (res0+1)^3 level-0 lattice, and per refinement level the refined
    voxels' linear ids (ascending) and their (m, 27) child-lattice values
    (`mise_device` order). The library rebuilds the lattice with the
    ancestor fill and scans every padded cell, so the output is identical
    to `marching_cubes(np.pad(reconstruct_dense(...), 1, constant_values=
    pad_val), iso)`. Vertices in PADDED index space."""
    lvl0 = _grid(lvl0, 3)
    counts = np.array([len(i) for i in level_idx], dtype=np.int32)
    idx, vals = _mise_levels(level_idx, level_vals)
    return _mesh_call(get_lib().mise_mc_extract, lvl0.ctypes.data_as(_F32P),
                      int(resolution_0), int(upsampling_steps),
                      idx.ctypes.data_as(_I32P), vals.ctypes.data_as(_F32P),
                      counts.ctypes.data_as(_I32P), ctypes.c_float(iso),
                      ctypes.c_float(pad_val))


def mise_marching_cubes_batch(lvl0s: np.ndarray, resolution_0: int,
                              upsampling_steps: int, idx: np.ndarray,
                              vals: np.ndarray, level_counts: np.ndarray,
                              iso: float, valid=None, pad_val: float = -1e6):
    """`mise_marching_cubes` over n proposals in one native call, spread
    over the library's worker threads. lvl0s (n, res0+1, res0+1, res0+1);
    level_counts (n, steps); idx (M,) and vals (M, 27) concatenated in
    (proposal, level) order. Returns a list of (verts, tris) in padded
    index space; empty pairs for invalid slots."""
    lib = get_lib()
    lvl0s = _grid(lvl0s, 4)
    n = lvl0s.shape[0]
    level_counts = np.ascontiguousarray(level_counts, dtype=np.int32)
    if level_counts.shape != (n, int(upsampling_steps)):
        raise ValueError(f"level_counts shape {level_counts.shape}")
    idx = np.ascontiguousarray(np.asarray(idx).reshape(-1), dtype=np.int32)
    vals = np.ascontiguousarray(np.asarray(vals).reshape(-1, 27),
                                dtype=np.float32)
    if len(idx) != len(vals) or len(idx) != int(level_counts.sum()):
        raise ValueError(f"{len(idx)} ids, {len(vals)} value rows and "
                         f"{int(level_counts.sum())} counted voxels")
    vmask, vptr = _valid_mask(valid, n)
    nv_per = np.zeros(n, np.int32)
    nt_per = np.zeros(n, np.int32)
    handle = lib.mise_mc_extract_batch(
        lvl0s.ctypes.data_as(_F32P), n, int(resolution_0),
        int(upsampling_steps), idx.ctypes.data_as(_I32P),
        vals.ctypes.data_as(_F32P), level_counts.ctypes.data_as(_I32P),
        ctypes.c_float(iso), ctypes.c_float(pad_val), vptr,
        nv_per.ctypes.data_as(_I32P), nt_per.ctypes.data_as(_I32P))
    return _split_batch(lib, handle, nv_per, nt_per)


def voxelize_surface(verts, tris, origin, voxel_size, dims) -> np.ndarray:
    """The cells of a `dims` grid (cell (i, j, k) spans origin + [i, i+1)
    * voxel_size, ...) that a triangle of the mesh overlaps, as uint8."""
    lib = get_lib()
    verts = np.ascontiguousarray(verts, dtype=np.float64)
    tris = np.ascontiguousarray(tris, dtype=np.int32)
    origin = np.ascontiguousarray(origin, dtype=np.float64)
    out = np.zeros(tuple(int(d) for d in dims), dtype=np.uint8)
    lib.voxelize_surface(
        verts.ctypes.data_as(_F64P), len(verts), tris.ctypes.data_as(_I32P),
        len(tris), origin.ctypes.data_as(_F64P), ctypes.c_double(voxel_size),
        *out.shape, out.ctypes.data_as(_U8P))
    return out


def fill_interior(surface: np.ndarray) -> np.ndarray:
    """The cells that neither lie on the surface nor connect to the grid's
    boundary through non-surface cells, as uint8."""
    lib = get_lib()
    surface = np.ascontiguousarray(surface, dtype=np.uint8)
    out = np.zeros_like(surface)
    lib.fill_interior(surface.ctypes.data_as(_U8P), *surface.shape,
                      out.ctypes.data_as(_U8P))
    return out


def points_in_mesh(verts, tris, points) -> np.ndarray:
    """Whether each of the (P, 3) points lies inside a watertight mesh, by
    the parity of a +z ray's crossings, as bool (P,)."""
    verts, tris = _mesh_arrays(verts, tris)
    points = np.ascontiguousarray(points, dtype=np.float64).reshape(-1, 3)
    out = np.zeros(len(points), dtype=np.uint8)
    get_lib().points_in_mesh(
        verts.ctypes.data_as(_F64P), len(verts), tris.ctypes.data_as(_I32P),
        len(tris), points.ctypes.data_as(_F64P), len(points),
        out.ctypes.data_as(_U8P))
    return out.astype(bool)


class KDTree:
    """3-D KD-tree over (n, 3) points with k-nearest-neighbour queries (the
    `pykdtree.KDTree` interface)."""

    def __init__(self, points: np.ndarray):
        self._lib = get_kdtree_lib()
        self._pts = np.ascontiguousarray(points, dtype=np.float64).reshape(
            -1, 3)
        self._handle = ctypes.c_void_p(self._lib.kdtree_build(
            self._pts.ctypes.data_as(_F64P), len(self._pts)))

    def query(self, queries: np.ndarray, k: int = 1):
        """(distances (nq, k) L2, indices (nq, k) int32) of each query's k
        nearest points, nearest first; squeezed to (nq,) at k = 1. Slots
        beyond the tree's size hold distance 1e150 and index -1."""
        if k < 1:
            raise ValueError(f"k = {k}")
        q = np.ascontiguousarray(queries, dtype=np.float64).reshape(-1, 3)
        d2 = np.zeros((len(q), k))
        idx = np.zeros((len(q), k), np.int32)
        self._lib.kdtree_query(self._handle, q.ctypes.data_as(_F64P), len(q),
                               k, d2.ctypes.data_as(_F64P),
                               idx.ctypes.data_as(_I32P))
        d = np.sqrt(d2)
        if k == 1:
            return d[:, 0], idx[:, 0]
        return d, idx

    def __del__(self):
        h = getattr(self, "_handle", None)
        self._handle = None
        if h:
            self._lib.kdtree_free(h)


def kdtree_chamfer(points1: np.ndarray, points2: np.ndarray) -> float:
    """Chamfer distance through KD-trees: the mean squared distance to the
    nearest point of the other set, summed over both directions."""
    d12, _ = KDTree(points2).query(points1, 1)
    d21, _ = KDTree(points1).query(points2, 1)
    return float((d12 ** 2).mean() + (d21 ** 2).mean())


class MiseNative:
    """The C++ MISE octree of one proposal. Same contract as the Python
    `meshing.mise.MISE` oracle: `query()` returns the unknown lattice
    points (lexicographic order), `update(points, values)` stores logits
    and advances the refinement frontier, `to_dense()` fills unknowns from
    their coarsest known ancestor corner."""

    def __init__(self, resolution_0: int, depth: int, threshold: float):
        self._lib = get_lib()
        self.res0 = int(resolution_0)
        self.depth = int(depth)
        self.R = self.res0 * 2 ** self.depth
        self._h = ctypes.c_void_p(self._lib.mise_create(
            self.res0, self.depth, ctypes.c_double(threshold)))

    def query(self) -> np.ndarray:
        n = self._lib.mise_query(self._h, _I64P(), 0)
        out = np.empty((n, 3), dtype=np.int64)
        if n:
            self._lib.mise_query(self._h, out.ctypes.data_as(_I64P), n)
        return out

    def update(self, points: np.ndarray, values: np.ndarray) -> None:
        points = np.ascontiguousarray(points, dtype=np.int64).reshape(-1, 3)
        values = np.ascontiguousarray(values, dtype=np.float64).reshape(-1)
        if len(points) != len(values):
            raise ValueError(f"{len(points)} points, {len(values)} values")
        self._lib.mise_update(self._h, points.ctypes.data_as(_I64P),
                              values.ctypes.data_as(_F64P), len(points))

    def done(self) -> bool:
        return self._lib.mise_query(self._h, _I64P(), 0) == 0

    def to_dense(self) -> np.ndarray:
        out = np.empty((self.R + 1,) * 3, dtype=np.float32)
        self._lib.mise_to_dense(self._h, out.ctypes.data_as(_F32P))
        return out

    def __del__(self):
        h = getattr(self, "_h", None)
        self._h = None
        if h:
            self._lib.mise_destroy(h)
