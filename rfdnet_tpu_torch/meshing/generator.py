"""Mesh generation from the occupancy decoder.

Counterpart of `rfdnet_tpu/meshing/generator.py` `Generator3D`:
- `upsampling_steps == 0`: every proposal's `resolution0`^3 grid is
  decoded in one batched device call, and only surface extraction runs per
  proposal, on the host (C++ marching cubes, `meshing/native.py`);
- `upsampling_steps > 0` (MISE): an octree per proposal refines the
  (resolution0 * 2^steps + 1)^3 corner lattice where the surface is.
  `mise_impl="device"` runs the octrees on the card (`mise_device.py`)
  and extracts the meshes on the host straight from their sparse outputs
  (`native.mise_marching_cubes_batch`), so no dense grid crosses PCIe;
  `mise_impl="host"` runs them in C++ on the host with one decode on the
  card a round (`mise.mise_value_grids`), then marching cubes over the
  dense grids. A failure of either raises; neither falls back to the
  other;
- the grid is padded with -1e6 so meshes close at the box boundary;
- vertices are rescaled to the padded unit box (padding 0.1);
- the iso level is logit(threshold).

Every decode of a scene goes through one decoder bound to its proposals
(`bind`: the CBN tables folded and z drawn once, `ISCNet.occupancy_decoder`).
What the device computes leaves the card once per scene, into pinned host
buffers of its own (from PyTorch's caching host allocator, which hands a
freed buffer out again only once its copy is done), so a scene's results
stay valid while later scenes download. The JAX package's f16 and sparse
grid transfers (`meshing/transfer.py`), its static octree budgets and its
fallback from the device octree to the host one exist for the TPU and its
compiler and are not ported.

Not ported yet (each raises `NotImplementedError` naming its `ROADMAP.md`
item): `refinement_step`, `simplify_nfaces`, `with_normals`,
`extractor="marching_tetrahedra"`; `mise_budgets` is left out by design.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.occnet import make_3d_grid
from .mesh import TriMesh
from .mise import mise_value_grids
from .mise_device import mise_device
from .native import (
    marching_cubes,
    marching_cubes_batch,
    marching_cubes_padded,
    mesh_threads,
    mise_marching_cubes_batch,
)

_PAD_VALUE = -1e6


def _empty_mesh() -> TriMesh:
    return TriMesh(np.zeros((0, 3)), np.zeros((0, 3)))


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` in a new host buffer. From the card the buffer is
    pinned and the copy asynchronous, on the current stream: wait on
    `copies_done` before reading it."""
    if t.device.type == "cpu":
        return t.detach().clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def copies_done(device: torch.device):
    """An event recorded on the current stream of `device` (None on the
    CPU): once it has completed, the `host_copy`s enqueued before it hold
    their values."""
    if device.type == "cpu":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


class GridDownload:
    """One scene's grids (a tensor) or octree outputs (a dict of tensors)
    on their way to the host: `wait()` returns them as numpy (views of this
    download's own buffers) once the copies have finished."""

    def __init__(self, host, event):
        self._host, self._event = host, event

    def wait(self):
        if self._event is not None:
            self._event.synchronize()
        if isinstance(self._host, dict):
            return {k: v.numpy() for k, v in self._host.items()}
        return self._host.numpy()


class Generator3D:
    def __init__(self, decode_fn, threshold=0.5, resolution0=32,
                 upsampling_steps=0, padding=0.1, refinement_step=0,
                 simplify_nfaces=None, extractor="marching_cubes",
                 with_normals=False, mise_impl="device", mise_budgets=None,
                 bind_fn=None):
        """decode_fn: (features (Nb, c), cls_codes (Nb, nc), points
        (Nb, T, 3)) -> logits (Nb, T), tensors on one device: e.g.
        `ISCNet.decode_occupancy`. bind_fn: optional (features, cls_codes)
        -> decode(points (k, T, 3), rows=None) of the proposals `rows`,
        e.g. `ISCNet.occupancy_decoder`; without one, `bind` wraps
        decode_fn. mise_impl: "device" or "host" (see the module
        docstring)."""
        if mise_budgets is not None:
            raise NotImplementedError(
                "mise_budgets: the port's MISE takes exact shapes and has no "
                "budgets (ROADMAP.md, 'Left out by design': MISE budgets)")
        if refinement_step:
            raise NotImplementedError(
                "refinement_step is not ported (ROADMAP.md, 'Left-overs of "
                "the mesh slice': refine)")
        if simplify_nfaces:
            raise NotImplementedError(
                "simplify_nfaces is not ported (ROADMAP.md, 'Left-overs of "
                "the mesh slice': simplify)")
        if with_normals:
            raise NotImplementedError(
                "with_normals is not ported (ROADMAP.md, 'Left-overs of the "
                "mesh slice': normals)")
        if extractor != "marching_cubes":
            raise NotImplementedError(
                f"extractor {extractor!r} is not ported (ROADMAP.md, "
                "'Left-overs of the mesh slice': marching tetrahedra)")
        if mise_impl not in ("device", "host"):
            raise ValueError(f"mise_impl {mise_impl!r}: 'device' or 'host'")
        self.decode_fn = decode_fn
        self.bind_fn = bind_fn
        self.threshold = threshold
        self.resolution0 = resolution0
        self.upsampling_steps = upsampling_steps
        self.padding = padding
        self.mise_impl = mise_impl
        # per level, the counts of the last device octree (`mise_device`)
        self.octree_levels: list[dict] = []

    @property
    def iso(self) -> float:
        """The iso level in logit units."""
        return np.log(self.threshold) - np.log(1.0 - self.threshold)

    @property
    def resolution(self) -> int:
        """Lattice points an axis of the final grid, less one (R)."""
        return self.resolution0 * 2 ** self.upsampling_steps

    def bind(self, features, cls_codes):
        """decode(points (k, T, 3), rows=None) of the scene's proposals
        `rows` ((k,) int64, all when None) -> logits (k, T)."""
        if self.bind_fn is not None:
            return self.bind_fn(features, cls_codes)

        def decode(points, rows=None):
            if rows is None:
                return self.decode_fn(features, cls_codes, points)
            return self.decode_fn(features[rows], cls_codes[rows], points)

        return decode

    def decode_grids(self, features: torch.Tensor,
                     cls_codes: torch.Tensor) -> torch.Tensor:
        """Logit grids (Nb, nx, nx, nx) of every proposal, on the device of
        `features`, from one decoder call (the dense path)."""
        nx = self.resolution0
        pts = (1 + self.padding) * make_3d_grid(
            (-0.5,) * 3, (0.5,) * 3, (nx,) * 3, device=features.device)
        Nb = features.shape[0]
        logits = self.bind(features, cls_codes)(pts[None].expand(Nb, -1, -1))
        return logits.reshape(Nb, nx, nx, nx)

    def run_octree(self, features, cls_codes, valid=None):
        """The device octree of one scene (`mise_device.mise_device`) on
        the device of `features`; its level counts land in
        `octree_levels`."""
        out = mise_device(
            self.bind(features, cls_codes), features.shape[0],
            self.resolution0, self.upsampling_steps, self.threshold,
            self.padding, valid=valid, device=features.device)
        self.octree_levels = out.levels
        return out

    def mise_grids(self, features, cls_codes) -> np.ndarray:
        """The host octrees' dense (Nb, R+1, R+1, R+1) logit grids
        (`mise.mise_value_grids`, decodes on the device of `features`)."""
        return mise_value_grids(
            self.bind(features, cls_codes), features.shape[0],
            self.resolution0, self.upsampling_steps, self.threshold,
            self.padding, device=features.device)

    def start(self, features, cls_codes, valid=None) -> GridDownload:
        """The device half of a scene's meshes, and the start of the copy
        of its result to the host: the dense grids, or the device octree's
        sparse outputs, or (mise_impl "host") the host octrees' grids.
        `meshes_from` takes what the download's `wait()` returns."""
        if self.upsampling_steps == 0:
            return self.start_download(self.decode_grids(features, cls_codes))
        if self.mise_impl == "host":
            return GridDownload(torch.from_numpy(
                self.mise_grids(features, cls_codes)), None)
        if valid is not None:
            valid = torch.as_tensor(valid, device=features.device)
        out = self.run_octree(features, cls_codes, valid)
        return self.start_download({
            k: getattr(out, k) for k in ("lvl0", "idx", "vals",
                                         "level_counts")})

    def start_download(self, grids) -> GridDownload:
        """Start the copy of `grids` (a tensor or a dict of tensors) into
        host buffers of their own and return at once: from the card pinned
        buffers, copied into asynchronously on the current stream, with an
        event to wait on."""
        if isinstance(grids, dict):
            host = {k: host_copy(v) for k, v in grids.items()}
            device = next(iter(grids.values())).device
        else:
            host, device = host_copy(grids), grids.device
        return GridDownload(host, copies_done(device))

    def generate_meshes(self, features, cls_codes, valid=None):
        """features (Nb, c_dim), cls_codes (Nb, num_class) -> list of
        TriMesh (empty mesh for invalid slots)."""
        if valid is not None:
            valid = _to_numpy(valid).reshape(-1).astype(bool)
        return self.meshes_from(
            self.start(features, cls_codes, valid).wait(), valid=valid)

    def meshes_from(self, host, valid=None):
        """The host half of `start`: meshes from what its download's
        `wait()` returned."""
        if isinstance(host, dict):
            return self.meshes_from_octree(host, valid=valid)
        return self.meshes_from_grids(host, valid=valid)

    def meshes_from_octree(self, host: dict, valid=None):
        """Surface extraction straight from a device octree's sparse outputs
        (numpy `lvl0`, `idx`, `vals`, `level_counts`): identical arrays to
        `meshes_from_grids` over `mise_device.reconstruct_dense` of them,
        in one native call for the scene (its threads, one on one core)."""
        if valid is not None:
            valid = _to_numpy(valid).reshape(-1).astype(bool)
        pairs = mise_marching_cubes_batch(
            host["lvl0"], self.resolution0, self.upsampling_steps,
            host["idx"], host["vals"], host["level_counts"], self.iso,
            valid=valid, pad_val=_PAD_VALUE)
        return self._meshes(pairs, np.full(3, self.resolution))

    def meshes_from_grids(self, grids, valid=None):
        """Host half of `generate_meshes`: surface extraction from logit
        grids (Nb, nx, ny, nz), e.g. the `grids` of `ISCNet.generate`.

        With more than one worker thread the whole scene extracts in one
        native call (padding applied inside the library, proposals spread
        over its threads); on one core, proposal by proposal. Both routes
        give identical arrays."""
        grids = _to_numpy(grids)
        if grids.ndim != 4:
            raise ValueError(f"grids shape {grids.shape}: expected 4 "
                             "dimensions")
        if valid is not None:
            valid = _to_numpy(valid).reshape(-1).astype(bool)
        g32 = grids.astype(np.float32)
        if mesh_threads(g32.shape[0]) > 1:
            pairs = marching_cubes_batch(g32, self.iso, _PAD_VALUE,
                                         valid=valid)
        else:
            pairs = [
                (np.zeros((0, 3)), np.zeros((0, 3), np.int32))
                if (valid is not None and not valid[i])
                else marching_cubes_padded(g32[i], self.iso, _PAD_VALUE)
                for i in range(g32.shape[0])
            ]
        return self._meshes(pairs, np.array(grids.shape[1:]) - 1)

    def _meshes(self, pairs, cells):
        """TriMeshes of (verts, tris) pairs in padded index space over
        `cells` cells an axis, rescaled to the padded unit box."""
        box_size = 1 + self.padding
        scale = box_size / cells
        meshes = []
        for verts, tris in pairs:
            if len(verts) == 0:
                meshes.append(_empty_mesh())
                continue
            verts = (verts - 1.0) * scale - box_size * 0.5
            meshes.append(TriMesh(verts, tris))
        return meshes

    def extract_mesh(self, value_grid) -> TriMesh:
        """One logit grid (nx, ny, nz) -> TriMesh, through an explicitly
        padded copy."""
        value_grid = _to_numpy(value_grid)
        n_x, n_y, n_z = value_grid.shape
        box_size = 1 + self.padding
        padded = np.pad(value_grid.astype(np.float32), 1, mode="constant",
                        constant_values=_PAD_VALUE)
        verts, tris = marching_cubes(padded, self.iso)
        if len(verts) == 0:
            return _empty_mesh()
        # the extractor places vertices exactly on the lattice, so only the
        # pad offset is removed
        verts = verts - 1.0
        verts = verts / np.array([n_x - 1, n_y - 1, n_z - 1])
        verts = box_size * (verts - 0.5)
        return TriMesh(verts, tris)
