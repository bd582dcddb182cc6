"""Mesh generation from the occupancy decoder: the dense-grid path.

Counterpart of `rfdnet_tpu/meshing/generator.py` `Generator3D` for
`upsampling_steps == 0`:
- every proposal's `resolution0`^3 grid is decoded in one batched device
  call; only surface extraction runs per proposal, on the host (C++
  marching cubes, `meshing/native.py`);
- the grid is padded with -1e6 so meshes close at the box boundary;
- vertices are rescaled to the padded unit box (padding 0.1);
- the iso level is logit(threshold).

The logit grids leave the card once per scene, as dense float32, into a
pinned host buffer of their own (from PyTorch's caching host allocator,
which hands a freed buffer out again only once its copy is done), so a
scene's grids stay valid while later scenes download. The JAX package's
f16 and sparse transfers (`meshing/transfer.py`) exist for the TPU's host
link and are not ported.

Not ported yet (each raises `NotImplementedError` naming its `ROADMAP.md`
item): `upsampling_steps > 0` (MISE), `refinement_step`, `simplify_nfaces`,
`with_normals`, `extractor="marching_tetrahedra"`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.occnet import make_3d_grid
from .mesh import TriMesh
from .native import (
    marching_cubes,
    marching_cubes_batch,
    marching_cubes_padded,
    mesh_threads,
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
    """One scene's grids on their way to the host: `wait()` returns them as
    a numpy array (a view of this download's own buffer) once the copy has
    finished."""

    def __init__(self, host: torch.Tensor, event):
        self._host, self._event = host, event

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class Generator3D:
    def __init__(self, decode_fn, threshold=0.5, resolution0=32,
                 upsampling_steps=0, padding=0.1, refinement_step=0,
                 simplify_nfaces=None, extractor="marching_cubes",
                 with_normals=False):
        """decode_fn: (features (Nb, c), cls_codes (Nb, nc), points
        (Nb, T, 3)) -> logits (Nb, T), tensors on one device: e.g.
        `ISCNet.decode_occupancy`."""
        if upsampling_steps:
            raise NotImplementedError(
                "upsampling_steps > 0 needs MISE (ROADMAP.md, 'MISE')")
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
        self.decode_fn = decode_fn
        self.threshold = threshold
        self.resolution0 = resolution0
        self.padding = padding

    @property
    def iso(self) -> float:
        """The iso level in logit units."""
        return np.log(self.threshold) - np.log(1.0 - self.threshold)

    def decode_grids(self, features: torch.Tensor,
                     cls_codes: torch.Tensor) -> torch.Tensor:
        """Logit grids (Nb, nx, nx, nx) of every proposal, on the device of
        `features`, from one decoder call."""
        nx = self.resolution0
        pts = (1 + self.padding) * make_3d_grid(
            (-0.5,) * 3, (0.5,) * 3, (nx,) * 3, device=features.device)
        Nb = features.shape[0]
        logits = self.decode_fn(features, cls_codes,
                                pts[None].expand(Nb, -1, -1))
        return logits.reshape(Nb, nx, nx, nx)

    def start_download(self, grids: torch.Tensor) -> GridDownload:
        """Start the copy of `grids` into a host buffer of its own and return
        at once: from the card a pinned buffer, copied into asynchronously
        on the current stream, with an event to wait on."""
        host = host_copy(grids)
        return GridDownload(host, copies_done(grids.device))

    def generate_meshes(self, features, cls_codes, valid=None):
        """features (Nb, c_dim), cls_codes (Nb, num_class) -> list of
        TriMesh (empty mesh for invalid slots)."""
        grids = self.start_download(self.decode_grids(features, cls_codes))
        if valid is not None:
            valid = _to_numpy(valid)
        return self.meshes_from_grids(grids.wait(), valid=valid)

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
        box_size = 1 + self.padding
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
        scale = box_size / np.array(
            [grids.shape[1] - 1, grids.shape[2] - 1, grids.shape[3] - 1])
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
