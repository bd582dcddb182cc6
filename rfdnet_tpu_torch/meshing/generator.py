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
compiler and are not ported; `mise_budgets` raises.

The options, in the order they apply to each mesh:
- `extractor="marching_tetrahedra"` extracts proposal by proposal on the
  host (`native.marching_tetrahedra`; the device octree's outputs are made
  dense first);
- `simplify_nfaces` runs the QEM simplification (`native.simplify_mesh`,
  aggressiveness 5) on each mesh above that many faces, as it is extracted;
- `refinement_step` moves the vertices for that many RMSprop steps (lr
  1e-4, decay 0.9, eps 1e-8 inside the root, as optax's `rmsprop`): each
  step samples one Dirichlet(0.5) point a face, pulls its occupancy toward
  the threshold and the face's normal toward the negative occupancy
  gradient there;
- `with_normals` sets each vertex's normal to the negative normalised
  occupancy gradient.
Refine and normals differentiate the decoder with respect to the points.
The CUDA kernel has no backward, so they decode through a differentiable
decoder of their own (`grad_bind_fn`, e.g. `ISCNet.gradient_decoder`: the
layer-by-layer chain in eval mode with the grid decode's z), all meshes of
a scene at once, and only with respect to the points and vertices.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models.occnet import make_3d_grid
from .mesh import TriMesh
from .mise import mise_value_grids
from .mise_device import mise_device, reconstruct_dense
from .native import (
    marching_cubes,
    marching_cubes_batch,
    marching_cubes_padded,
    marching_tetrahedra,
    mesh_threads,
    mise_marching_cubes_batch,
    simplify_mesh,
)

_PAD_VALUE = -1e6
_EXTRACTORS = {"marching_cubes": marching_cubes,
               "marching_tetrahedra": marching_tetrahedra}
# the QEM aggressiveness of the reference's generator
_SIMPLIFY_AGGRESSIVENESS = 5.0
# RMSprop of the refinement, as `optax.rmsprop(1e-4)`
_REFINE_LR, _RMS_DECAY, _RMS_EPS = 1e-4, 0.9, 1e-8
# points a decoder call of refine or normals takes at most (bounds the
# memory of the double backward)
_GRAD_CHUNK_POINTS = 1 << 17
# where a padded face or vertex is evaluated: a point off the origin, whose
# gradient is masked out
_PAD_POINT = 0.3


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


def dirichlet_draws(steps: int, faces: int, seed: int = 0) -> torch.Tensor:
    """(steps, faces, 3) barycentric weights, Dirichlet(0.5, 0.5, 0.5), from
    a CPU generator seeded `seed`: the same values on every device."""
    g = torch.Generator().manual_seed(seed)
    gamma = torch._standard_gamma(torch.full((steps, faces, 3), 0.5),
                                  generator=g).clamp_min(1e-9)
    return gamma / gamma.sum(dim=-1, keepdim=True)


class Generator3D:
    def __init__(self, decode_fn, threshold=0.5, resolution0=32,
                 upsampling_steps=0, padding=0.1, refinement_step=0,
                 simplify_nfaces=None, extractor="marching_cubes",
                 with_normals=False, mise_impl="device", mise_budgets=None,
                 bind_fn=None, grad_bind_fn=None):
        """decode_fn: (features (Nb, c), cls_codes (Nb, nc), points
        (Nb, T, 3)) -> logits (Nb, T), tensors on one device: e.g.
        `ISCNet.decode_occupancy`. bind_fn: optional (features, cls_codes)
        -> decode(points (k, T, 3), rows=None) of the proposals `rows`,
        e.g. `ISCNet.occupancy_decoder`; without one, `bind` wraps
        decode_fn. grad_bind_fn: the same, differentiable with respect to
        the points, for refine and normals (e.g. `ISCNet.gradient_decoder`),
        which need one. mise_impl: "device" or "host"; the
        options: see the module docstring."""
        if mise_budgets is not None:
            raise NotImplementedError(
                "mise_budgets: the port's MISE takes exact shapes and has no "
                "budgets (ROADMAP.md, 'Left out by design': MISE budgets)")
        if extractor not in _EXTRACTORS:
            raise ValueError(f"extractor {extractor!r}: one of "
                             f"{sorted(_EXTRACTORS)}")
        if mise_impl not in ("device", "host"):
            raise ValueError(f"mise_impl {mise_impl!r}: 'device' or 'host'")
        if (refinement_step or with_normals) and grad_bind_fn is None:
            raise ValueError("refinement_step and with_normals need "
                             "grad_bind_fn, a decoder differentiable with "
                             "respect to the points")
        self.decode_fn = decode_fn
        self.bind_fn = bind_fn
        self.grad_bind_fn = grad_bind_fn
        self.threshold = threshold
        self.resolution0 = resolution0
        self.upsampling_steps = upsampling_steps
        self.padding = padding
        self.refinement_step = int(refinement_step or 0)
        self.simplify_nfaces = simplify_nfaces
        self.extractor = extractor
        self.with_normals = bool(with_normals)
        self.mise_impl = mise_impl
        # per level, the counts of the last device octree (`mise_device`)
        self.octree_levels: list[dict] = []
        # host-clock ms of the last `meshes_from*` call by stage (extract,
        # simplify, refine, normals) and refine's mean loss over the meshes
        # at its first and last step
        self.last_ms: dict = {}
        self.refine_losses: tuple | None = None

    @property
    def needs_decoder(self) -> bool:
        """Whether the host half decodes again (refine or normals), and so
        needs the scene's features and class codes."""
        return bool(self.refinement_step or self.with_normals)

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
            self.start(features, cls_codes, valid).wait(), valid=valid,
            features=features, cls_codes=cls_codes)

    def meshes_from(self, host, valid=None, features=None, cls_codes=None):
        """The host half of `start`: meshes from what its download's
        `wait()` returned. features / cls_codes (tensors on the device):
        needed for refine and normals only."""
        if isinstance(host, dict):
            return self.meshes_from_octree(host, valid, features, cls_codes)
        return self.meshes_from_grids(host, valid, features, cls_codes)

    def meshes_from_octree(self, host: dict, valid=None, features=None,
                           cls_codes=None):
        """Surface extraction straight from a device octree's sparse outputs
        (numpy `lvl0`, `idx`, `vals`, `level_counts`): identical arrays to
        `meshes_from_grids` over `mise_device.reconstruct_dense` of them,
        in one native call for the scene (its threads, one on one core).
        Marching tetrahedra extracts from that dense reconstruction."""
        if self.extractor != "marching_cubes":
            grids = reconstruct_dense(
                *(torch.from_numpy(np.asarray(host[k])) for k in
                  ("lvl0", "idx", "vals", "level_counts")),
                self.resolution0, self.upsampling_steps)
            return self.meshes_from_grids(grids, valid, features, cls_codes)
        if valid is not None:
            valid = _to_numpy(valid).reshape(-1).astype(bool)
        t0 = time.perf_counter()
        pairs = mise_marching_cubes_batch(
            host["lvl0"], self.resolution0, self.upsampling_steps,
            host["idx"], host["vals"], host["level_counts"], self.iso,
            valid=valid, pad_val=_PAD_VALUE)
        self.last_ms = {"extract": _ms(t0)}
        meshes = self._meshes(pairs, np.full(3, self.resolution))
        return self._postprocess(meshes, valid, features, cls_codes)

    def meshes_from_grids(self, grids, valid=None, features=None,
                          cls_codes=None):
        """Host half of `generate_meshes`: surface extraction from logit
        grids (Nb, nx, ny, nz), e.g. the `grids` of `ISCNet.generate`, then
        the options (module docstring).

        Marching cubes with more than one worker thread extracts the whole
        scene in one native call (padding applied inside the library,
        proposals spread over its threads); on one core, proposal by
        proposal. Both routes give identical arrays. Marching tetrahedra
        goes proposal by proposal."""
        grids = _to_numpy(grids)
        if grids.ndim != 4:
            raise ValueError(f"grids shape {grids.shape}: expected 4 "
                             "dimensions")
        if valid is not None:
            valid = _to_numpy(valid).reshape(-1).astype(bool)
        t0 = time.perf_counter()
        self.last_ms = {}
        if self.extractor != "marching_cubes":
            meshes = [
                _empty_mesh() if (valid is not None and not valid[i])
                else self._simplify(self.extract_mesh(grids[i]))
                for i in range(grids.shape[0])
            ]
            self.last_ms["extract"] = (_ms(t0)
                                       - self.last_ms.get("simplify", 0.0))
            return self._postprocess(meshes, valid, features, cls_codes)
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
        self.last_ms["extract"] = _ms(t0)
        meshes = self._meshes(pairs, np.array(grids.shape[1:]) - 1)
        return self._postprocess(meshes, valid, features, cls_codes)

    def _meshes(self, pairs, cells):
        """TriMeshes of (verts, tris) pairs in padded index space over
        `cells` cells an axis, rescaled to the padded unit box, each
        simplified as the options say."""
        box_size = 1 + self.padding
        scale = box_size / cells
        meshes = []
        for verts, tris in pairs:
            if len(verts) == 0:
                meshes.append(_empty_mesh())
                continue
            verts = (verts - 1.0) * scale - box_size * 0.5
            meshes.append(self._simplify(TriMesh(verts, tris)))
        return meshes

    def _simplify(self, mesh: TriMesh) -> TriMesh:
        """`mesh`, QEM-simplified when it has more than `simplify_nfaces`
        faces; its time adds to `last_ms["simplify"]`."""
        if self.simplify_nfaces and len(mesh.faces) > self.simplify_nfaces:
            t0 = time.perf_counter()
            mesh = TriMesh(*simplify_mesh(mesh.vertices, mesh.faces,
                                          self.simplify_nfaces,
                                          _SIMPLIFY_AGGRESSIVENESS))
            self.last_ms["simplify"] = (self.last_ms.get("simplify", 0.0)
                                        + _ms(t0))
        return mesh

    def _postprocess(self, meshes, valid, features, cls_codes):
        """Refine, then normals, of every valid non-empty mesh, through
        the scene's differentiable decoder."""
        if not self.needs_decoder:
            return meshes
        if features is None or cls_codes is None:
            raise ValueError("refinement_step and with_normals decode again: "
                             "pass the scene's features and cls_codes")
        rows = [i for i, m in enumerate(meshes) if len(m.vertices)
                and (valid is None or valid[i])]
        if not rows:
            return meshes
        decode = self.grad_bind_fn(features, cls_codes)
        device = features.device
        if self.refinement_step:
            t0 = time.perf_counter()
            refined = self.refine_meshes([meshes[i] for i in rows], rows,
                                         decode, self.refinement_step,
                                         device=device)
            for i, m in zip(rows, refined):
                meshes[i] = m
            self.last_ms["refine"] = _ms(t0)
        if self.with_normals:
            t0 = time.perf_counter()
            normals = self.estimate_normals(
                [meshes[i].vertices for i in rows], rows, decode, device)
            for i, n in zip(rows, normals):
                meshes[i].vertex_normals = n
            self.last_ms["normals"] = _ms(t0)
        return meshes

    @staticmethod
    def _chunks(sizes):
        """Consecutive index ranges of `sizes` whose padded size (count x
        largest) stays within `_GRAD_CHUNK_POINTS` (at least one each)."""
        start = 0
        while start < len(sizes):
            end, top = start + 1, sizes[start]
            while end < len(sizes):
                top2 = max(top, sizes[end])
                if top2 * (end + 1 - start) > _GRAD_CHUNK_POINTS:
                    break
                end, top = end + 1, top2
            yield start, end
            start = end

    def estimate_normals(self, vertices, rows, decode, device=None):
        """Unit normals (V_i, 3) float64 of each vertex set of `vertices`
        (the meshes of proposals `rows`): the negative normalised gradient
        of the occupancy logit with respect to the point, on `device`."""
        out = []
        for a, b in self._chunks([len(v) for v in vertices]):
            vmax = max(len(v) for v in vertices[a:b])
            pts = np.full((b - a, vmax, 3), _PAD_POINT, np.float32)
            for j, v in enumerate(vertices[a:b]):
                pts[j, :len(v)] = v
            with torch.enable_grad():
                p = torch.from_numpy(pts).to(device).requires_grad_(True)
                logits = decode(p, torch.as_tensor(rows[a:b], device=device))
                g, = torch.autograd.grad(logits.float().sum(), p)
            g = g.cpu().numpy()
            for j, v in enumerate(vertices[a:b]):
                gj = g[j, :len(v)]
                out.append((-gj / np.maximum(
                    np.linalg.norm(gj, axis=-1, keepdims=True), 1e-12))
                    .astype(np.float64))
        return out

    def refine_meshes(self, meshes, rows, decode, steps: int, seed: int = 0,
                      eps=None, device=None):
        """Copies of `meshes` (the non-empty meshes of proposals `rows`)
        with their vertices refined for `steps` RMSprop steps (see the
        module docstring). eps: optional (steps, k, F, 3) barycentric
        weights, mesh i's face f at step s in [s, i, f] (F at least each
        mesh's face count); else `dirichlet_draws(steps, F, seed)`, the
        same for every mesh. `refine_losses` receives the mean loss over
        the meshes at the first and the last step. Runs on `device`."""
        nfaces = [len(m.faces) for m in meshes]
        if eps is None:
            eps = dirichlet_draws(steps, max(nfaces), seed)[:, None]
        eps = torch.as_tensor(eps, dtype=torch.float32)
        out, first, last = [], 0.0, 0.0
        for a, b in self._chunks(nfaces):
            chunk_eps = eps[:, a:b] if eps.shape[1] > 1 else eps
            verts, losses = self._refine_chunk(
                meshes[a:b], rows[a:b], decode, steps, chunk_eps, device)
            out.extend(verts)
            first, last = first + losses[0], last + losses[1]
        self.refine_losses = (first / len(meshes), last / len(meshes))
        refined = []
        for m, v in zip(meshes, out):
            r = m.copy()
            r.vertices = v
            refined.append(r)
        return refined

    def _refine_chunk(self, meshes, rows, decode, steps, eps, device):
        """`refine_meshes` of a few meshes, decoded together: their vertices
        (V_i, 3) float64 and the summed loss at the first and last step."""
        k = len(meshes)
        fmax = max(len(m.faces) for m in meshes)
        offsets = np.cumsum([0] + [len(m.vertices) for m in meshes])
        faces = np.zeros((k, fmax, 3), np.int64)
        fmask = np.zeros((k, fmax), np.float32)
        for j, m in enumerate(meshes):
            faces[j] = offsets[j]   # padded faces: the mesh's vertex 0
            faces[j, :len(m.faces)] = np.asarray(m.faces) + offsets[j]
            fmask[j, :len(m.faces)] = 1.0
        verts0 = np.concatenate([m.vertices for m in meshes]).astype(
            np.float32)
        faces = torch.from_numpy(faces).to(device)
        fmask = torch.from_numpy(fmask).to(device)
        eps = eps[:, :, :fmax].to(device)
        rows_t = torch.as_tensor(rows, device=device)
        thr = self.threshold

        def loss_fn(v, w):
            fv = v[faces]                                   # (k, F, 3, 3)
            pts = torch.sum(fv * w[..., None], dim=2)
            pts = torch.where(fmask[..., None] > 0, pts, _PAD_POINT)
            n = torch.linalg.cross(fv[:, :, 1] - fv[:, :, 0],
                                   fv[:, :, 2] - fv[:, :, 1])
            # rsqrt(x + eps): |n| has no gradient at 0, and marching
            # tetrahedra gives zero-area faces
            n = n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True)
                                + 1e-16)
            occ = torch.sigmoid(decode(pts, rows_t))
            g, = torch.autograd.grad(occ.sum(), pts, create_graph=True)
            tgt = -g
            tgt = tgt * torch.rsqrt(torch.sum(tgt * tgt, dim=-1,
                                              keepdim=True) + 1e-16)
            count = fmask.sum(dim=1)
            loss_target = torch.sum((occ - thr) ** 2 * fmask, dim=1) / count
            loss_normal = torch.sum(torch.sum((n - tgt) ** 2, dim=-1)
                                    * fmask, dim=1) / count
            return torch.sum(loss_target + 0.01 * loss_normal)

        v = torch.from_numpy(verts0).to(device)
        nu = torch.zeros_like(v)
        losses = []
        with torch.enable_grad():
            for s in range(steps):
                v.requires_grad_(True)
                loss = loss_fn(v, eps[s].expand(k, fmax, 3))
                g, = torch.autograd.grad(loss, v)
                v = v.detach()
                if s in (0, steps - 1):
                    losses.append(loss.detach())
                nu = _RMS_DECAY * nu + (1.0 - _RMS_DECAY) * g ** 2
                v = v + torch.rsqrt(nu + _RMS_EPS) * g * (-_REFINE_LR)
        if steps == 1:
            losses.append(losses[0])
        v = v.cpu().numpy().astype(np.float64)
        return ([v[offsets[j]:offsets[j + 1]] for j in range(k)],
                [float(x) for x in losses])

    def extract_mesh(self, value_grid) -> TriMesh:
        """One logit grid (nx, ny, nz) -> TriMesh by the generator's
        extractor, through an explicitly padded copy."""
        value_grid = _to_numpy(value_grid)
        n_x, n_y, n_z = value_grid.shape
        box_size = 1 + self.padding
        padded = np.pad(value_grid.astype(np.float32), 1, mode="constant",
                        constant_values=_PAD_VALUE)
        verts, tris = _EXTRACTORS[self.extractor](padded, self.iso)
        if len(verts) == 0:
            return _empty_mesh()
        # the extractor places vertices exactly on the lattice, so only the
        # pad offset is removed
        verts = verts - 1.0
        verts = verts / np.array([n_x - 1, n_y - 1, n_z - 1])
        verts = box_size * (verts - 0.5)
        return TriMesh(verts, tris)


def _ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3
