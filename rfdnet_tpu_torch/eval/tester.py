"""Test-time evaluation: per-scene generation with GT fields, host meshes, the
box refit, voxel IoU and AP, and the per-scene dumps.

Counterpart of `rfdnet_tpu/eval/tester.py`. For each val scene
`dispatch_step` queues the device work on the current stream (detection,
NMS, completion conditioning with the supervised skip propagation, the eval
completion loss, the 16^3 shape voxels as bits and, when meshes are
generated, every slot's dense grid, or with `upsampling_steps > 0` the
octrees on the card, whose level syncs run on the main thread) and the
copies of its outputs into host buffers of their own. `consume_step` waits
for those copies, then extracts the meshes on the host (from the grids, or
straight from the octrees' sparse outputs), refits the boxes to the scan on
the device (`fit_to_scan`: the completion phase with meshes), and assembles
the (class, box[, mesh], score) tuples of the AP and the voxel IoU of each
valid slot. With `evaluate_mesh_mAP` (and meshes) it also voxelizes each
valid slot's mesh placed in its box and each GT object's watertight mesh
(`<shapenet_path>/watertight_scaled_simplified/<catid>/<id>.off`) placed
in its GT box, at the scene's z-extent / 46, on 8 threads, for the mesh AP
(`mAP_mesh`, `AR_mesh`); the dump threshold is then the eval config's
`conf_thresh`.

Each scene's stages are spans (`utils.profiling`), recorded in the
Tester's own `recorder` (with the model's, `ISCNet.generate`'s): the
root `tester.scene` twice a scene, once around `dispatch_step` (over
`tester.dispatch`, `tester.generate`, `tester.octree`) and once, with
the scene's unit handed over, around `consume_step` (over `tester.d2h`,
`tester.mesh`, `tester.refit`, `tester.voxelize`, `tester.ap`), and
`tester.dump` under the same unit. `scene_ms` reads them.

`run` keeps one scene in flight: scene i's `consume_step` runs in a worker
thread, on a CUDA stream of its own, while the main thread queues scene
i+1's device work (the marching cubes library releases the interpreter
lock). `run(..., overlap=False)` runs the scenes one after the other.

Every occupancy decode of a scene but refine's and normals' goes through
the fused CBN decoder (a CUDA kernel on the card) in the decoder's own
operand type, bf16 with `data.decoder_bf16` and f32 without, as the JAX
Tester's flax chain does. `generation.decoder_impl` is the JAX Tester's
choice of the grid decode (`decoder_impl_dtype`): "pallas" puts the grid
decode and the MISE level decodes on the bf16 kernel whatever
`decoder_bf16` says (the completion loss, the 16^3 voxels and the
gradient decodes keep the decoder's type); None and "flax" leave them in
the decoder's type (the f32 kernel is the port's counterpart of the flax
f32 chain). The grids cross to the host as dense float32: the f16 and sparse
transfers of the JAX Tester exist for the TPU's host link and are not
ported, nor is its f16 narrowing of the octree's decodes (the port keeps
f32). With `refinement_step` or `with_normals` the scene's features and
class codes stay alive with the pending scene, for the worker's decodes.
"""

from __future__ import annotations

import contextlib
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import CLASS2TYPE, eval_config
from ..meshing.generator import copies_done, host_copy
from ..utils import profiling
from ..utils.profiling import span
from ..utils.scene_viz import SceneRender, corners_to_center_vectors
from .ap_helper import (
    APCalculator,
    assembly_gt_map_cls,
    assembly_pred_map_cls,
    parse_groundtruths,
)
from .box_util import flip_axis_to_depth
from .mesh_iou import mesh_iou, voxelize_mesh_pair
from .refit import TRANSFORM_SHAPENET, _box_params_from_corners, fit_meshes_to_scan

# the batch fields `ISCNet.generate` reads; the rest stays on the host
_DEVICE_KEYS = ("point_clouds", "center_label", "box_label_mask",
                "sem_cls_label", "point_instance_labels",
                "object_instance_labels", "object_points", "object_points_occ")
# outputs the host never reads: they stay on the device
_DEVICE_ONLY = ("features", "cls_codes")


def compute_iou(occ1: np.ndarray, occ2: np.ndarray) -> np.ndarray:
    """Batched boolean-set IoU over the flattened trailing dims (an empty
    batch, a scene without a valid slot, gives an empty result)."""
    occ1, occ2 = np.asarray(occ1), np.asarray(occ2)
    occ1 = occ1.reshape(len(occ1), int(np.prod(occ1.shape[1:]))) >= 0.5
    occ2 = occ2.reshape(len(occ2), int(np.prod(occ2.shape[1:]))) >= 0.5
    union = (occ1 | occ2).sum(axis=-1)
    inter = (occ1 & occ2).sum(axis=-1)
    return inter / np.maximum(union, 1)


def place_mesh_in_box(mesh, box_corners_cam: np.ndarray):
    """Place a canonical ([-0.55, 0.55]^3-ish) mesh into a camera-frame
    corner box, in the depth/scan frame. Returns a copy."""
    params = _box_params_from_corners(np.asarray(box_corners_cam))
    centroid, sizes, orientation = params[:3], params[3:6], params[6]
    out = mesh.copy()
    v = np.asarray(out.vertices)
    if len(v) == 0:
        return out
    v = v - (v.max(0) + v.min(0)) / 2.0
    v = v @ TRANSFORM_SHAPENET.T
    extent = v.max(0) - v.min(0)
    v = v / np.where(extent > 0, extent, 1.0) * sizes
    cs, sn = np.cos(orientation), np.sin(orientation)
    R = np.array([[cs, sn, 0], [-sn, cs, 0], [0, 0, 1]])
    out.vertices = v @ R + centroid
    return out


def decoder_impl_dtype(gen_cfg: dict):
    """The operand type of the grid and MISE decodes that
    `generation.decoder_impl` asks for: torch.bfloat16 for "pallas" (the
    JAX package's fused bf16 kernel), None (the decoder's own) for None or
    "flax"."""
    impl = gen_cfg.get("decoder_impl")
    if impl == "pallas":
        return torch.bfloat16
    if impl in (None, "flax"):
        return None
    raise ValueError(f"generation.decoder_impl: {impl!r} is not "
                     "'pallas', 'flax' or null")


def _ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


class Tester:
    def __init__(self, cfg: dict, model, log=print):
        """cfg: `config.load_config(..., mode="test")`; model: the port's
        `ISCNet` with its weights, on the device the Tester runs on."""
        from ..demo import make_generator

        self.cfg = cfg
        self.model = model
        self.log = log
        self.device = next(model.parameters()).device
        mode = cfg["mode"]
        gen_cfg = cfg["generation"]
        self.generate_mesh = gen_cfg["generate_mesh"]
        self.evaluate_mesh_mAP = bool(
            cfg.get(mode, {}).get("evaluate_mesh_mAP") and self.generate_mesh)
        self.eval_config = eval_config(cfg)
        self.dump_threshold = (self.eval_config["conf_thresh"]
                               if self.evaluate_mesh_mAP
                               else gen_cfg["dump_threshold"])
        self.fit_to_scan = (cfg.get(mode, {}).get("phase", "") == "completion"
                            and self.generate_mesh)
        self.grid_mxu_dtype = decoder_impl_dtype(gen_cfg)
        self.generator = (make_generator(cfg, model,
                                         mxu_dtype=self.grid_mxu_dtype)
                          if self.generate_mesh else None)
        self._sample_z = bool(gen_cfg["use_sampling"])
        # the dense grids come from `ISCNet.generate`; an octree from the
        # generator, after it
        self._grid_res = (gen_cfg["resolution_0"] if self.generate_mesh
                          and gen_cfg["upsampling_steps"] == 0 else None)
        self._octree = self.generate_mesh and gen_cfg["upsampling_steps"] > 0
        self._pool = ThreadPoolExecutor(8)
        # the worker's stream: its refit runs beside the next scene's work
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        # per scene, the milliseconds of each stage (see `consume_step`),
        # read from the spans in `recorder`
        self.recorder = profiling.Recorder()
        self.scene_ms: list[dict] = []
        self.refit_sizes: list[dict] = []
        self.run_ms = self.metrics_ms = None

    # ---------------------------------------------------------------- step
    def dispatch_step(self, batch: dict) -> dict:
        """Queue one scene's device work and the copies of its outputs to
        the host; return at once (with a card) with what `consume_step`
        needs."""
        with profiling.recording(self.recorder), \
                span("tester.scene") as scene, \
                span("tester.dispatch") as dispatch:
            pending = self._dispatch(batch)
        pending["unit"] = scene.unit
        pending["spans"]["dispatch"] = dispatch
        return pending

    def _dispatch(self, batch: dict) -> dict:
        dev = self.device
        data = {k: torch.from_numpy(np.asarray(batch[k])).to(dev)
                for k in _DEVICE_KEYS if k in batch}
        ec = self.eval_config
        with span("tester.generate") as generate:
            out = self.model.generate(
                data, nms_iou=ec["nms_iou"], use_cls_nms=ec["cls_nms"],
                dump_threshold=self.dump_threshold,
                remove_empty_box=ec["remove_empty_box"],
                decode_grid_res=self._grid_res, grid_sample=self._sample_z,
                grid_mxu_dtype=self.grid_mxu_dtype)
        spans = {"generate": generate}
        octree = None
        if self._octree and "gen" in out:
            gen = out["gen"]
            with span("tester.octree") as spans["octree"]:
                octree = self.generator.start(
                    gen["features"], gen["cls_codes"],
                    gen["valid"].reshape(-1))
        host = {"parsed": {k: host_copy(v) for k, v in out["parsed"].items()}}
        if "gen" in out:
            host["gen"] = {k: host_copy(v) for k, v in out["gen"].items()
                           if k not in _DEVICE_ONLY}
        for k in ("completion_loss", "shape_voxels_bits", "grids"):
            if k in out:
                host[k] = host_copy(out[k])
        # refine and normals decode again from the scene's features, on the
        # device, in `consume_step`: they stay alive with the pending scene
        decoder_inputs = None
        if ("gen" in out and self.generator is not None
                and self.generator.needs_decoder):
            decoder_inputs = (out["gen"]["features"], out["gen"]["cls_codes"])
        return {"batch": batch, "host": host, "done": copies_done(dev),
                "octree": octree, "spans": spans,
                "decoder_inputs": decoder_inputs}

    def test_step(self, batch: dict) -> dict:
        return self.consume_step(self.dispatch_step(batch))

    def consume_step(self, pending: dict) -> dict:
        """The host half of a scene (and the refit, on the device). Its
        stage times land in `scene_ms`, each read from its span:
        `dispatch` (host, queueing the scene), `generate` (device, from
        the scene's first to its last queued operation, on a card only),
        `octree` (device, with MISE, on a card only), `d2h` (waiting for
        the scene's device work and the copies of its outputs), `mesh`,
        `refit`, `voxelize` (with the mesh mAP), `ap` (voxel IoU and AP
        assembly), all host ms; `run` adds `dump`."""
        with profiling.recording(self.recorder), \
                span("tester.scene", unit=pending["unit"]):
            return self._consume(pending)

    def _consume(self, pending: dict) -> dict:
        with span("tester.d2h") as d2h:
            if pending["done"] is not None:
                pending["done"].synchronize()
            octree = (pending["octree"].wait()
                      if pending["octree"] is not None else None)
        spans = pending["spans"]
        ms = {"dispatch": spans["dispatch"].host_ms, "d2h": d2h.host_ms}
        for name in ("generate", "octree"):
            device_ms = spans[name].device_ms() if name in spans else None
            if device_ms is not None:
                ms[name] = device_ms
        host, batch = pending["host"], pending["batch"]
        parsed = {k: v.numpy() for k, v in host["parsed"].items()}
        gen = {k: v.numpy() for k, v in host.get("gen", {}).items()}
        point_clouds = np.asarray(batch["point_clouds"])

        losses = {"total": 0.0}
        if "completion_loss" in host:
            losses["completion loss"] = float(host["completion_loss"])
            losses["mask loss"] = float(gen.get("mask_loss", 0.0))
            losses["total"] = losses["completion loss"]

        meshes = None
        features, cls_codes = pending.get("decoder_inputs") or (None, None)
        with span("tester.mesh") as s:
            if gen and "grids" in host:
                meshes = self.generator.meshes_from_grids(
                    host["grids"].numpy(), gen["valid"].reshape(-1),
                    features, cls_codes)
            elif gen and octree is not None:
                meshes = self.generator.meshes_from(
                    octree, gen["valid"].reshape(-1), features, cls_codes)
        ms["mesh"] = s.host_ms
        refit_sizes = {}
        with span("tester.refit") as s:
            if gen and meshes is not None and self.fit_to_scan:
                parsed = fit_meshes_to_scan(
                    parsed, meshes, gen["proposal_ids"], gen["valid"],
                    point_clouds, self.dump_threshold, device=self.device,
                    stats=refit_sizes)
        ms["refit"] = s.host_ms

        mesh_pairs = gt_mesh_pairs = None
        if self.evaluate_mesh_mAP and meshes is not None:
            with span("tester.voxelize") as s:
                voxel_size = float(point_clouds[0, :, 2].max()
                                   - point_clouds[0, :, 2].min()) / 46.0
                mesh_pairs = self._voxelize_meshes(meshes, parsed, gen,
                                                   voxel_size)
                gt_mesh_pairs = self._voxelize_gt_meshes(batch, voxel_size)
            ms["voxelize"] = s.host_ms

        with span("tester.ap") as s:
            iou_stats, batch_pred, batch_gt = self._assemble(
                host, batch, parsed, gen, mesh_pairs, gt_mesh_pairs)
        ms["ap"] = s.host_ms
        return {
            "losses": losses,
            "batch_pred_map_cls": batch_pred,
            "batch_gt_map_cls": batch_gt,
            "iou_stats": iou_stats,
            "meshes": meshes,
            "parsed": parsed,
            "gen": gen,
            "ms": ms,
            "refit_sizes": refit_sizes,
        }

    def _assemble(self, host, batch, parsed, gen, mesh_pairs,
                  gt_mesh_pairs):
        """The voxel IoU of the valid slots and the AP's (class, box[,
        mesh], score) tuples of the scene."""
        iou_stats = None
        if gen and "shape_voxels_bits" in host and "object_voxels" in batch:
            B, G, _ = gen["proposal_ids"].shape
            voxels = np.unpackbits(host["shape_voxels_bits"].numpy(),
                                   axis=-1).reshape(B * G, 16, 16, 16)
            gt_ids = gen["proposal_ids"][..., 1].reshape(-1)
            gt_vox = np.asarray(batch["object_voxels"])[
                np.repeat(np.arange(B), G), gt_ids]
            valid = gen["valid"].reshape(-1).astype(bool)
            iou_stats = {
                "cls": gen["proposal_ids"][..., 2].reshape(-1)[valid],
                "iou": compute_iou(voxels[valid], gt_vox[valid]),
            }
        ec = self.eval_config
        batch_pred = assembly_pred_map_cls(
            parsed, conf_thresh=ec["conf_thresh"],
            per_class_proposal=ec["per_class_proposal"], meshes=mesh_pairs,
            proposal_ids=gen.get("proposal_ids"))
        batch_gt = assembly_gt_map_cls(parse_groundtruths(batch),
                                       meshes=gt_mesh_pairs)
        return iou_stats, batch_pred, batch_gt

    def _voxelize_meshes(self, meshes, parsed, gen, voxel_size):
        """(B, G) nested lists: each valid slot's non-empty mesh placed in
        its proposal's box (scan frame) and voxelized, else None."""
        B, G, _ = gen["proposal_ids"].shape
        corners = parsed["pred_corners_3d_upright_camera"]

        def job(i, g):
            mesh = meshes[i * G + g]
            if not gen["valid"][i, g] or len(mesh.vertices) == 0:
                return None
            j = int(gen["proposal_ids"][i, g, 0])
            placed = place_mesh_in_box(mesh, corners[i, j])
            return voxelize_mesh_pair(placed.vertices, placed.faces,
                                      voxel_size)

        pairs = list(self._pool.map(
            lambda a: job(*a), [(i, g) for i in range(B) for g in range(G)]))
        return [pairs[i * G:(i + 1) * G] for i in range(B)]

    def _voxelize_gt_meshes(self, batch, voxel_size):
        """(B, objects) nested lists: each GT object's watertight mesh
        placed in its GT box and voxelized, None where the file is
        missing."""
        from ..meshing.mesh import TriMesh

        root = os.path.join(self.cfg["data"]["shapenet_path"],
                            "watertight_scaled_simplified")
        corners = parse_groundtruths(batch)["gt_corners_3d_upright_camera"]

        def job(i, j, cat, sid):
            path = os.path.join(root, cat, sid + ".off")
            if not os.path.exists(path):
                return None
            mesh = place_mesh_in_box(TriMesh.load(path), corners[i, j])
            return voxelize_mesh_pair(mesh.vertices, mesh.faces, voxel_size)

        return [list(self._pool.map(
            lambda a: job(i, a[0], *a[1]), enumerate(zip(cats, ids))))
            for i, (cats, ids) in enumerate(zip(batch["shapenet_catids"],
                                                batch["shapenet_ids"]))]

    # -------------------------------------------------------------- dumps
    def visualize_step(self, out: dict, batch: dict, scene_dir: str):
        """Per-scene dumps: the scan (`000000_pc.ply`), the confident NMS
        boxes (`000000_pred_confident_nms_bbox.ply`), each valid slot's
        mesh placed in its box (`proposal_<j>_mesh.ply`), the interactive
        WebGL view of them (`scene.html`), and the pred/gt (class, box,
        score) lists (`pred_map_cls.txt`, `gt_map_cls.txt`). A failed
        `scene.html` is logged ("export failed") and does not stop the
        run."""
        from ..meshing.mesh import write_ply
        from ..utils.visualization import write_oriented_bbox_ply

        os.makedirs(scene_dir, exist_ok=True)
        pc = np.asarray(batch["point_clouds"])[0, :, :3]
        write_ply(os.path.join(scene_dir, "000000_pc.ply"), pc,
                  np.zeros((0, 3), np.int32))

        parsed, gen = out["parsed"], out.get("gen") or {}
        keep = np.nonzero(
            parsed["pred_mask"][0]
            & (parsed["obj_prob"][0] > self.eval_config["conf_thresh"]))[0]
        if len(keep):
            write_oriented_bbox_ply(
                os.path.join(scene_dir, "000000_pred_confident_nms_bbox.ply"),
                flip_axis_to_depth(
                    parsed["pred_corners_3d_upright_camera"][0, keep]))
        if gen and out["meshes"] is not None:
            for g in range(gen["proposal_ids"].shape[1]):
                if not gen["valid"][0, g]:
                    continue
                j = int(gen["proposal_ids"][0, g, 0])
                mesh = out["meshes"][g]
                if len(mesh.vertices):
                    place_mesh_in_box(
                        mesh, parsed["pred_corners_3d_upright_camera"][0, j]
                    ).export(os.path.join(scene_dir,
                                          f"proposal_{j}_mesh.ply"))
        # the interactive WebGL inspector: the scan, each confident NMS
        # box and its placed mesh, colored by predicted class
        try:
            mesh_by_pid = {}
            if gen and out["meshes"] is not None:
                for g in range(gen["proposal_ids"].shape[1]):
                    mesh = out["meshes"][g]
                    if gen["valid"][0, g] and len(mesh.vertices):
                        mesh_by_pid[int(gen["proposal_ids"][0, g, 0])] = mesh
            corners = parsed["pred_corners_3d_upright_camera"][0]
            centers, vectors, cls_ids, placed = [], [], [], []
            for j in keep:
                c, vec = corners_to_center_vectors(flip_axis_to_depth(
                    corners[j]))
                centers.append(c)
                vectors.append(vec)
                cls_ids.append(int(parsed["pred_sem_cls"][0, j]))
                if j in mesh_by_pid:
                    m = place_mesh_in_box(mesh_by_pid[j], corners[j])
                    placed.append((flip_axis_to_depth(np.asarray(m.vertices)),
                                   np.asarray(m.faces)))
                else:
                    placed.append((np.zeros((0, 3)),
                                   np.zeros((0, 3), np.int64)))
            SceneRender(pc, meshes=placed, centers=centers, vectors=vectors,
                        class_ids=cls_ids).export_html(
                os.path.join(scene_dir, "scene.html"),
                title=os.path.basename(scene_dir),
                class_names=[CLASS2TYPE[c] for c in sorted(CLASS2TYPE)])
        except Exception as e:  # a dump never fails the evaluation
            self.log(f"[tester] scene.html export failed: {e!r}")

        with open(os.path.join(scene_dir, "pred_map_cls.txt"), "w") as f:
            for item in out["batch_pred_map_cls"][0]:
                f.write(f"{item[0]} {item[-1]} "
                        + " ".join(map(str, np.asarray(item[1]).ravel()))
                        + "\n")
        with open(os.path.join(scene_dir, "gt_map_cls.txt"), "w") as f:
            for item in out["batch_gt_map_cls"][0]:
                f.write(f"{item[0]} "
                        + " ".join(map(str, np.asarray(item[1]).ravel()))
                        + "\n")

    # ----------------------------------------------------------------- run
    def _finish(self, pending: dict, dump_dir, n: int) -> dict:
        """`consume_step` and the scene's dumps, on the worker's stream."""
        with (torch.cuda.stream(self._stream) if self._stream is not None
              else contextlib.nullcontext()):
            if self._stream is not None:
                # made on the main stream, read by refine and normals here
                for x in pending.get("decoder_inputs") or ():
                    x.record_stream(self._stream)
            out = self.consume_step(pending)
            if dump_dir is not None:
                batch = pending["batch"]
                scan_idx = int(np.asarray(batch.get("scan_idx", [n]))[0])
                with profiling.recording(self.recorder), span(
                        "tester.dump", unit=pending["unit"]) as s:
                    self.visualize_step(out, batch, os.path.join(
                        dump_dir, f"scene_{scan_idx:05d}"))
                out["ms"]["dump"] = s.host_ms
        return out

    def run(self, loader, ap_iou_thresholds=(0.5,), max_scenes=None,
            dump_dir=None, overlap: bool = True):
        """A full evaluation pass -> metrics: `<class> Average Precision
        @<t>`, `<class> Recall @<t>`, `mAP @<t>`, `AR @<t>` for each
        threshold and `<class> voxel IoU`, and with the mesh mAP the same
        of the mesh IoU (`<class> Average Precision_mesh @<t>`, `mAP_mesh
        @<t>`, `AR_mesh @<t>`). With `overlap` one scene is in
        flight while the next one's device work is queued; without, the
        scenes run one after the other. `scene_ms` receives each scene's
        stage times, `refit_sizes` the sizes of its refit (see
        `fit_meshes_to_scan`), `run_ms` the host-clock time of the scenes (loading
        included, the final AP computation not), `metrics_ms` that of the
        final AP computation."""
        calculators = {
            t: APCalculator(t, CLASS2TYPE, mesh_iou_func=(
                mesh_iou if self.evaluate_mesh_mAP else None))
            for t in ap_iou_thresholds}
        cls_iou_stats = {}
        self.scene_ms, self.refit_sizes = [], []
        done = 0

        def account(out):
            nonlocal done
            for calc in calculators.values():
                calc.step(out["batch_pred_map_cls"], out["batch_gt_map_cls"])
            if out["iou_stats"] is not None:
                for c, i in zip(out["iou_stats"]["cls"],
                                out["iou_stats"]["iou"]):
                    cls_iou_stats.setdefault(int(c), []).append(float(i))
            self.scene_ms.append(out["ms"])
            self.refit_sizes.append(out["refit_sizes"])
            done += 1
            if done % 10 == 0:
                self.log(f"evaluated {done} scenes")

        t_run = time.perf_counter()
        with ThreadPoolExecutor(1) as worker:
            in_flight = None
            for n, batch in enumerate(loader):
                if max_scenes is not None and n >= max_scenes:
                    break
                pending = self.dispatch_step(batch)
                if in_flight is not None:
                    account(in_flight.result())
                    in_flight = None
                if overlap:
                    in_flight = worker.submit(self._finish, pending,
                                              dump_dir, n)
                else:
                    account(self._finish(pending, dump_dir, n))
            if in_flight is not None:
                account(in_flight.result())
        self.run_ms = _ms(t_run)

        t0 = time.perf_counter()
        metrics = {}
        for t, calc in calculators.items():
            for k, v in calc.compute_metrics().items():
                metrics[f"{k} @{t}"] = v
        for c, vals in sorted(cls_iou_stats.items()):
            metrics[f"{CLASS2TYPE.get(c, str(c))} voxel IoU"] = float(
                np.mean(vals))
        self.metrics_ms = _ms(t0)
        return metrics
