"""ScanNet + Scan2CAD dataset (host-side numpy) and its batch loader.

The port's own copy of `rfdnet_tpu/data/scannet.py`:
- a split JSON lists each scene's `full_scan.npz` (points, per-point votes
  (N x 10: mask + 3 votes), instance labels) and `bbox.pkl` (oriented
  boxes [center(3), size(3), heading], class, ShapeNet ids, instance ids);
- an item appends the height feature (floor = 0.99-percentile z),
  augments in train mode, subsamples to `num_points`, and pads the box
  targets to MAX_NUM_OBJ; the completion phase adds each object's
  occupancy points and 16^3 voxels, test mode its full point set;
- every item draws from its own `np.random.Generator(PCG64(SeedSequence(
  [seed, epoch, index])))`, the stream of the JAX package, so both
  packages draw the same points.

`DataLoader` assembles items in a pool of worker processes or threads
(`worker_type`) and collates them in a background thread. Both routes give
the same batches: an item depends only on (seed, epoch, index).
"""

from __future__ import annotations

import contextlib
import json
import multiprocessing
import os
import pickle
import queue
import threading
import weakref
from collections import OrderedDict
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

from ..config import MEAN_SIZE_ARR, SHAPENETID2CLASS, angle2class
from ..collectives import shard_rows
from .binvox import read_binvox
from .transforms import random_sampling, rotz, subsample_points

MAX_NUM_OBJ = 64
MEAN_COLOR_RGB = np.array([121.87661, 109.73591, 95.61673])


class ScanNetDataset:
    """Map-style dataset over preprocessed ScanNet scenes."""

    def __init__(self, split_file: str, *, mode: str = "train",
                 phase: str = "detection", num_points: int = 80_000,
                 use_color_detection: bool = False,
                 use_color_completion: bool = False,
                 use_height: bool = True,
                 points_subsample=(1024, 1024),
                 points_unpackbits: bool = True,
                 shapenet_path: str | None = None,
                 root: str | None = None,
                 seed: int = 10,
                 augment: bool | None = None,
                 cache_scans: int = 0,
                 cache_shapenet: int = 256):
        """cache_scans / cache_shapenet: LRU caches (entry counts) of
        decoded scan npz / per-object occupancy and voxel files."""
        with open(split_file) as f:
            self.split = json.load(f)
        self.root = root or os.path.dirname(os.path.abspath(split_file))
        self.mode = mode
        self.phase = phase
        self.num_points = num_points
        self.use_color = use_color_detection or use_color_completion
        self.use_height = use_height
        self.points_subsample = list(points_subsample)
        self.points_unpackbits = points_unpackbits
        self.shapenet_path = shapenet_path
        self.augment = (mode == "train") if augment is None else augment
        self.seed = seed
        self.epoch = 0
        self.cache_scans = int(cache_scans)
        self.cache_shapenet = int(cache_shapenet)
        self._init_caches()

    def _init_caches(self):
        self._scan_cache = OrderedDict()
        self._shp_cache = OrderedDict()
        self._cache_lock = threading.Lock()

    def __getstate__(self):
        # what a process worker receives: the caches start empty there
        st = dict(self.__dict__)
        for k in ("_scan_cache", "_shp_cache", "_cache_lock"):
            st[k] = None
        return st

    def __setstate__(self, st):
        self.__dict__.update(st)
        self._init_caches()

    def _lru_get(self, cache, key, cap, load):
        if cap <= 0:
            return load()
        with self._cache_lock:
            hit = cache.get(key)
            if hit is not None:
                cache.move_to_end(key)
                return hit
        val = load()
        with self._cache_lock:
            cache[key] = val
            while len(cache) > cap:
                cache.popitem(last=False)
        return val

    def __len__(self) -> int:
        return len(self.split)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _resolve(self, path: str) -> str:
        return path if os.path.isabs(path) else os.path.join(self.root, path)

    # ------------------------------------------------------------ assembly
    def __getitem__(self, idx: int) -> dict:
        rng = np.random.Generator(
            np.random.PCG64(np.random.SeedSequence([self.seed, self.epoch, idx])))
        entry = self.split[idx]

        def load_scene():
            with open(self._resolve(entry["bbox"]), "rb") as f:
                box_info = pickle.load(f)
            scan = np.load(self._resolve(entry["scan"]))
            return {
                "boxes3D": np.array([it["box3D"] for it in box_info],
                                    dtype=np.float64),
                "classes": [it["cls_id"] for it in box_info],
                "shapenet_catids": [it["shapenet_catid"] for it in box_info],
                "shapenet_ids": [it["shapenet_id"] for it in box_info],
                "instance_ids": np.array(
                    [it["instance_id"] for it in box_info], dtype=np.float64),
                "mesh_vertices": scan["mesh_vertices"],
                "point_votes": np.array(scan["point_votes"]),
                "instance_labels": scan["instance_labels"],
            }

        # every consumer below copies before it writes, so cached arrays
        # stay as loaded
        scene = self._lru_get(self._scan_cache, entry["scan"],
                              self.cache_scans, load_scene)
        boxes3D = scene["boxes3D"]
        shapenet_catids = scene["shapenet_catids"]
        shapenet_ids = scene["shapenet_ids"]
        point_cloud = scene["mesh_vertices"]
        point_votes = scene["point_votes"]  # (N, 10): mask + 3 votes

        if not self.use_color:
            point_cloud = point_cloud[:, 0:3]
        else:
            point_cloud = point_cloud[:, 0:6].copy()
            point_cloud[:, 3:] = (point_cloud[:, 3:] - MEAN_COLOR_RGB) / 256.0

        if self.use_height:
            floor = np.percentile(point_cloud[:, 2], 0.99)
            point_cloud = np.concatenate(
                [point_cloud, (point_cloud[:, 2] - floor)[:, None]], axis=1)

        if self.augment:
            point_cloud, boxes3D, point_votes = self._augment(
                rng, point_cloud, boxes3D, point_votes)

        class_ind = np.array([SHAPENETID2CLASS[c] for c in scene["classes"]],
                             dtype=np.int64)
        n_obj = len(boxes3D)

        def pad(arr, shape, dtype):
            out = np.zeros(shape, dtype)
            out[:n_obj] = arr
            return out

        hc, hr = angle2class(boxes3D[:, 6])

        point_cloud, choices = random_sampling(
            point_cloud, self.num_points, rng=rng, return_choices=True)
        ret = {
            "point_clouds": point_cloud.astype(np.float32),
            "center_label": pad(boxes3D[:, 0:3], (MAX_NUM_OBJ, 3), np.float32),
            "heading_class_label": pad(hc, (MAX_NUM_OBJ,), np.int64),
            "heading_residual_label": pad(hr, (MAX_NUM_OBJ,), np.float32),
            "size_class_label": pad(class_ind, (MAX_NUM_OBJ,), np.int64),
            "size_residual_label": pad(
                boxes3D[:, 3:6] - MEAN_SIZE_ARR[class_ind], (MAX_NUM_OBJ, 3),
                np.float32),
            "sem_cls_label": pad(class_ind, (MAX_NUM_OBJ,), np.int64),
            "box_label_mask": pad(np.ones(n_obj), (MAX_NUM_OBJ,), np.float32),
            "vote_label": point_votes[choices, 1:].astype(np.float32),
            "vote_label_mask": point_votes[choices, 0].astype(np.int64),
            "scan_idx": np.int64(idx),
        }

        if self.phase == "completion":
            T = int(np.sum(self.points_subsample))
            pts, occ = self._load_shapenet_points(
                shapenet_catids, shapenet_ids, rng, subsample=True)
            ret["object_points"] = pad(pts, (MAX_NUM_OBJ, T, 3), np.float32)
            ret["object_points_occ"] = pad(occ, (MAX_NUM_OBJ, T), np.float32)
            ret["object_instance_labels"] = pad(
                scene["instance_ids"], (MAX_NUM_OBJ,), np.float32)
            ret["point_instance_labels"] = scene["instance_labels"][
                choices].astype(np.float32)
            vox = self._load_shapenet_voxels(shapenet_catids, shapenet_ids)
            ret["object_voxels"] = pad(vox, (MAX_NUM_OBJ,) + vox.shape[1:],
                                       np.float32)
            if self.mode == "test":
                pts_iou, occ_iou = self._load_shapenet_points(
                    shapenet_catids, shapenet_ids, rng, subsample=False)
                n_iou = occ_iou.shape[-1]
                ret["object_points_iou"] = pad(
                    pts_iou, (MAX_NUM_OBJ, n_iou, 3), np.float32)
                ret["object_points_iou_occ"] = pad(
                    occ_iou, (MAX_NUM_OBJ, n_iou), np.float32)
                ret["shapenet_catids"] = shapenet_catids
                ret["shapenet_ids"] = shapenet_ids
        return ret

    def _augment(self, rng, point_cloud, boxes3D, point_votes):
        """Train-time flips and z rotation in one pass: the votes are
        offsets, so rotating them is rotating the vote block."""
        point_cloud = point_cloud.copy()
        boxes3D = boxes3D.copy()
        mask = point_votes[:, 0:1]
        votes = point_votes[:, 1:].reshape(-1, 3, 3).copy()  # (N, 3 votes, 3)
        if rng.random() > 0.5:  # flip x (YZ plane)
            point_cloud[:, 0] *= -1
            boxes3D[:, 0] *= -1
            boxes3D[:, 6] = np.sign(boxes3D[:, 6]) * np.pi - boxes3D[:, 6]
            votes[:, :, 0] *= -1
        if rng.random() > 0.5:  # flip y (XZ plane)
            point_cloud[:, 1] *= -1
            boxes3D[:, 1] *= -1
            boxes3D[:, 6] *= -1
            votes[:, :, 1] *= -1
        angle = rng.random() * np.pi / 2 - np.pi / 4
        R = rotz(angle).astype(point_cloud.dtype)
        point_cloud[:, 0:3] = point_cloud[:, 0:3] @ R.T
        votes = (votes.reshape(-1, 3) @ R.T).reshape(votes.shape)
        boxes3D[:, 0:3] = boxes3D[:, 0:3] @ R.T
        boxes3D[:, 6] += angle
        boxes3D[:, 6] = np.mod(boxes3D[:, 6] + np.pi, 2 * np.pi) - np.pi
        out_votes = np.concatenate([mask, votes.reshape(-1, 9)], axis=1)
        return point_cloud, boxes3D, out_votes

    # ------------------------------------------------------- shapenet data
    def _get_shapenet_points_raw(self, catid, sid):
        """(points in their stored dtype, unpacked occupancies), cached."""

        def load():
            d = np.load(os.path.join(self.shapenet_path, "point", catid,
                                     sid + ".npz"))
            points = d["points"]
            occ = d["occupancies"]
            if self.points_unpackbits:
                occ = np.unpackbits(occ)[: points.shape[0]]
            return points, occ

        return self._lru_get(self._shp_cache, (catid, sid),
                             self.cache_shapenet, load)

    def _load_shapenet_points(self, catids, ids, rng, subsample: bool):
        pts_list, occ_list = [], []
        for catid, sid in zip(catids, ids):
            points, occ = self._get_shapenet_points_raw(catid, sid)
            if subsample:
                # subsample first, then cast and add the dequantization
                # noise to the chosen rows only
                points, occ, _ = subsample_points(
                    points, occ, self.points_subsample, self.mode,
                    rng=_LegacyRng(rng))
                was_f16 = points.dtype == np.float16
                points = points.astype(np.float32)
                if was_f16 and self.mode == "train":
                    points = points + 1e-4 * rng.standard_normal(points.shape)
                occ = np.asarray(occ, np.float32)
            else:
                points = points.astype(np.float32)
                occ = occ.astype(np.float32)
            pts_list.append(points)
            occ_list.append(occ)
        return np.stack(pts_list), np.stack(occ_list)

    def _load_shapenet_voxels(self, catids, ids):
        out = []
        for catid, sid in zip(catids, ids):
            p = os.path.join(self.shapenet_path, "voxel", "16", catid,
                             sid + ".binvox")

            def load(p=p):
                with open(p, "rb") as f:
                    return read_binvox(f).data.astype(np.float32)

            out.append(self._lru_get(self._shp_cache, ("vox", catid, sid),
                                     self.cache_shapenet, load))
        return np.stack(out) if out else np.zeros((0, 16, 16, 16), np.float32)


class _LegacyRng:
    """Adapter: np.random.Generator -> the randint/choice surface the
    transforms use."""

    def __init__(self, gen):
        self.gen = gen

    def randint(self, high, size=None):
        return self.gen.integers(0, high, size=size)

    def choice(self, n, size, replace=True):
        return self.gen.choice(n, size, replace=replace)


# ------------------------------------------------------------------ loader
_STR_KEYS = ("shapenet_catids", "shapenet_ids")


def collate(items: list[dict]) -> dict:
    """Stack a list of item dicts into fixed-shape numpy batches; string
    lists stay Python lists."""
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if k in _STR_KEYS:
            out[k] = vals
        else:
            out[k] = np.stack([np.asarray(v) for v in vals])
    return out


_PROC_DATASET = None


def _proc_worker_init(ds_bytes: bytes) -> None:
    """Process-pool initializer: unpickle the dataset once a worker (a
    bound method submitted per item would pickle the whole dataset each
    time)."""
    global _PROC_DATASET
    _PROC_DATASET = pickle.loads(ds_bytes)


def _proc_getitem(i: int, epoch):
    """Item `i` of the worker's dataset at `epoch` (the parent's epoch when
    the item was asked for)."""
    if epoch is not None:
        _PROC_DATASET.set_epoch(epoch)
    return _PROC_DATASET[i]


class DataLoader:
    """Prefetching batch loader: a pool of `num_workers` workers assembles
    items, a background thread collates them into batches (a queue of
    `prefetch` batches), so host assembly overlaps the device's work. An
    item's failure is raised by the iterator.

    worker_type: "process" (worker processes, each holding an unpickled
    copy of the dataset and receiving item indices), "thread", or "auto"
    (processes when more than one worker and more than one core, else
    threads), as the JAX package's loader. The workers come from the
    `forkserver` start method: the parent has CUDA's and the producer's
    threads, which `fork` would copy in an undefined state, and a `spawn`ed
    worker imports torch (through this package) anew, seconds each. The
    fork server is a fresh single-threaded process, started once for the
    parent's life, that imports this module (and torch) once; each pool's
    workers fork from it. The pool starts at the loader's first pass and
    serves the next ones, the dataset as it was pickled then, at the epoch
    of each request; `close()` stops it, and so does the loader's
    collection.

    shard (rank, world): the loader of one rank of a data-parallel run
    reads and yields only that rank's rows of each global batch of
    `batch_size` (`collectives.shard_rows`), in the same order; the
    batches and their count stay the global ones'."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 8,
                 seed: int = 0, prefetch: int = 2,
                 worker_type: str = "auto", shard: tuple = (0, 1)):
        if worker_type not in ("auto", "process", "thread"):
            raise ValueError(f"worker_type {worker_type!r}: 'auto', "
                             "'process' or 'thread'")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, min(num_workers, os.cpu_count() or 1))
        self.seed = seed
        self.prefetch = prefetch
        if worker_type == "auto":
            worker_type = ("process" if self.num_workers > 1
                           and (os.cpu_count() or 1) > 1 else "thread")
        self.worker_type = worker_type
        self.shard = tuple(shard)
        self._epoch = 0
        self._pool = None

    def _process_pool(self) -> ProcessPoolExecutor:
        if self._pool is None:
            ctx = multiprocessing.get_context("forkserver")
            # read when the server starts (once a process)
            ctx.set_forkserver_preload([__name__])
            self._pool = ProcessPoolExecutor(
                self.num_workers, mp_context=ctx,
                initializer=_proc_worker_init,
                initargs=(pickle.dumps(self.dataset),))
            weakref.finalize(self, self._pool.shutdown, cancel_futures=True)
        return self._pool

    def close(self) -> None:
        """Stop the worker processes (a later pass starts new ones)."""
        if self._pool is not None:
            self._pool.shutdown(cancel_futures=True)
            self._pool = None

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def batch_rows(self, i: int) -> int:
        """The rows of global batch i, all ranks together."""
        return min(self.batch_size, len(self.dataset) - i * self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.Generator(
                np.random.PCG64(np.random.SeedSequence([self.seed, self._epoch]))
            ).shuffle(order)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        rank, world = self.shard
        if world > 1:
            if any(len(b) < world for b in batches):
                raise ValueError(f"a batch of {min(map(len, batches))} rows "
                                 f"cannot give each of {world} ranks one")
            batches = [b[shard_rows(len(b), rank, world)] for b in batches]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        if self.worker_type == "process" and self.num_workers > 1:
            pool = self._process_pool()
            epoch = getattr(self.dataset, "epoch", None)
            submit = lambda i: pool.submit(_proc_getitem, int(i), epoch)
            owned = contextlib.nullcontext()
        else:
            pool = owned = ThreadPoolExecutor(self.num_workers)
            submit = lambda i: pool.submit(self.dataset.__getitem__, i)

        def produce():
            try:
                with owned:
                    # item futures run ahead across batch boundaries
                    pending = [submit(i) for b in batches[:2] for i in b]
                    for bi, b in enumerate(batches):
                        if stop.is_set():
                            break
                        items = [pending.pop(0).result() for _ in b]
                        if bi + 2 < len(batches):
                            pending.extend(submit(i) for i in batches[bi + 2])
                        q.put(collate(items))
            except Exception as e:  # handed to the consumer
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
