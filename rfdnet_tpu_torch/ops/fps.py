"""Furthest point sampling (FPS).

Counterpart of `rfdnet_tpu/ops/fps.py`. On a CUDA tensor it launches a
hand-written kernel of `csrc/fps.cu` (the port of the Pallas kernel
`_fps_kernel`/`_fps_pallas`); on a CPU tensor it runs `fps_plain`, the
torch version of `_fps_xla`'s loop. Both share the JAX package's
semantics exactly:
- the first selected index is 0;
- with `skip_near_origin` (the default, the reference kernel's
  exclusion) points with ||p||^2 <= 1e-3 are never candidates; without
  it every point is;
- the running min-distance starts at 1e10;
- each step takes the argmax of the min-distance, ties to the LOWEST index.

`fps_route(n)` says which kernel a cloud of n points takes and how it is
launched: the resident kernel (the cloud in registers across one
thread-block cluster per scene) up to `RESIDENT_CAPACITY` points, the
streaming kernel (one CTA, the cloud in device memory) above it.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..utils.profiling import count
from . import _native

SHARED_LIMIT = 232448      # bytes of shared memory one CTA can use (227 KB)
REGISTER_FILE = 65536      # 32-bit registers of one SM
REGISTER_HEADROOM = 24     # registers a thread needs beside its points
MAX_CLUSTER = 16
# warp slots, CTA slots and mbarriers, each twice (step parity)
_STATIC_SHARED = 2 * (2 * 32 * 4 + MAX_CLUSTER * 32 + 8)


@dataclass(frozen=True)
class FpsRoute:
    """How one FPS call is launched. `kind` is "resident" (each scene one
    cluster of `cluster` CTAs of `threads` threads, `ppt` points a thread
    in registers) or "streaming" (one CTA a scene, the cloud in device
    memory; `ppt` is 0 there)."""

    kind: str
    cluster: int
    threads: int
    ppt: int

    @property
    def capacity(self) -> int:
        """The most points a scene may have on this route."""
        if self.kind == "streaming":
            return 2 ** 31 // 3
        return self.cluster * self.threads * self.ppt

    @property
    def shared_bytes(self) -> int:
        """Shared memory of one CTA: the copy of its points' coordinates
        (the winner's are looked up there) and the reduction slots."""
        return 12 * self.threads * self.ppt + _STATIC_SHARED

    @property
    def point_registers(self) -> int:
        """Registers a thread spends on its points (x, y, z, min dist)."""
        return 4 * self.ppt

    @property
    def register_limit(self) -> int:
        """Registers a thread may have at this block size."""
        return min(255, REGISTER_FILE // self.threads)


# Resident routes in order of capacity; a cloud takes the first that holds
# it. Chosen from `tools/sweep_fps_routes.py` on an NVIDIA H100 80GB HBM3
# at 700 W. Up to 4096 points a step is latency and one CTA of 8 warps is
# fastest: the exchange between the CTAs of a cluster costs more than the
# shorter per-thread scan saves. Above, the scan is what a step costs and
# a cluster of 8 or 16 CTAs divides it; 8 to 16 warps a CTA beat 32 (the
# block barrier and the warp-slot reduction grow with the warps).
RESIDENT_ROUTES = tuple(FpsRoute("resident", c, t, p) for c, t, p in (
    (1, 256, 2), (1, 256, 4), (1, 256, 8), (1, 256, 16),
    (8, 256, 4), (16, 256, 4), (16, 256, 8), (16, 256, 16), (16, 512, 10),
    (16, 512, 16), (16, 512, 20), (16, 512, 24),
))
STREAMING_ROUTE = FpsRoute("streaming", 1, 1024, 0)
RESIDENT_CAPACITY = RESIDENT_ROUTES[-1].capacity
# Batches of BATCH_MIN scenes or more take, in place of a route, the one
# it maps to. Chosen from `tools/sweep_fps_routes.py --batch 8` on an
# NVIDIA H100 80GB HBM3 at 700 W: eight 80000-point scenes take 2.68 ms
# on clusters of 8 CTAs x 512 threads x 20 points against 3.12 ms on
# those of 16 x 512 x 10 (2.18 ms for one scene), though the card runs
# all eight clusters at once on either (15 and 14 at most).
BATCH_MIN = 8
BATCH_ROUTES = {FpsRoute("resident", 16, 512, 10):
                FpsRoute("resident", 8, 512, 20)}


def fps_route(n: int, b: int = 1) -> FpsRoute:
    """The route a batch of b clouds of n points takes."""
    for route in RESIDENT_ROUTES:
        if n <= route.capacity:
            return BATCH_ROUTES.get(route, route) if b >= BATCH_MIN else route
    return STREAMING_ROUTE


def fps_plain(xyz: torch.Tensor, npoint: int,
              skip_near_origin: bool = True) -> torch.Tensor:
    """The plain torch version of the kernel, on any device."""
    B, N, _ = xyz.shape
    xyz = xyz.float()
    x, y, z = xyz.unbind(-1)
    cand = ((x * x + y * y + z * z) > 1e-3 if skip_near_origin
            else torch.ones_like(x, dtype=torch.bool))
    mind = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    out = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = xyz[:, 0, :]
    for i in range(1, npoint):
        dx = x - last[:, 0:1]
        dy = y - last[:, 1:2]
        dz = z - last[:, 2:3]
        # same rounding as the kernel: three products, two adds, no FMA
        mind = torch.minimum(mind, dx * dx + dy * dy + dz * dz)
        eff = torch.where(cand, mind, -1.0)
        idx = eff.argmax(dim=1)  # first maximum
        out[:, i] = idx.to(torch.int32)
        last = xyz[rows, idx]
    return out


def launch_route(xyz: torch.Tensor, npoint: int, route: FpsRoute,
                 stub: bool = False, lib=None,
                 skip_near_origin: bool = True) -> torch.Tensor:
    """Launch the kernel of `route` on a CUDA tensor, whatever `fps_route`
    would choose: for `_fps_cuda`, and for measuring one route against
    another. With `stub` (resident routes; `ppt` must be 1) the steps do
    their reductions, barriers and exchange and no point work: the time
    over the steps is the latency of one dependent step on that (cluster,
    threads), and the indices returned mean nothing. `lib` is another
    build of `csrc/fps.cu` to launch from (one with more launch shapes).
    `skip_near_origin` is passed to the kernel as an argument."""
    B, N = xyz.shape[0], xyz.shape[1]
    _native.check_tensor(xyz, "xyz", torch.float32, (B, N, 3), xyz.device)
    if npoint < 1 or N < 1:
        raise ValueError(f"fps: npoint={npoint}, N={N}")
    if N > route.capacity and not stub:
        raise ValueError(f"fps: {N} points exceed {route}")
    lib = lib or _native.load("fps")
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        if route.kind == "resident":
            fn = lib.rfd_fps_resident_launch
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            err = fn(_native.ptr(xyz), _native.ptr(out), B, N, npoint,
                     route.cluster, route.threads, route.ppt, int(stub),
                     int(skip_near_origin), _native.stream(xyz.device))
        else:
            fn = lib.rfd_fps_streaming_launch
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            mind = torch.empty((B, N), dtype=torch.float32, device=xyz.device)
            err = fn(_native.ptr(xyz), _native.ptr(mind), _native.ptr(out),
                     B, N, npoint, int(skip_near_origin),
                     _native.stream(xyz.device))
    _native.check_launch(err, f"fps {route}")
    return out


def active_clusters(route: FpsRoute, b: int, lib=None) -> int:
    """How many clusters of `route`'s launch for b scenes the current CUDA
    device runs at once (`cudaOccupancyMaxActiveClusters`; for a route
    without a cluster, the CTAs it holds at once). Scenes beyond it wait
    for a later wave."""
    if route.kind != "resident":
        raise ValueError(f"active_clusters: {route} has no clusters")
    lib = lib or _native.load("fps")
    fn = lib.rfd_fps_active_clusters
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    count = ctypes.c_int(0)
    _native.check_launch(fn(b, route.cluster, route.threads, route.ppt, 0,
                            ctypes.byref(count)), f"fps occupancy {route}")
    return count.value


def _fps_cuda(xyz: torch.Tensor, npoint: int,
              skip_near_origin: bool = True) -> torch.Tensor:
    out = launch_route(xyz, npoint, fps_route(xyz.shape[1], xyz.shape[0]),
                       skip_near_origin=skip_near_origin)
    count("ops.fps.launches")
    return out


def furthest_point_sample(xyz: torch.Tensor, npoint: int,
                          skip_near_origin: bool = True) -> torch.Tensor:
    """xyz (B, N, 3) float32 -> (B, npoint) int32 indices into N.
    `skip_near_origin`: leave points with ||p||^2 <= 1e-3 out of the
    candidates (the reference kernel's exclusion; off, every point is one).

    A CUDA tensor goes to the kernel that `fps_route` names (contiguous
    float32 required), a CPU tensor to the plain version."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint, skip_near_origin)
    return _fps_cuda(xyz, npoint, skip_near_origin)

