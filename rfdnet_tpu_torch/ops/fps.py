"""Furthest point sampling (FPS).

Counterpart of `rfdnet_tpu/ops/fps.py`. On a CUDA tensor it launches the
hand-written kernel `csrc/fps.cu` (the port of the Pallas kernel
`_fps_kernel`/`_fps_pallas`); on a CPU tensor it runs `fps_plain`, the
torch version of `_fps_xla`'s loop. Both share the JAX package's
semantics exactly:
- the first selected index is 0;
- points with ||p||^2 <= 1e-3 are never candidates;
- the running min-distance starts at 1e10;
- each step takes the argmax of the min-distance, ties to the LOWEST index.
"""

from __future__ import annotations

import ctypes

import torch

from . import _native


def fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """The plain torch version of the kernel, on any device."""
    B, N, _ = xyz.shape
    xyz = xyz.float()
    x, y, z = xyz.unbind(-1)
    cand = (x * x + y * y + z * z) > 1e-3
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


def _fps_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    B, N = xyz.shape[0], xyz.shape[1]
    _native.check_tensor(xyz, "xyz", torch.float32, (B, N, 3), xyz.device)
    if npoint < 1 or N < 1:
        raise ValueError(f"fps: npoint={npoint}, N={N}")
    lib = _native.load("fps")
    fn = lib.rfd_fps_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    mind = torch.empty((B, N), dtype=torch.float32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        err = fn(_native.ptr(xyz), _native.ptr(mind), _native.ptr(out),
                 B, N, npoint, _native.stream(xyz.device))
    _native.check_launch(err, "fps")
    furthest_point_sample.launches += 1
    return out


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz (B, N, 3) float32 -> (B, npoint) int32 indices into N.

    A CUDA tensor goes to the kernel (contiguous float32 required), a CPU
    tensor to the plain version."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint)
    return _fps_cuda(xyz, npoint)


furthest_point_sample.launches = 0
