"""Furthest point sampling, plain torch on any device: the first index is
0; points with ||p||^2 <= 1e-3 are never candidates; the running
min-distance starts at 1e10; each step takes the argmax of the
min-distance, ties to the lowest index."""

from __future__ import annotations

import torch


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz (B, N, 3) -> (B, npoint) int32 indices into N: the plain torch
    version of the kernel, on any device."""
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

