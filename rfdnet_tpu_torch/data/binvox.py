"""Minimal .binvox reader/writer (the public run-length binvox format).

The port's own copy of `rfdnet_tpu/data/binvox.py`. Header: `#binvox 1`,
`dim`, `translate`, `scale`, `data`; payload: byte pairs [value, count]
in x, z, y order (index = x*d*d + z*d + y).
"""

from __future__ import annotations

import numpy as np


class Voxels:
    def __init__(self, data: np.ndarray, dims, translate, scale):
        self.data = data
        self.dims = list(dims)
        self.translate = list(translate)
        self.scale = float(scale)


def read_binvox(f) -> Voxels:
    """f: binary file object -> Voxels with data as (dx, dy, dz) bool in
    xyz order."""
    line = f.readline().strip()
    if not line.startswith(b"#binvox"):
        raise OSError("not a binvox file")
    dims = translate = None
    scale = 1.0
    while True:
        line = f.readline().strip().split()
        if not line:
            continue
        if line[0] == b"dim":
            dims = [int(x) for x in line[1:4]]
        elif line[0] == b"translate":
            translate = [float(x) for x in line[1:4]]
        elif line[0] == b"scale":
            scale = float(line[1])
        elif line[0] == b"data":
            break
    raw = np.frombuffer(f.read(), dtype=np.uint8)
    values, counts = raw[::2], raw[1::2].astype(np.int64)
    flat = np.repeat(values, counts).astype(bool)
    flat = flat[:dims[0] * dims[1] * dims[2]]
    # file order is x, z, y -> transpose to x, y, z
    data = flat.reshape(dims[0], dims[2], dims[1]).transpose(0, 2, 1)
    return Voxels(data, dims, translate or [0.0, 0.0, 0.0], scale)


def write_binvox(f, voxels: Voxels) -> None:
    data = np.asarray(voxels.data, dtype=bool)
    dx, dy, dz = data.shape
    f.write(b"#binvox 1\n")
    f.write(f"dim {dx} {dy} {dz}\n".encode())
    t = voxels.translate
    f.write(f"translate {t[0]} {t[1]} {t[2]}\n".encode())
    f.write(f"scale {voxels.scale}\n".encode())
    f.write(b"data\n")
    flat = data.transpose(0, 2, 1).ravel()
    # run-length encode with max run 255
    change = np.nonzero(np.diff(flat))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(flat)]])
    out = bytearray()
    for s, e in zip(starts, ends):
        v = int(flat[s])
        n = e - s
        while n > 0:
            c = min(n, 255)
            out.append(v)
            out.append(c)
            n -= c
    f.write(bytes(out))
