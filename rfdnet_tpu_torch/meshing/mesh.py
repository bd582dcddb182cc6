"""Minimal triangle-mesh container + PLY/OFF I/O.

The port's own copy of `rfdnet_tpu/meshing/mesh.py`: what the demo and the
mesh generator need of a mesh object (vertices, faces, export, bounds,
vertex transforms), with numpy and the standard library only.
"""

from __future__ import annotations

import numpy as np


class TriMesh:
    def __init__(self, vertices, faces, vertex_normals=None):
        self.vertices = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
        self.faces = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
        #: optional (V, 3) unit normals
        self.vertex_normals = (
            None if vertex_normals is None
            else np.asarray(vertex_normals, dtype=np.float64).reshape(-1, 3)
        )

    @property
    def bounds(self):
        if len(self.vertices) == 0:
            return np.zeros((2, 3))
        return np.stack([self.vertices.min(0), self.vertices.max(0)])

    def copy(self):
        return TriMesh(
            self.vertices.copy(), self.faces.copy(),
            None if self.vertex_normals is None
            else self.vertex_normals.copy(),
        )

    def apply_transform(self, matrix4):
        m = np.asarray(matrix4)
        v = self.vertices @ m[:3, :3].T + m[:3, 3]
        self.vertices = v
        return self

    # ------------------------------------------------------------------ IO
    def export(self, path: str):
        if path.endswith(".ply"):
            write_ply(path, self.vertices, self.faces, self.vertex_normals)
        elif path.endswith(".off"):
            write_off(path, self.vertices, self.faces)
        else:
            raise ValueError(f"unsupported mesh format: {path}")

    @staticmethod
    def load(path: str) -> "TriMesh":
        if path.endswith(".ply"):
            return TriMesh(*read_ply(path))
        if path.endswith(".off"):
            return TriMesh(*read_off(path))
        raise ValueError(f"unsupported mesh format: {path}")


def write_ply(path, vertices, faces, vertex_normals=None):
    vertices = np.asarray(vertices)
    faces = np.asarray(faces)
    normal_props = (
        "property float nx\nproperty float ny\nproperty float nz\n"
        if vertex_normals is not None else ""
    )
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(vertices)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            + normal_props +
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        f.write(header.encode())
        if vertex_normals is not None:
            inter = np.concatenate(
                [vertices, np.asarray(vertex_normals)], axis=1
            )
            f.write(inter.astype("<f4").tobytes())
        else:
            f.write(vertices.astype("<f4").tobytes())
        face_block = np.empty(
            (len(faces),),
            dtype=[("n", "u1"), ("idx", "<i4", (3,))],
        )
        face_block["n"] = 3
        face_block["idx"] = faces
        f.write(face_block.tobytes())


def read_ply(path):
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="replace")
    lines = header.splitlines()
    fmt = next(l.split()[1] for l in lines if l.startswith("format"))
    n_vert = n_face = 0
    vert_props = []
    cur = None
    for l in lines:
        parts = l.split()
        if not parts:
            continue
        if parts[0] == "element":
            cur = parts[1]
            if cur == "vertex":
                n_vert = int(parts[2])
            elif cur == "face":
                n_face = int(parts[2])
        elif parts[0] == "property" and cur == "vertex" and parts[1] != "list":
            vert_props.append((parts[2], parts[1]))
    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4"}
    if fmt == "ascii":
        body = data[header_end:].decode().split("\n")
        verts = np.array(
            [[float(x) for x in body[i].split()[:3]] for i in range(n_vert)]
        )
        faces = np.array(
            [[int(x) for x in body[n_vert + i].split()[1:4]]
             for i in range(n_face)]
        )
        return verts, faces
    dtype = np.dtype([(n, type_map[t]) for n, t in vert_props])
    off = header_end
    raw = np.frombuffer(data, dtype=dtype, count=n_vert, offset=off)
    verts = np.stack([raw["x"], raw["y"], raw["z"]], axis=-1).astype(np.float64)
    off += dtype.itemsize * n_vert
    fdtype = np.dtype([("n", "u1"), ("idx", "<i4", (3,))])
    fraw = np.frombuffer(data, dtype=fdtype, count=n_face, offset=off)
    return verts, fraw["idx"].astype(np.int32)


def write_off(path, vertices, faces):
    """ASCII OFF, each coordinate in its shortest round-trip form (as
    `str` gives it for a numpy float64 and for a Python float alike)."""
    vertices = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
    faces = np.asarray(faces).reshape(-1, 3)
    with open(path, "w") as f:
        f.write("OFF\n")
        f.write(f"{len(vertices)} {len(faces)} 0\n")
        f.writelines(f"{a} {b} {c}\n" for a, b, c in vertices.tolist())
        f.writelines(f"3 {a} {b} {c}\n" for a, b, c in faces.tolist())


def read_off(path):
    with open(path) as f:
        tokens = f.read().split()
    idx = 0
    if tokens[0] == "OFF":
        idx = 1
    elif tokens[0].startswith("OFF"):  # "OFF123 ..." glued header
        tokens[0] = tokens[0][3:]
    n_vert, n_face = int(tokens[idx]), int(tokens[idx + 1])
    idx += 3
    verts = np.array(tokens[idx : idx + 3 * n_vert], dtype=np.float64).reshape(
        n_vert, 3
    )
    idx += 3 * n_vert
    rest = tokens[idx : idx + 4 * n_face]
    if len(rest) == 4 * n_face and all(n == "3" for n in rest[::4]):
        # all triangles: one conversion for the whole block
        quads = np.array(rest, dtype=np.int64).reshape(n_face, 4)
        return verts, quads[:, 1:].astype(np.int32)
    faces = []
    for _ in range(n_face):
        n = int(tokens[idx])
        poly = [int(x) for x in tokens[idx + 1 : idx + 1 + n]]
        idx += n + 1
        for k in range(1, n - 1):  # fan-triangulate
            faces.append([poly[0], poly[k], poly[k + 1]])
    return verts, np.array(faces, dtype=np.int32)
