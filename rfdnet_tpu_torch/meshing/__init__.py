"""Meshes on the host: the mesh container and its PLY/OFF IO (`mesh`), the
marching-cubes library (`native`, built from `csrc/meshing.cpp`) and the
dense-grid `Generator3D` (`generator`)."""

from .generator import Generator3D
from .mesh import TriMesh, read_off, read_ply, write_off, write_ply

__all__ = ["Generator3D", "TriMesh", "read_off", "read_ply", "write_off",
           "write_ply"]
