"""Build and load the native libraries of `rfdnet_tpu_torch/csrc`.

Each hand-written CUDA kernel `csrc/<name>.cu` compiles with `nvcc` for
`sm_90a`, and each host library (`csrc/meshing.cpp`, the extractors, the
voxelizer and the containment test; `csrc/simplify.cpp`, the QEM
simplification; `csrc/kdtree.cpp`, the KD-tree) with `g++`, into
its own shared library with a plain C interface, loaded with `ctypes`.
The build happens at first use, into `csrc/build/` (listed in
`.gitignore`), under a name that carries a hash of the source and flags,
so an edited source is never served by a stale library. The host library
is built with `-march=native`, which is valid only on CPUs with the same
instruction sets, so its name also carries a tag of the host's CPU.
`build()` starts one compiler per source at once, so a cold start costs
the slowest build, not their sum.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
# csrc/<name>.cu, nvcc
KERNELS = ("fps", "cbn_decoder", "cbn_decoder_bf16", "render_depth",
           "tsdf_fuse", "adam")
HOST_LIBS = ("meshing", "simplify", "kdtree")  # csrc/<name>.cpp, g++
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the host library cannot be built")
    return path


@functools.cache
def host_tag() -> str:
    """The machine type and a hash of the CPU's feature flags: what a
    `-march=native` binary depends on."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line
                    break
    except OSError:
        pass
    return platform.machine() + ":" + hashlib.sha1(flags.encode()).hexdigest()


def _source(name: str) -> Path:
    if name not in KERNELS + HOST_LIBS:
        raise ValueError(f"no native library named {name!r}")
    return CSRC / (f"{name}.cu" if name in KERNELS else f"{name}.cpp")


def _compile_command(name: str) -> list[str]:
    """The compiler and flags of `name`, without source and output."""
    if name in KERNELS:
        return [_nvcc(), *NVCC_FLAGS]
    return [_gxx(), *GXX_FLAGS]


def lib_path(name: str) -> Path:
    flags = NVCC_FLAGS if name in KERNELS else GXX_FLAGS + (host_tag(),)
    digest = hashlib.sha1(
        _source(name).read_bytes() + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=KERNELS + HOST_LIBS) -> dict[str, str]:
    """Compile every library of `names` that is not built yet, all at once.
    Returns the compiler's messages (for a kernel, ptxas register and spill
    counts) per name built; raises if a compiler is missing or any build
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {name: lib_path(name) for name in names}
    # every compiler is looked up before any is started
    cmds = {name: _compile_command(name) for name, out in todo.items()
            if not out.exists()}
    procs = {}
    for name, compiler in cmds.items():
        out = todo[name]
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [*compiler, "-o", str(tmp), str(_source(name))]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError(
            "the build failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def ptxas_summary(log: str) -> list[dict]:
    """One entry per kernel of an `nvcc -Xptxas -v` log: its (mangled)
    name, registers a thread, bytes of spill stores and loads, and bytes
    of static shared memory (`smem`; dynamic shared memory is the
    launch's, which ptxas does not see)."""
    rows, name, spill = [], None, None
    for line in log.splitlines():
        if "Function properties for" in line:
            name, spill = line.rsplit(" ", 1)[1], None
        elif name and "spill stores" in line:
            spill = [int(v) for v in re.findall(r"(\d+) bytes spill", line)]
        elif name and "Used" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append(dict(kernel=name, registers=regs, spill=spill,
                             smem=int(smem.group(1)) if smem else 0))
            name = None
    return rows


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of `name`'s source, built first if needed."""
    path = lib_path(name)
    if not path.exists():
        build((name,))
    return ctypes.CDLL(str(path))


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` (None
    matches any size) on `device`."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    size = tuple(t.shape)
    if size != shape and (len(size) != len(shape) or any(
        s is not None and s != d for s, d in zip(shape, size)
    )):
        raise ValueError(f"{name}: shape {size}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
