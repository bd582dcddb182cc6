"""PyTorch + CUDA port of `rfdnet_tpu`: test-time generation, the
evaluation, and training.

The package mirrors `rfdnet_tpu`'s module layout (`ops/fps.py`,
`models/pointnet2.py`, `train/loop.py`, ...) and its channels-last tensor
layouts, so each function has a counterpart of the same name there. The
two Pallas kernels of the JAX package are hand-written CUDA C++ for Hopper
(`csrc/`), as are the offline preparation's depth raster and TSDF fusion,
which the JAX package runs on the host (`prep/`); every other op is plain
PyTorch. A model trains in torch's train mode (`model.train()`); the fused
decoder kernel serves eval mode.

Numerics: float32 matrix products and convolutions run in full float32
(TF32 off), which the parity tests against `rfdnet_tpu` rely on.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    current CUDA card. Never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain versions"
        )
    return torch.device("cuda", torch.cuda.current_device())
