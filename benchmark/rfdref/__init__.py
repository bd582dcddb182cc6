"""The benchmark's plain reference of RfD-Net's ISCNet: detection,
NMS, skip propagation and the occupancy decoder (`models/`, `ops/`), the
training forward with its losses, and Adam (`train.py`), in plain
PyTorch. It was frozen from the PyTorch port's plain path (which CPU
tests hold to the JAX package), with each CUDA kernel replaced by its
plain torch version (`ops/fps.py`, `ops/cbn_decoder.py`). It imports
nothing of the port, so a change to the port is judged against the code
as it stood when the benchmark was defined. Keep it unedited: a change
here changes what every later run is compared with.

It computes what the benchmark's configurations state, on one process:
the completion phase with seed_fps proposals and skip propagation, in
float32 with TF32 off (`strict_f32`). `config.build_model` refuses any
other setting; a configuration that needs one adds its path here."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 matrix products and convolutions on (`tf32`) or off inside the
    block; the previous settings come back after it."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def strict_f32():
    """The configurations' precision: float32, TF32 off."""
    return precision(False)
