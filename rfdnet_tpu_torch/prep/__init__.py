"""Offline data preparation (L0), the port's copy of `tools/prep/`: the
ShapeNet watertighting, sampling and simplification (`shapenet`, render
and fusion as CUDA kernels on the card) and the ScanNet + Scan2CAD boxes,
votes and splits (`scannet`). Each is run as a module:
`python -m rfdnet_tpu_torch.prep.shapenet` / `.scannet`."""
