"""Parallel execution of the port: process groups of the data axis
(`mesh`), batched serving (`serve`), the point-sharded SA1 (`point_shard`)
and its slab layout with halo exchange (`halo`).

Counterpart of `rfdnet_tpu/parallel/`: a JAX mesh axis becomes a
`torch.distributed` process group, one process a card (or, on the CPU,
one process a rank under gloo), and each collective of the JAX package's
`shard_map` bodies becomes the `torch.distributed` call of the same
reduction.
"""
