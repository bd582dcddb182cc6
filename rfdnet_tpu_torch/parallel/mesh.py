"""Process groups of the data axis, and the collectives the data-parallel
paths use.

Counterpart of `rfdnet_tpu/parallel/mesh.py`. The JAX package lays a 1-D
device mesh over its `data` axis: the batch sharded over it, parameters
replicated, the gradient all-reduce inserted by the partitioner and the
batch statistics taken over the global batch. Here the axis is a
`torch.distributed` process group, one process a rank: NCCL with one
CUDA card a rank, or gloo on the CPU. `run_ranks` starts the ranks
(`spawn` start method), `init_group` joins one to the group, and
`shard_batch` takes a rank's rows of a global batch.

`DataGroup`, `shard_rows` and the two sums that the models take
(`all_sum` for sync-BN, `global_sum` for the global-batch loss) live in
`rfdnet_tpu_torch/collectives.py`, which imports nothing of the port.
The other collectives of the data axis:
- `all_gather_rows`: the ranks' rows in rank order (served outputs);
- `all_reduce_grads`: the SUM all-reduce of the gradients, in buckets;
- `broadcast_module`, `broadcast_tensors`: rank 0's values to every rank
  (a resumed or finetuned run);
- `replicated_check`: parameters and buffers equal on every rank.
"""

from __future__ import annotations

import os
import socket
import traceback

import torch
import torch.distributed as dist

from ..collectives import DataGroup, shard_rows

DATA_AXIS = "data"


def rank_device(rank: int, device=None) -> torch.device:
    """The device of `rank`: `cuda:{LOCAL_RANK}` (the rank when the
    variable is unset), or the CPU when `device` asks for it."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the ranks on the CPU")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local)


def init_group(backend=None, device=None) -> DataGroup:
    """Join this process to the default process group as rank `RANK` of
    `WORLD_SIZE` (environment variables, as `run_ranks` sets them), at
    tcp://`MASTER_ADDR`:`MASTER_PORT`. `backend` defaults to NCCL on a
    CUDA card and gloo on the CPU; `device` as `rank_device`'s."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    if backend is not None and device is None and backend == "gloo":
        device = "cpu"
    dev = rank_device(rank, device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world)
    return DataGroup(None, rank, world, dev)


def shard_batch(batch: dict, group: DataGroup | None) -> dict:
    """`group`'s rank's rows of every batch-leading field of `batch`
    (tensors, arrays, lists); the batch itself without a group."""
    if group is None:
        return batch
    n = len(next(iter(batch.values())))
    rows = shard_rows(n, group.rank, group.world)
    return {k: v[rows] for k, v in batch.items()}


@torch.no_grad()
def all_gather_rows(x: torch.Tensor, group: DataGroup | None) -> torch.Tensor:
    """The ranks' x (each the same shape) concatenated along the leading
    axis in rank order; x itself without a group."""
    if group is None:
        return x
    flag = x.dtype == torch.bool  # not every backend reduces bool
    x = (x.to(torch.uint8) if flag else x).contiguous()
    parts = [torch.empty_like(x) for _ in range(group.world)]
    dist.all_gather(parts, x, group=group.group)
    out = torch.cat(parts)
    return out.bool() if flag else out


GRAD_BUCKET_BYTES = 64 << 20


@torch.no_grad()
def all_reduce_grads(params, group: DataGroup | None) -> None:
    """Sum each parameter's `.grad` over the ranks, in place, with one
    all-reduce a bucket of about GRAD_BUCKET_BYTES (a parameter without a
    gradient takes zeros, so every rank sends the same layout)."""
    if group is None:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    bucket, size = [], 0
    for i, p in enumerate(params):
        bucket.append(p.grad)
        size += p.grad.numel() * p.grad.element_size()
        if size >= GRAD_BUCKET_BYTES or i == len(params) - 1:
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat, group=group.group)
            offset = 0
            for g in bucket:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
            bucket, size = [], 0


@torch.no_grad()
def broadcast_tensors(tensors, group: DataGroup | None, src: int = 0):
    """Overwrite each tensor with rank `src`'s, in place."""
    if group is None:
        return
    for t in tensors:
        dist.broadcast(t, src, group=group.group)


def broadcast_module(module: torch.nn.Module, group: DataGroup | None,
                     src: int = 0) -> None:
    """Rank `src`'s parameters and buffers on every rank."""
    broadcast_tensors([*module.parameters(), *module.buffers()], group, src)


@torch.no_grad()
def replicated_check(module: torch.nn.Module,
                     group: DataGroup | None) -> None:
    """Raise unless every parameter and buffer of `module` holds the same
    bits on every rank as on rank 0."""
    if group is None:
        return
    named = [*module.named_parameters(), *module.named_buffers()]
    mine = torch.cat([t.detach().double().reshape(-1) for _, t in named])
    ref = mine.clone()
    dist.broadcast(ref, 0, group=group.group)
    same = mine.view(torch.int64) == ref.view(torch.int64)
    if bool(same.all()):
        return
    differ, offset = [], 0
    for name, t in named:
        if not bool(same[offset:offset + t.numel()].all()):
            differ.append(name)
        offset += t.numel()
    raise AssertionError(
        f"rank {group.rank}: {len(differ)} tensors differ from rank 0's: "
        f"{differ[:8]}")


def free_port() -> int:
    """A TCP port of localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, backend, port, threads, args, results):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    if threads:
        torch.set_num_threads(threads)
    try:
        group = init_group(backend)
        try:
            out = fn(group, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world: int, backend: str, *args, threads: int | None = None,
              timeout: float | None = None) -> list:
    """Run fn(group, *args) in `world` new processes (the `spawn` start
    method), one rank each, joined to one process group with `backend`
    ("nccl": rank r on `cuda:r`; "gloo": on the CPU) at a free port of
    localhost; `threads` caps each rank's intra-op threads. fn and args
    are pickled: fn must be importable by name. Returns the ranks'
    results in rank order; raises with a failed rank's traceback, when a
    rank ends without a result, or when the ranks do not finish within
    `timeout` seconds (None: no limit, as a training run needs). Every
    rank's process has ended when it returns."""
    import multiprocessing
    import queue
    import time

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, rank, world, backend, port, threads, args, results))
        for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + (float("inf") if timeout is None
                                   else timeout)
    out, ended = {}, {}
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                now = time.monotonic()
                for r, p in enumerate(procs):
                    if r not in out and p.exitcode is not None:
                        # its result, if it sent one, is in the pipe by now
                        if now - ended.setdefault(r, now) > 10.0:
                            raise RuntimeError(
                                f"run_ranks: rank {r} ended (exit code "
                                f"{p.exitcode}) without a result") from None
                if now > deadline:
                    raise TimeoutError(
                        f"run_ranks: {world - len(out)} ranks gave no "
                        f"result in {timeout} s") from None
                continue
            if not ok:  # the other ranks may wait on it for ever
                raise RuntimeError(f"run_ranks: rank {rank}:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(min(max(deadline - time.monotonic(), 1.0), 60.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]
