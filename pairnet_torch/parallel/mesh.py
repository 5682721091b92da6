"""Process groups and data-parallel helpers over ``torch.distributed``.

Counterpart of ``pairnet_tpu/parallel/mesh.py``. JAX runs one SPMD program
over a ``("data", "model")`` mesh and XLA inserts the gradient psum; here
each rank is a process (``torchrun``) that holds its rows of the global
batch and sums what crosses ranks itself:

* :func:`init_distributed` / :func:`distributed`: the launcher's
  environment to ``(rank, world, device)``, NCCL for a CUDA device and gloo
  for the CPU;
* :func:`make_mesh`: a 2-D ``DeviceMesh`` ("data", "model"), ranks laid out
  row-major as JAX's ``devs.reshape(n_data, n_model)``;
* :func:`shard_dataset_indices`: JAX's per-host shard of an epoch, bit for
  bit; :func:`rank_rows`: a rank's rows of a global batch;
* :func:`all_reduce_sum`, :func:`all_reduce_coalesced` (one flat buffer per
  dtype) and :func:`all_reduce_arrays` (host arrays, one f64 buffer).

With no process group initialized, every collective here is the identity
(world size 1) and issues no call.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_info() -> tuple[int, int]:
    """(rank, world size); (0, 1) when no process group is initialized."""
    if not is_distributed():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _device(device, local_rank: int) -> torch.device:
    """``None`` or a bare "cuda" mean ``cuda:LOCAL_RANK``; asking for CUDA
    without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
    return dev


def init_distributed(device=None) -> tuple[int, int, torch.device]:
    """``(rank, world, device)`` from the environment ``torchrun`` sets
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``); counterpart of init_dist
    (ref: tools/train.py:169-176).

    Under a launcher (``WORLD_SIZE`` set) it initializes the default process
    group, NCCL for a CUDA device and gloo for the CPU, so even a world of 1
    runs its collectives through the backend. Without one it is a no-op at
    world size 1. A group that is already initialized is used as it is (a
    caller that needs another backend makes its group first). A failed init
    raises."""
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    dev = _device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if is_distributed():
        return dist.get_rank(), dist.get_world_size(), dev
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if "WORLD_SIZE" in os.environ or world > 1:
        if dev.type == "cuda":
            dist.init_process_group("nccl", rank=rank, world_size=world, device_id=dev)
        else:
            dist.init_process_group("gloo", rank=rank, world_size=world)
    return rank, world, dev


@contextlib.contextmanager
def distributed(device=None):
    """:func:`init_distributed` as a context: yields ``(rank, world,
    device)`` and destroys on exit the process group it created (a group
    the caller made stays)."""
    owned = not is_distributed()
    info = init_distributed(device)
    try:
        yield info
    finally:
        if owned and is_distributed():
            dist.destroy_process_group()


def make_mesh(n_data: int | None = None, n_model: int = 1):
    """A ``DeviceMesh`` of the world's ranks shaped ``(n_data, n_model)``
    with dims ("data", "model"), rank ``d * n_model + m`` at (d, m) as JAX's
    ``devs.reshape(n_data, n_model)``. Every rank calls it."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} does not cover the world of {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=("data", "model"))


def shard_dataset_indices(n_items: int, seed: int, epoch: int, rank: int, world: int):
    """Rank ``rank``'s disjoint shard of the epoch's indices (JAX's
    ``shard_dataset_indices``): one ``default_rng(seed + epoch)``
    permutation on every rank, split contiguously, the remainder dropped."""
    order = np.random.default_rng(seed + epoch).permutation(n_items)
    per = n_items // world
    return order[rank * per : (rank + 1) * per]


def rank_rows(batch: dict, rank: int, world: int) -> dict:
    """Rows ``rank * b : (rank + 1) * b`` of every entry of a global batch,
    ``b = B / world``; a batch that does not divide raises, as JAX's
    sharding does."""
    B = len(next(iter(batch.values())))
    if B % world:
        raise ValueError(f"global batch {B} does not divide by the world size {world}")
    b = B // world
    return {k: v[rank * b : (rank + 1) * b] for k, v in batch.items()}


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place; the identity with no process
    group."""
    if is_distributed():
        dist.all_reduce(t)
    return t


def all_reduce_coalesced(tensors) -> None:
    """Sum each tensor over the ranks in place: one collective on one flat
    buffer per dtype, not one per tensor (the gradient psum). The identity
    with no process group."""
    if not is_distributed():
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat)
        offset = 0
        for t in ts:
            t.copy_(flat[offset : offset + t.numel()].view_as(t))
            offset += t.numel()


def collective_device() -> torch.device:
    """Where host data goes for a collective: the current CUDA device under
    NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_arrays(arrays: dict) -> dict:
    """Host arrays summed over the ranks in one f64 collective; the arrays
    themselves (as f64) with no process group."""
    arrays = {k: np.asarray(v, np.float64) for k, v in arrays.items()}
    if not is_distributed():
        return arrays
    flat = torch.from_numpy(np.concatenate([a.reshape(-1) for a in arrays.values()]))
    flat = flat.to(collective_device())
    dist.all_reduce(flat)
    flat = flat.cpu().numpy()
    out, offset = {}, 0
    for k, a in arrays.items():
        out[k] = flat[offset : offset + a.size].reshape(a.shape)
        offset += a.size
    return out
