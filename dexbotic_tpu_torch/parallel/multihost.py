"""Multi-process runtime glue (port of dexbotic_tpu/parallel/multihost.py).

The JAX package joins a ``jax.distributed`` cluster; here every process
joins one ``torch.distributed`` process group, NCCL over the cards (each
process on the card of its ``LOCAL_RANK``) or gloo on the CPU when the
caller asks for it (``device="cpu"``, as the tests do).  Models carry no
per-rank code: the rank shows only at the edges (the data feed, checkpoint
writes, logging), which is what this module provides.

Launch contract (either works):

* torchrun: ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` /
  ``LOCAL_RANK``.
* Manual: ``DEXBOTIC_COORDINATOR=host:port`` (or any ``init_method`` URL,
  e.g. ``file:///path``), ``DEXBOTIC_NUM_PROCESSES=N``,
  ``DEXBOTIC_PROCESS_ID=i`` (they mirror MASTER_ADDR:MASTER_PORT,
  WORLD_SIZE and RANK).

With neither set, :func:`maybe_initialize` leaves a plain run alone.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

GROUP_TIMEOUT_S = 1800.0  # a collective that waits longer fails


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name, "") != "":
            return int(os.environ[name])
    return None


def _coordinator_from_env() -> Optional[str]:
    if os.environ.get("DEXBOTIC_COORDINATOR"):
        return os.environ["DEXBOTIC_COORDINATOR"]
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


def _init_method(coordinator: str) -> str:
    """A URL as given; ``host:port`` as tcp://, except torchrun's own
    MASTER_ADDR:MASTER_PORT, whose store its agent already serves (env://)."""
    if "://" in coordinator:
        return coordinator
    if not os.environ.get("DEXBOTIC_COORDINATOR") and coordinator == _coordinator_from_env():
        return "env://"
    return f"tcp://{coordinator}"


def maybe_initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device: Optional[str] = None) -> bool:
    """Join the process group if one is configured; idempotent.

    Returns True when more than one process runs after the call.  The
    backend is NCCL (after ``torch.cuda.set_device(LOCAL_RANK)``) unless
    ``device`` is "cpu", which takes gloo; NCCL without a card raises."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator = coordinator or _coordinator_from_env()
    n = num_processes or _env_int("DEXBOTIC_NUM_PROCESSES", "WORLD_SIZE")
    pid = process_id if process_id is not None else _env_int("DEXBOTIC_PROCESS_ID", "RANK")
    if coordinator is None and n is None:
        return False  # a plain single-process run
    if coordinator is None or n is None or pid is None:
        raise ValueError("a process group needs the coordinator, the number of processes and "
                         f"this process's id (got {coordinator!r}, {n!r}, {pid!r})")
    init_method = _init_method(coordinator)
    if device == "cpu":
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs a CUDA device; pass device='cpu' for gloo")
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None else pid % torch.cuda.device_count())
        backend = "nccl"
    dist.init_process_group(backend, init_method=init_method, world_size=n, rank=pid,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return n > 1


def shutdown() -> None:
    """Leave the process group (after a final barrier); a no-op without one."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """The rank-0 process: the only one that writes checkpoints and logs."""
    return process_index() == 0


def _collective_device() -> torch.device:
    """Where the group's collectives take their tensors: the current card
    under NCCL, the host under gloo."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sync(name: str = "sync") -> None:
    """Barrier across processes (after the primary's checkpoint writes)."""
    del name  # the JAX barrier's label; torch's barrier takes none
    if process_count() > 1:
        dist.barrier()


def _gather_array(x: np.ndarray, tiled: bool) -> np.ndarray:
    x = np.ascontiguousarray(x)
    raw = torch.from_numpy(x.reshape(-1).view(np.uint8).copy()).to(_collective_device())
    parts = [torch.empty_like(raw) for _ in range(process_count())]
    dist.all_gather(parts, raw)
    arrays = [p.cpu().numpy().view(x.dtype).reshape(x.shape) for p in parts]
    return np.concatenate(arrays, 0) if tiled else np.stack(arrays, 0)


def allgather(tree, tiled: bool = True):
    """Every process's numpy leaves (of equal shape and dtype everywhere),
    concatenated on axis 0 in process order (``tiled``) or stacked on a new
    axis 0, as ``multihost_utils.process_allgather``.  One process: the
    leaves themselves (stacked under ``tiled=False``)."""
    if isinstance(tree, dict):
        return {k: allgather(v, tiled) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(allgather(v, tiled) for v in tree)
    x = np.asarray(tree)
    if process_count() == 1:
        return x if tiled else x[None]
    return _gather_array(x, tiled)


def host_copy(tree):
    """A whole host copy of a tree of tensors: a sharded tensor (DTensor) is
    gathered from every process first, so every process must call this in
    the same order."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    if isinstance(tree, DTensor):
        return tree.full_tensor().detach().cpu()
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def local_batch_to_global(batch: dict, device) -> dict:
    """A rank's own rows (numpy or tensors) as its shard of the global batch.

    The global batch is never assembled: each data rank computes on its
    contiguous rows, and the losses divide by global counts
    (``models/losses.data_parallel``), so the step is the global batch's."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()
            if isinstance(v, (np.ndarray, torch.Tensor))}
