"""Multi-process bootstrap and the port's collectives — counterpart of
whisper_medusa_tpu/parallel/distributed.py.

Every process calls :func:`initialize`, which joins ``torch.distributed``:
from the arguments (``--coordinator-address host:port``,
``--num-processes``, ``--process-id``, ``--dist-backend`` on the CLIs) or
from the variables PyTorch's launcher sets (``MASTER_ADDR`` /
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), so both

    torchrun --nproc-per-node 2 -m whisper_medusa_tpu_torch.cli.evaluate \\
        --dp 2 --dist-backend nccl ...

and one process per rank with the flags work.  The backend is the caller's
choice and is never guessed: ``nccl`` when each rank has a card of its own,
``gloo`` for CPU ranks and for ranks that share one card (NCCL refuses two
ranks on one device).  A backend that cannot start raises; nothing falls
back to another.

The collectives below take CUDA or CPU tensors under either backend: gloo
takes CUDA tensors for all_reduce, all_gather and broadcast (checked on the
H100 by ``chip_smoke.py``'s parallel phase, which runs two gloo ranks on
one card).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List, Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 600.0

_timeout: Optional[datetime.timedelta] = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the ``torch.distributed`` world (idempotent; a no-op for one
    process).  Arguments left None are read from ``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  ``timeout_s`` bounds
    every collective, so a rank that leaves a loop early fails the others
    instead of hanging them.  Under ``nccl`` each rank takes the card
    ``LOCAL_RANK`` (else its rank) as its current device, and the
    communicator is started here, so a failed NCCL start raises now."""
    global _timeout
    if dist.is_available() and dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if num_processes in (None, 1) and coordinator_address is None:
        return
    if not num_processes or process_id is None or coordinator_address is None:
        raise ValueError(
            "a multi-process run needs the coordinator address, the number of "
            "processes and this process's id (--coordinator-address / "
            "--num-processes / --process-id, or MASTER_ADDR + MASTER_PORT / "
            "WORLD_SIZE / RANK)")
    if backend not in BACKENDS:
        raise ValueError(
            f"backend {backend!r}: pass 'nccl' when each rank has a card of its own, "
            "'gloo' for CPU ranks or ranks that share one card (--dist-backend)")
    kw = {}
    _timeout = datetime.timedelta(seconds=timeout_s)
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=_timeout, **kw)
    dist.barrier()


def group_timeout() -> Optional[datetime.timedelta]:
    """The timeout :func:`initialize` gave the world, for its sub-groups."""
    return _timeout


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns logging and host-side writes."""
    return process_index() == 0


def sync() -> None:
    """Barrier across every process (checkpoint writes, shutdown)."""
    if process_count() > 1:
        dist.barrier()


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()


def local_rows(global_batch, index: int, count: int):
    """This rank's rows of a global batch: rows [index * B/count, (index +
    1) * B/count) of an array or tensor whose leading axis is the batch —
    the counterpart of JAX ``local_batch_to_global``, which assembles the
    global array from each process's rows; here each rank keeps its own."""
    b = global_batch.shape[0]
    if b % count:
        raise ValueError(f"batch {b} does not divide over {count} data ranks")
    per = b // count
    return global_batch[index * per:(index + 1) * per]


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over ``group`` (a new tensor; every rank gets the same
    bits).  Not differentiable: see ``mesh.reduce_from_model``."""
    if group is None:
        return t
    out = t.detach().contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors of one shape concatenated along ``dim`` in
    group-rank order."""
    if group is None:
        return t
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def all_gather_objects(obj: Any, group) -> List[Any]:
    """Every rank's picklable ``obj`` in group-rank order."""
    if group is None:
        return [obj]
    out: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out
