"""Multi-process initialisation over ``torch.distributed``.

Port of ``motiondiffusion_moe_tpu/parallel/distributed.py``: one process per
device, each feeding its own rows of the global batch
(``DistributedSampler(num_replicas=world_size(), rank=rank())`` at
:func:`local_batch_slice` of the global batch size), the primary printing
and writing, every process taking part in the collectives.

:func:`initialize_distributed` reads the JAX package's three settings
(flags, then ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``),
then torchrun's environment (``MASTER_ADDR`` / ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``). Its backend follows the device:
``nccl`` for CUDA, ``gloo`` for the CPU, unless the caller names one. An
explicit configuration that fails to initialise raises: a degraded run of
one process would train on another batch, silently. A finite timeout ends
a run whose peer died, with an error, instead of waiting for ever.

The JAX module's ``coordination_barrier`` and ``compile_synced`` have no
counterpart: they keep one process's collective from timing out while
another still compiles the program. Eager PyTorch compiles nothing before
its first collective, so :func:`barrier` is a plain collective.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


def launch_config(coordinator_address: Optional[str] = None,
                  num_processes: Optional[int] = None,
                  process_id: Optional[int] = None
                  ) -> Optional[Tuple[str, int, int]]:
    """(init method, world size, rank) of the launch, or None when nothing
    configures more than this process. The JAX settings win over
    torchrun's; given in part, they raise."""
    env = os.environ
    address = coordinator_address or env.get("COORDINATOR_ADDRESS", "")
    n = num_processes or int(env.get("NUM_PROCESSES", "0"))
    pid = process_id if process_id is not None else int(
        env.get("PROCESS_ID", "-1"))
    if address or n > 1 or pid >= 0:
        if not (address and n >= 1 and 0 <= pid < n):
            raise ValueError(
                f"multi-process launch given in part (coordinator address "
                f"{address!r}, {n} processes, process id {pid}): name all "
                "three, or none")
        method = address if "://" in address else f"tcp://{address}"
        return method, n, pid
    if "WORLD_SIZE" in env and "RANK" in env:
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    return None


def rank_device(device="cuda", rank_: Optional[int] = None) -> torch.device:
    """The device of this process: ``device`` as given when it names an
    index or is no CUDA device, else ``cuda:LOCAL_RANK`` (torchrun's), or
    ``cuda:<rank modulo the cards>`` when no ``LOCAL_RANK`` is set."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return torch.device("cuda", int(local))
    r = rank() if rank_ is None else rank_
    return torch.device("cuda", r % max(1, torch.cuda.device_count()))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device="cuda",
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group of the launch (see the module doc); True when
    this call initialised it, False when it was initialised already or
    nothing configures more than this process. ``coordinator_address`` is
    ``host:port`` or an init URL (``tcp://...``, ``file://...``)."""
    if dist.is_initialized():
        return False
    launch = launch_config(coordinator_address, num_processes, process_id)
    if launch is None:
        return False
    method, world, r = launch
    dev = rank_device(device, r)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # NCCL's communicator takes this card
    dist.init_process_group(backend, init_method=method, world_size=world,
                            rank=r,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that prints, logs and writes files (the
    reference patches ``print`` to be rank 0's only)."""
    return rank() == 0


def local_batch_slice(global_batch: int) -> int:
    """Rows per process of an evenly split global batch."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    return global_batch // n


def barrier() -> None:
    """Wait for every process (none to wait for in one)."""
    if world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def all_gather_objects(obj) -> List:
    """Every process's ``obj``, in rank order (``[obj]`` in one)."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def allgather_numpy(x: np.ndarray) -> np.ndarray:
    """The processes' arrays concatenated along the first axis in rank
    order (``process_allgather`` then a reshape, in the JAX package)."""
    return np.concatenate([np.asarray(a) for a in
                           all_gather_objects(np.asarray(x))])


def primary_says(flag: bool) -> bool:
    """The primary's ``flag`` on every process: a decision that the
    processes must take alike (for example, whether a step is saved)."""
    return bool(all_gather_objects(bool(flag))[0])
