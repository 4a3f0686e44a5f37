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
a run whose peer died, with an error, instead of waiting for ever. A group
that its joiner leaves open is ended at the interpreter's exit.

The JAX module's ``coordination_barrier`` and ``compile_synced`` have no
counterpart: they keep one process's collective from timing out while
another still compiles the program. Eager PyTorch compiles nothing before
its first collective, so :func:`barrier` is a plain collective.

Serving and evaluation over ranks (one JAX process drives every device;
here one process a device) go through a job channel: rank 0 broadcasts each
job (:class:`JobLeader`), the other ranks wait in :func:`follow_jobs`. While
rank 0 is idle its leader sends a ping every ``HEARTBEAT_S`` seconds, so a
waiting rank stays inside the group's timeout, which still ends every rank
with an error when one dies. :func:`in_turn` runs a step in turns of as
many ranks as the host's memory holds, by the least of the ranks' readings
so that every rank takes the same turns (a large model's load, whose host
memory would otherwise be W times one copy).
"""

from __future__ import annotations

import atexit
import datetime
import os
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

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
    atexit.register(_leave_group)
    return True


def _leave_group() -> None:
    """At the interpreter's exit, end the process group if its joiner has
    not: its backend's threads are then joined while the interpreter still
    runs. A process that exits with them live can abort in its teardown
    ("terminate called without an active exception"), a rank of a run that
    had finished."""
    if dist.is_initialized():
        dist.destroy_process_group()


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


LOAD_FACTOR = 3  # host bytes a load holds at its peak, per byte loaded


def loads_at_once(nbytes: int) -> int:
    """How many ranks may load ``nbytes`` each at once: as many as the
    host's available memory holds at ``LOAD_FACTOR`` times that (the file,
    its tree, the rank's cut), at least one; one when either is unknown."""
    try:
        with open("/proc/meminfo") as fh:
            avail = next(int(line.split()[1]) * 1024 for line in fh
                         if line.startswith("MemAvailable:"))
    except (OSError, StopIteration, ValueError):
        return 1
    return max(1, avail // (LOAD_FACTOR * nbytes)) if nbytes > 0 else 1


def in_turn(fn: Callable[[], Any], nbytes: int = 0) -> Any:
    """``fn()`` on every rank, in turns of k ranks in rank order (a
    collective: every rank calls it): a load of ``nbytes`` that W ranks at
    once would need W times the host memory of. k is the least of the
    ranks' :func:`loads_at_once`, gathered first, so that every rank takes
    the same turns (each reads its host's memory at its own moment).
    Returns this rank's result."""
    k = min(all_gather_objects(loads_at_once(nbytes)))
    out = None
    for turn in range(0, world_size(), k):
        if turn <= rank() < turn + k:
            out = fn()
        barrier()
    return out


PING = {"kind": "ping"}
HEARTBEAT_S = 30.0  # rank 0's idle ping, well inside DEFAULT_TIMEOUT_S


def broadcast_job(job=None):
    """Rank 0's ``job`` (a picklable object; None is the stop) on every
    rank: rank 0 passes it, the others receive it."""
    box = [job]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class JobLeader:
    """Rank 0's end of the job channel. :meth:`run` sends a job and runs
    rank 0's part of it under one lock, so that no ping falls between the
    collectives of a job; a daemon thread pings the other ranks whenever no
    job was sent for ``HEARTBEAT_S`` seconds; :meth:`stop` sends the stop.
    An error inside a job leaves the ranks out of step: the leader then
    sends nothing more (``failed``) and calls ``on_failure(error)``."""

    def __init__(self):
        self.failed: Optional[BaseException] = None
        self.on_failure: Optional[Callable[[BaseException], None]] = None
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._stopped = False
        threading.Thread(target=self._beat, daemon=True).start()

    def run(self, job, fn: Callable[[], Any]) -> Any:
        with self._lock:
            if self._stopped or self.failed is not None:
                raise RuntimeError(f"the ranks are stopped "
                                   f"({self.failed or 'stop sent'})")
            try:
                broadcast_job(job)
                return fn()
            except BaseException as e:
                self.failed = e
                if self.on_failure is not None:
                    self.on_failure(e)
                raise
            finally:
                self._last = time.monotonic()

    def stop(self) -> None:
        """Send the stop (once; nothing after a failure)."""
        with self._lock:
            if not self._stopped and self.failed is None:
                self._stopped = True
                broadcast_job(None)

    def _beat(self) -> None:
        while True:
            time.sleep(1.0)
            with self._lock:
                if self._stopped or self.failed is not None:
                    return
                if time.monotonic() - self._last >= HEARTBEAT_S:
                    try:
                        broadcast_job(PING)
                    except BaseException as e:  # a rank died
                        self.failed = e
                        if self.on_failure is not None:
                            self.on_failure(e)
                        return
                    self._last = time.monotonic()


def follow_jobs(handle: Callable[[Any], None]) -> int:
    """The other ranks' end: ``handle(job)`` for each job rank 0 sends,
    pings skipped, until the stop; returns the number of jobs run."""
    n = 0
    while True:
        job = broadcast_job()
        if job is None:
            return n
        if job == PING:
            continue
        handle(job)
        n += 1
