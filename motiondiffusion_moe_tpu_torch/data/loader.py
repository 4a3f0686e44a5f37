"""Batching with the reference's distributed sampler, host-side numpy.

A copy of ``motiondiffusion_moe_tpu/data/loader.py``: ``DistributedSampler``
(epoch-seeded shuffle, round-up padding), ``collate`` and ``DataLoader``
with a one-batch background prefetch, whose batches come from the dataset's
native (C++) store where it has one (``Text2MotionDataset.get_batch``), with
the JAX package's per-batch crop seed. The port trains on one process, so
the sampler runs with one replica.
"""

from __future__ import annotations

import math
import queue as queue_mod
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

Batch = Tuple[List[str], np.ndarray, np.ndarray]  # captions, motions, lengths


class DistributedSampler:
    """Deterministic per-rank index sampler."""

    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, round_up: bool = True, seed: int = 0):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} not in [0, {num_replicas})")
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.round_up = round_up
        self.seed = seed
        self.epoch = 0
        if round_up:
            self.num_samples = int(math.ceil(dataset_len / num_replicas))
            self.total_size = self.num_samples * num_replicas
        else:
            self.num_samples = len(range(rank, dataset_len, num_replicas))
            self.total_size = dataset_len

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            indices = np.random.default_rng(self.seed + self.epoch
                                            ).permutation(self.dataset_len)
        else:
            indices = np.arange(self.dataset_len)
        if self.round_up:
            reps = 1 + (self.total_size - 1) // max(1, len(indices))
            indices = np.tile(indices, reps)[: self.total_size]
        indices = indices[self.rank: self.total_size: self.num_replicas]
        return iter(indices.tolist())

    def __len__(self) -> int:
        return self.num_samples


def collate(samples: Sequence[Tuple[str, np.ndarray, int]]) -> Batch:
    captions = [s[0] for s in samples]
    motions = np.stack([s[1] for s in samples]).astype(np.float32)
    lengths = np.asarray([s[2] for s in samples], dtype=np.int32)
    return captions, motions, lengths


class DataLoader:
    """Minimal batching loader with background single-batch prefetch."""

    def __init__(self, dataset, batch_size: int,
                 sampler: Optional[DistributedSampler] = None,
                 shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, prefetch: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or DistributedSampler(
            len(dataset), shuffle=shuffle, seed=seed)
        self.drop_last = drop_last
        self.prefetch = prefetch

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else math.ceil(
            n / self.batch_size)

    def _batches(self) -> Iterator[Batch]:
        native = getattr(self.dataset, "has_native", False)
        buf: List[int] = []
        n_batch = 0

        def emit(idxs: List[int]) -> Batch:
            nonlocal n_batch
            if native:
                # the crop seed of a batch: (seed, epoch, batch number)
                seed = ((self.sampler.seed * 1_000_003
                         + self.sampler.epoch) * 131 + n_batch) & 0x7FFFFFFF
                b = self.dataset.get_batch(idxs, seed=seed)
            else:
                b = collate([self.dataset[i] for i in idxs])
            n_batch += 1
            return b

        for idx in self.sampler:
            buf.append(idx)
            if len(buf) == self.batch_size:
                yield emit(buf)
                buf = []
        if buf and not self.drop_last:
            yield emit(buf)

    def __iter__(self) -> Iterator[Batch]:
        if not self.prefetch:
            yield from self._batches()
            return
        q: queue_mod.Queue = queue_mod.Queue(maxsize=2)
        end = object()
        stop = threading.Event()

        def put(item) -> bool:
            # gives up when the consumer is gone, so an abandoned iteration
            # does not leave this thread blocked forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def producer():
            # exceptions go to the consumer: a dead producer with a silent
            # queue would hang the train loop
            try:
                for b in self._batches():
                    if not put(b):
                        return
                put(end)
            except BaseException as e:  # noqa: BLE001 -- re-raised below
                put(e)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            th.join(timeout=10)
