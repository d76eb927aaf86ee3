"""Threaded prefetching data loader: a copy of ``dhd_tpu/data/loader.py``.

The reference relies on mmcv dataloader workers (workers_per_gpu=4,
SURVEY §3.1).  Host preprocessing here is already C++/OpenMP
(``dhd_tpu_torch/native``); this loader overlaps it with device steps
using a thread pool and a bounded prefetch queue, feeding one device from
one process.  The same seed and shard give the same order.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from .pipeline import collate


class PrefetchLoader:
    """Iterate collated batches with background workers.

    Args:
      dataset: object with get_sample(i) and __len__.
      pipeline: SamplePipeline-like callable sample->dict.
      batch_size: global batch size.
      shuffle: reshuffle indices each epoch.
      num_workers: preprocessing threads (PIL/np release the GIL; the
        projection kernel is native OpenMP).
      prefetch: max batches in flight.
    """

    def __init__(self, dataset, pipeline: Callable, batch_size: int,
                 shuffle: bool = True, num_workers: int = 4,
                 prefetch: int = 2, seed: int = 0, drop_last: bool = True,
                 shard: tuple = (0, 1)):
        self.dataset = dataset
        self.pipeline = pipeline
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        # (process_index, process_count): multi-host data parallelism — all
        # processes draw the same seeded permutation and each takes a
        # disjoint strided subset (the DistributedSampler equivalent;
        # batch_size here is the LOCAL per-process batch).
        self.shard = shard

    def __len__(self) -> int:
        n_local = len(self.dataset) // self.shard[1]
        n = n_local // self.batch_size
        if not self.drop_last and n_local % self.batch_size:
            n += 1
        return n

    def _make_batch(self, idxs: Sequence[int]) -> dict:
        return collate([self.pipeline(self.dataset.get_sample(int(i)))
                        for i in idxs])

    def __iter__(self) -> Iterator[dict]:
        order = (self.rng.permutation(len(self.dataset)) if self.shuffle
                 else np.arange(len(self.dataset)))
        rank, world = self.shard
        if world > 1:
            order = order[rank::world]
        chunks = [order[i * self.batch_size:(i + 1) * self.batch_size]
                  for i in range(len(self))]
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = []
            it = iter(chunks)
            for _ in range(self.prefetch):
                try:
                    pending.append(pool.submit(self._make_batch, next(it)))
                except StopIteration:
                    break
            while pending:
                fut = pending.pop(0)
                try:
                    pending.append(pool.submit(self._make_batch, next(it)))
                except StopIteration:
                    pass
                yield fut.result()
