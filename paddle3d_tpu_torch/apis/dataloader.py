"""Host data loader with background prefetch, a copy of
paddle3d_tpu/apis/dataloader.py (reference: paddle.io.DataLoader with
DistributedBatchSampler, paddle3d/apis/trainer.py:35-82).

The same index order (a shuffle by `default_rng(seed + epoch)`, then a
contiguous shard a process), the same batches and the same order-preserving
pool of worker threads. One change: every sample gets its own generator,
`transforms.sample_rng(seed, epoch, index)`, through `dataset.get(index,
rng)`. The JAX transforms draw from numpy's global state, which the pool's
threads share, so there a run with more than one worker is not
reproducible; here the batches do not depend on `num_workers`.

A batch is what the dataset's `collate_fn` returns: numpy arrays and the
host-side metas. The Trainer moves the arrays to the model's device.
"""
from typing import Iterator

import numpy as np

from ..transforms.base import sample_rng

__all__ = ["DataLoader"]


class DataLoader:
    def __init__(self,
                 dataset,
                 batch_size: int = 1,
                 shuffle: bool = False,
                 drop_last: bool = True,
                 seed: int = 0,
                 prefetch: int = 4,
                 num_workers: int = 4,
                 num_shards: int = 1,
                 shard_index: int = 0):
        """num_shards / shard_index give DistributedBatchSampler semantics
        (each process loads its own slice). Batches are built in a pool of
        max(1, num_workers) threads, at most `prefetch` ahead of the
        consumer; batch order is preserved."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = max(prefetch, num_workers)
        self.num_workers = max(1, int(num_workers))
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        # contiguous shard per process after the global shuffle
        n = len(idx) // self.num_shards
        return idx[self.shard_index * n:(self.shard_index + 1) * n]

    def _sample(self, index: int, epoch: int):
        get = getattr(self.dataset, "get", None)
        if get is None:
            return self.dataset[index]
        return get(index, sample_rng(self.seed, epoch, index))

    def _build(self, indices, b, epoch):
        chunk = indices[b * self.batch_size:(b + 1) * self.batch_size]
        samples = [self._sample(int(i), epoch) for i in chunk]
        return self.dataset.collate_fn(samples)

    def __iter__(self) -> Iterator:
        import concurrent.futures as cf

        indices = self._indices()
        epoch = self.epoch
        self.epoch += 1
        nb = len(self)
        # worker pool with a sliding window of in-flight batches
        # (order-preserving); a consumer that stops early waits for the
        # batches being built, not for those still queued
        pool = cf.ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            window = {}
            next_submit = 0

            def fill():
                nonlocal next_submit
                while next_submit < nb and len(window) < self.prefetch:
                    window[next_submit] = pool.submit(
                        self._build, indices, next_submit, epoch)
                    next_submit += 1

            fill()
            for b in range(nb):
                fut = window.pop(b)
                fill()
                yield fut.result()
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
