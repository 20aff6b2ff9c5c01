"""Batching loader, counterpart of `tinyrecurrentunet_tpu/data/loader.py`:
the same per-(seed, epoch) shuffle, the same per-host sharding of the index
space and the same per-item generator default_rng((seed, epoch, index)), so
both packages see the same batches in the same order.

Unlike the JAX loader it reads items in the calling thread, with no
prefetch thread or worker pool: the dataset the port trains on
(`SyntheticPairDataset`) goes through the training loop's on-device corpus
instead.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self._epoch = 0

    def __len__(self):
        n = len(range(self.shard_index, len(self.dataset), self.num_shards))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            # the same permutation on every host, then shard
            rng = np.random.default_rng((self.seed, self._epoch))
            rng.shuffle(idx)
        return idx[self.shard_index :: self.num_shards]

    def _get_item(self, index: int):
        """One item; an unreadable one falls back to the next index, up to
        four in a row."""
        last_err = None
        for attempt in range(4):
            idx = (int(index) + attempt) % len(self.dataset)
            rng = np.random.default_rng((self.seed, self._epoch, idx))
            try:
                return self.dataset.get(idx, rng)
            except (OSError, ValueError) as e:
                last_err = e
                print(f"data: skipping item {idx}: {e}", flush=True)
        raise RuntimeError(f"4 consecutive unreadable dataset items starting at {index}") from last_err

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, list]]:
        """One pass over the epoch: (clean (B, L), noisy (B, L), ids)."""
        indices = self._epoch_indices()
        for i in range(0, len(indices), self.batch_size):
            chunk = indices[i : i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            items = [self._get_item(j) for j in chunk]
            length = min(len(c) for c, _, _ in items)
            clean = np.stack([c[:length] for c, _, _ in items])
            noisy = np.stack([n[:length] for _, n, _ in items])
            yield clean, noisy, [fid for _, _, fid in items]
        self._epoch += 1
