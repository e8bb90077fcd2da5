"""Data loading with data-parallel sharding.

A copy of ``deepspeed_tpu/runtime/dataloader.py`` (numpy only; the
reference is DeepSpeed's ``deepspeed/runtime/dataloader.py``,
DeepSpeedDataLoader :33, RepeatingLoader :10): a numpy batcher that
yields this process's shard of each global batch, shuffled per epoch
from ``seed + epoch`` as the JAX package shuffles, so both packages draw
the same batches in the same order. The engine moves each batch to its
device.
"""
import numpy as np


class RepeatingLoader:
    """Wrap an iterator to restart on StopIteration (reference :10)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __len__(self):
        return len(self.loader)

    def __next__(self):
        try:
            batch = next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            batch = next(self.data_iter)
        return batch


def _default_collate(samples):
    """Stack a list of per-sample tuples/dicts/arrays into batched numpy."""
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_default_collate([s[i] for s in samples])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _default_collate([s[k] for s in samples]) for k in first}
    arrs = [np.asarray(s) for s in samples]
    return np.stack(arrs)


class DeepSpeedDataLoader:
    """DP-sharded batch loader (reference :33).

    Yields numpy batches of ``batch_size = micro_batch * local_dp_ranks`` for
    this process, drawn from the process's contiguous shard of the dataset
    (the DistributedSampler equivalent). Works with any dataset exposing
    ``__len__``/``__getitem__`` (incl. torch datasets).
    """

    def __init__(self, dataset, batch_size, local_rank=0, collate_fn=None,
                 data_parallel_world_size=1, data_parallel_rank=0,
                 shuffle=False, seed=0, drop_last=True, num_local_io_workers=None,
                 pin_memory=False, dataloader_drop_last=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or _default_collate
        self.dp_world_size = data_parallel_world_size
        self.dp_rank = data_parallel_rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last if dataloader_drop_last is None \
            else dataloader_drop_last
        self.epoch = 0
        self.len = self._shard_len() // batch_size if self.drop_last else \
            -(-self._shard_len() // batch_size)

    def _shard_len(self):
        return len(self.dataset) // self.dp_world_size

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _shard_indices(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(indices)
        per_rank = n // self.dp_world_size
        start = self.dp_rank * per_rank
        return indices[start:start + per_rank]

    def __len__(self):
        return self.len

    def __iter__(self):
        indices = self._shard_indices()
        n_full = len(indices) // self.batch_size * self.batch_size
        if not self.drop_last:
            n_full = len(indices)
        for i in range(0, n_full, self.batch_size):
            chunk = indices[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            samples = [self.dataset[int(j)] for j in chunk]
            yield self.collate_fn(samples)
        self.epoch += 1
