"""Data loader (`hilcodec_tpu/data/loader.py`): rank-strided sharding,
batching and thread-pool prefetch of numpy batches.

Each shard takes a strided slice of the index space (DistributedSampler
semantics without shuffling) and a thread pool decodes and collates ahead
of the device. Every item gets its own numpy Generator keyed by (seed,
epoch, shard, batch, position), so two runs with one seed read the same
batches at any number of workers.
"""

from __future__ import annotations

import inspect
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from .datasets import DirectoriesDataset, FilelistDataset, collate


class DataLoader:
    """Map-style loader: shards indices rank-strided, batches, prefetches.

    drop_last=False pads the index list so every rank sees the same number
    of batches (DistributedSampler padding semantics).
    """

    def __init__(self, dataset, batch_size: int, num_workers: int = 2,
                 collate_fn: Optional[Callable] = None,
                 num_shards: int = 1, shard: int = 0,
                 drop_last: bool = False, prefetch: int = 2,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or collate
        self.num_shards = num_shards
        self.shard = shard
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0

    def _indices(self) -> List[int]:
        n = len(self.dataset)
        if self.drop_last:
            per_shard = n // self.num_shards
            idx = list(range(n))[:per_shard * self.num_shards]
        else:
            per_shard = -(-n // self.num_shards)
            idx = list(range(n))
            while len(idx) < per_shard * self.num_shards:
                idx += idx[:per_shard * self.num_shards - len(idx)]
        return idx[self.shard::self.num_shards]

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        indices = self._indices()
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        self.epoch += 1
        epoch = self.epoch
        # Thread-safe determinism (no global RNG state is touched): each
        # item gets its own Generator keyed by (seed, epoch, shard, batch,
        # position). Two fresh runs with the same seed draw byte-identical
        # batches at any num_workers; global random/np.random are untouched.
        try:
            rng_aware = "rng" in inspect.signature(
                self.dataset.__getitem__).parameters
        except (TypeError, ValueError):
            rng_aware = False
        if not rng_aware and not getattr(self, "_warned_rng", False):
            # all in-repo datasets take rng=; an external one that doesn't
            # loses run-to-run determinism (its own randomness, if any, is
            # unseeded here) — say so once instead of silently regressing
            self._warned_rng = True
            warnings.warn(
                f"{type(self.dataset).__name__}.__getitem__ has no rng= "
                "parameter; per-item sampling (if any) will not be "
                "deterministic across runs", stacklevel=2)

        def load_batch(args):
            bi, batch_idx = args
            items = []
            for j, i in enumerate(batch_idx):
                if rng_aware:
                    ss = np.random.SeedSequence(
                        [self.seed, epoch, self.shard, bi, j])
                    items.append(self.dataset.__getitem__(
                        i, rng=np.random.default_rng(ss)))
                else:
                    items.append(self.dataset[i])
            return self.collate_fn(items)

        if self.num_workers <= 1:
            for bi, b in enumerate(batches):
                yield load_batch((bi, b))
            return

        with ThreadPoolExecutor(self.num_workers) as pool:
            window = self.num_workers + self.prefetch
            futures = []
            it = iter(enumerate(batches))
            for _ in range(window):
                try:
                    futures.append(pool.submit(load_batch, next(it)))
                except StopIteration:
                    break
            while futures:
                out = futures.pop(0).result()
                try:
                    futures.append(pool.submit(load_batch, next(it)))
                except StopIteration:
                    pass
                yield out


_DATASETS = {
    "Dataset": FilelistDataset,
    "DirectoriesDataset": DirectoriesDataset,
}


def get_dataset_dataloader(hps, mode: str, keys: List[str],
                           num_shards: int = 1, shard: int = 0,
                           devices_per_shard: int = 1):
    """Mode-aware dataset + loader factory.

    `devices_per_shard`: local chips fed by this process's loader. The
    config batch_size is per device; the dataset is
    built with the FINAL global batch (batch_size * devices_per_shard *
    num_shards) so its length-sorted batch grouping matches the emitted
    batch boundaries exactly."""
    dataset_cfg = hps.data.dataset
    name = dataset_cfg[mode] if not isinstance(dataset_cfg, str) \
        else dataset_cfg
    if name not in _DATASETS:
        raise NotImplementedError(
            f"dataset {name!r} is not ported to hilcodec_tpu_torch yet; see "
            "ROADMAP.md (Queue 1, framework-neutral modules)")
    cls = _DATASETS[name]

    hp = hps.train
    batch_size = hp.get("batch_size", 1)
    num_workers = hp.get("num_workers", 2)
    drop_last = hp.get("drop_last", False)
    if mode == "valid":
        cfg = hps.get("valid", {})
        batch_size = cfg.get("batch_size", batch_size)
        num_workers = cfg.get("num_workers", num_workers)
        drop_last = cfg.get("drop_last", drop_last)
    elif mode == "infer":
        cfg = hps.get("infer", {})
        batch_size = cfg.get("batch_size", 1)
        num_workers = cfg.get("num_workers", 0)
        drop_last = False
    elif mode == "pesq":
        cfg = hps.get("pesq", {})
        batch_size = cfg.get("batch_size", batch_size)
        num_workers = cfg.get("num_workers", num_workers)
        drop_last = False
    elif mode != "train":
        raise ValueError(f"unknown mode {mode}")

    batch_size *= devices_per_shard
    dataset = cls(hps.data, keys, mode=mode,
                  batch_size=batch_size * num_shards, verbose=(shard == 0))
    loader = DataLoader(dataset, batch_size=batch_size,
                        num_workers=num_workers, num_shards=num_shards,
                        shard=shard, drop_last=drop_last,
                        seed=hp.get("seed", 0))
    return dataset, loader
