"""Epoch-seeded, process-sharded index sampling (``deltakd_tpu/data/sampler.py``).

Host-side counterpart of the reference's DistributedSampler / RASampler usage
(reference dataset/datasets.py:126-223): pure numpy over index arrays, the
same indices as the JAX package's bit for bit. A single process shuffles like
any other world size (world=1 is the degenerate shard), where the reference's
single-process path never shuffles (SURVEY.md §2.9, bug B1).
"""

from __future__ import annotations

import numpy as np


def shard_indices(epoch: int, n: int, *, world: int = 1, rank: int = 0,
                  shuffle: bool = True, seed: int = 0) -> np.ndarray:
    """DistributedSampler semantics: pad to a multiple of world, round-robin
    shard by rank, deterministic per-epoch shuffle."""
    if shuffle:
        indices = np.random.default_rng(seed + epoch).permutation(n)
    else:
        indices = np.arange(n)
    num_samples = -(-n // world)
    total = num_samples * world
    if total > n:
        indices = np.concatenate([indices, indices[: total - n]])
    return indices[rank:total:world]


def repeated_aug_indices(epoch: int, n: int, *, world: int = 1, rank: int = 0,
                         num_repeats: int = 3, seed: int = 0) -> np.ndarray:
    """DeiT RASampler (reference dataset/datasets.py:174-223): every index
    repeated ``num_repeats`` times, sharded round-robin, truncated to
    floor(n // 256 * 256 / world) selected samples per process."""
    indices = np.random.default_rng(seed + epoch).permutation(n)
    indices = np.repeat(indices, num_repeats)
    num_samples = -(-n * num_repeats // world)
    total = num_samples * world
    if total > len(indices):
        indices = np.concatenate([indices, indices[: total - len(indices)]])
    shard = indices[rank:total:world]
    if len(shard) != num_samples:
        raise AssertionError(f"shard of {len(shard)} indices, expected {num_samples}")
    return shard[:int(n // 256 * 256 / world)]


def epoch_indices(epoch: int, n: int, *, is_train: bool, world: int, rank: int,
                  repeated_aug: bool, seed: int = 0) -> np.ndarray:
    """The RASampler only for distributed training, as in the reference
    (datasets.py:129-137); otherwise the DistributedSampler's shard."""
    if is_train and repeated_aug and world > 1:
        return repeated_aug_indices(epoch, n, world=world, rank=rank, seed=seed)
    return shard_indices(epoch, n, world=world, rank=rank, shuffle=is_train,
                         seed=seed)
