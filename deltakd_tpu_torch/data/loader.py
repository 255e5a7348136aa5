"""The loader factory (``deltakd_tpu/data/tfdata.py`` ``make_loader``) and the
multi-process loader that ``--data-loader tfdata`` selects.

The JAX package hands file decoding to tf.data's C++ runtime. Here the same
flag maps to a ``torch.utils.data.DataLoader`` over a file-backed source:
``num_workers`` spawned processes decode the images, and with ``pin_memory``
the batches arrive in pinned host memory. It takes its batches' indices from
``Loader.batch_indices``, so it yields the same batches as ``Loader``, as
torch tensors instead of numpy arrays.
"""

from __future__ import annotations

import warnings
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from deltakd_tpu_torch.data.pipeline import Loader
from deltakd_tpu_torch.data.sources import decode_standardized


class _FileDataset(torch.utils.data.Dataset):
    """(path, label) samples decoded onto the source's raw canvas."""

    def __init__(self, samples: Sequence[Tuple[str, int]], raw_size: int):
        self.samples = list(samples)
        self.raw_size = raw_size

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int):
        path, label = self.samples[idx]
        return decode_standardized(path, self.raw_size), label


def _collate(items: List[Tuple[np.ndarray, int]]):
    images = torch.from_numpy(np.stack([im for im, _ in items]))
    labels = torch.tensor([label for _, label in items], dtype=torch.int32)
    return images, labels


class TorchDataLoader:
    """``Loader``'s interface over a ``torch.utils.data.DataLoader``."""

    def __init__(self, source, *, batch_size: int, is_train: bool, world: int = 1,
                 rank: int = 0, repeated_aug: bool = False, seed: int = 0,
                 num_workers: int = 0, pin_memory: bool = False):
        if not hasattr(source, "samples"):
            raise ValueError("the DataLoader route needs a file-backed source "
                             "(ImageFolder layout); array-backed datasets "
                             "(CIFAR, synthetic) use Loader")
        self.plan = Loader(source, batch_size=batch_size, is_train=is_train,
                           world=world, rank=rank, repeated_aug=repeated_aug,
                           seed=seed)
        self.dataset = _FileDataset(source.samples, source.raw_size)
        self.num_workers = num_workers
        self.pin_memory = pin_memory

    def steps_per_epoch(self, epoch: int = 0) -> int:
        return self.plan.steps_per_epoch(epoch)

    def __len__(self) -> int:
        return self.plan.steps_per_epoch(0)

    def epoch(self, epoch: int) -> Iterator[Tuple[torch.Tensor, torch.Tensor, int]]:
        steps = list(self.plan.batch_indices(epoch))
        dl = torch.utils.data.DataLoader(
            self.dataset, batch_sampler=[idx.tolist() for idx, _ in steps],
            collate_fn=_collate, pin_memory=self.pin_memory, num_workers=self.num_workers,
            # spawned, not forked: the parent runs threads
            multiprocessing_context="spawn" if self.num_workers > 0 else None)
        for (images, labels), (_, n_valid) in zip(dl, steps):
            yield images, labels, n_valid


def make_loader(cfg, source, *, is_train: bool, batch_size: int, world: int = 1,
                rank: int = 0, repeated_aug: bool = False, seed: int = 0,
                pin_memory: bool = False):
    """``Loader``, or with ``--data-loader tfdata`` on a file-backed source the
    ``TorchDataLoader``; on an array-backed source that flag warns and falls
    back to ``Loader``, as in the JAX package."""
    if cfg.data_loader == "tfdata":
        if hasattr(source, "samples"):
            return TorchDataLoader(source, batch_size=batch_size, is_train=is_train,
                                   world=world, rank=rank, repeated_aug=repeated_aug,
                                   seed=seed, num_workers=cfg.num_workers,
                                   pin_memory=pin_memory)
        warnings.warn(
            "--data-loader tfdata requested but the dataset is array-backed "
            "(CIFAR/synthetic) — falling back to the python loader, which is "
            "already zero-decode for in-memory arrays", stacklevel=2)
    return Loader(source, batch_size=batch_size, is_train=is_train, world=world,
                  rank=rank, repeated_aug=repeated_aug, seed=seed)
