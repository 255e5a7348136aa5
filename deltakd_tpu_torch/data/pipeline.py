"""Host input pipeline (``deltakd_tpu/data/pipeline.py``): sharded index
sampling -> uint8 batches -> prefetch.

The host only gathers raw uint8 batches (all augmentation runs on the device,
``data/augment.py``), and a background thread keeps a small queue ahead of
the consumer, so that gathering overlaps the device's work. The batches stay
numpy arrays; the train loop copies them to the card.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from deltakd_tpu_torch.data.sampler import epoch_indices

THREAD_NAME = "deltakd-loader"


class Loader:
    """Epoch-oriented batch loader over a source.

    ``world``/``rank`` shard globally; ``batch_size`` is the per-process batch
    (the reference's --batch-size is per GPU as well, torchrun semantics).
    """

    def __init__(self, source, *, batch_size: int, is_train: bool,
                 world: int = 1, rank: int = 0, repeated_aug: bool = False,
                 seed: int = 0, drop_last: Optional[bool] = None,
                 prefetch: int = 2):
        self.source = source
        self.batch_size = batch_size
        self.is_train = is_train
        self.world = world
        self.rank = rank
        self.repeated_aug = repeated_aug
        self.seed = seed
        # reference: drop_last=is_train (datasets.py:162)
        self.drop_last = is_train if drop_last is None else drop_last
        self.prefetch = prefetch

    def indices(self, epoch: int) -> np.ndarray:
        return epoch_indices(epoch, len(self.source), is_train=self.is_train,
                             world=self.world, rank=self.rank,
                             repeated_aug=self.repeated_aug, seed=self.seed)

    def steps_per_epoch(self, epoch: int = 0) -> int:
        n = len(self.indices(epoch))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __len__(self) -> int:
        return self.steps_per_epoch(0)

    def batch_indices(self, epoch: int):
        """Per step: (the indices of its batch, n_valid). A final partial
        batch (drop_last=False, eval) is padded by wraparound so that shapes
        stay static; ``n_valid`` lets the metrics mask out the padding."""
        indices = self.indices(epoch)
        for step in range(self.steps_per_epoch(epoch)):
            lo = step * self.batch_size
            batch_idx = indices[lo:lo + self.batch_size]
            n_valid = len(batch_idx)
            if n_valid < self.batch_size:
                batch_idx = np.concatenate([batch_idx,
                                            indices[: self.batch_size - n_valid]])
            yield batch_idx, n_valid

    def epoch(self, epoch: int) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        """Yield (uint8 images [B,h,w,3], int32 labels [B], n_valid), gathered
        on a background thread."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # never block indefinitely: the consumer may abandon the generator
            # mid-epoch (steps_per_epoch / eval_steps caps), and a producer
            # stuck in q.put() would leak the thread and its batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # an exception (a corrupt image inside get_batch) is forwarded
            # through the queue; otherwise the consumer would wait forever
            try:
                for batch_idx, n_valid in self.batch_indices(epoch):
                    if stop.is_set():
                        return
                    images, labels = self.source.get_batch(batch_idx)
                    if not put((images, labels, n_valid)):
                        return
                put(None)
            except BaseException as exc:  # noqa: BLE001 - forwarded, not hidden
                put(exc)

        t = threading.Thread(target=producer, name=THREAD_NAME, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
