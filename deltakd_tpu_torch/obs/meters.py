"""Windowed metric meters and progress logging (``deltakd_tpu/obs/meters.py``).

The reference's ``SmoothedValue``/``MetricLogger`` (reference
logs/logger.py:27-161): window-20 median/avg, global averages, and a
``log_every`` generator printing eta / iteration time / data-wait time. The
meters hold host floats; the train loop feeds them only at its log points.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Iterator


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = None):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt or "{median:.4f} ({global_avg:.4f})"

    def update(self, value: float, n: int = 1) -> None:
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self) -> None:
        """Sums (count, total) over the processes of an initialised
        ``torch.distributed`` group; does nothing otherwise."""
        import torch
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        t = torch.tensor([self.count, self.total], dtype=torch.float64, device=device)
        dist.barrier()
        dist.all_reduce(t)
        self.count = int(t[0].item())
        self.total = float(t[1].item())

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        n = len(d)
        if n == 0:
            return 0.0
        return d[n // 2] if n % 2 else 0.5 * (d[n // 2 - 1] + d[n // 2])

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "\t", printer=print):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.printer = printer

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def synchronize_between_processes(self) -> None:
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def global_avgs(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}

    def log_every(self, iterable: Iterable, print_freq: int, header: str = "",
                  total: int = None, is_main: bool = True) -> Iterator:
        i = 0
        total = total if total is not None else len(iterable)
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if is_main and (i % print_freq == 0 or i == total - 1):
                eta = iter_time.global_avg * (total - i)
                self.printer(self.delimiter.join([
                    header, f"[{i}/{total}]",
                    f"eta: {datetime.timedelta(seconds=int(eta))}",
                    str(self), f"time: {iter_time}", f"data: {data_time}"]))
            i += 1
            end = time.time()
        if is_main and total:
            elapsed = time.time() - start
            self.printer(f"{header} Total time: "
                         f"{datetime.timedelta(seconds=int(elapsed))} "
                         f"({elapsed / max(total, 1):.4f} s / it)")
