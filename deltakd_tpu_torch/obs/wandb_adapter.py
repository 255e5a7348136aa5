"""wandb adapter (``deltakd_tpu/obs/wandb_adapter.py``).

The reference logs per-epoch train/val dicts and a FLOPs/params/throughput
summary to wandb from rank 0 (reference tools/train.py:243-255, 335-337,
363-364). Where wandb is not installed the adapter does nothing after one
message, so the recipes' ``--wandb`` runs all the same.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


class WandbRun:
    def __init__(self, *, enabled: bool, project: str, name: str,
                 config: Any = None, is_main: bool = True):
        self._run = None
        if not (enabled and is_main):
            return
        try:
            import wandb
        except ImportError:
            print("[wandb] not installed — metrics logging to file only")
            return
        cfg_dict = dataclasses.asdict(config) if dataclasses.is_dataclass(config) else config
        self._run = wandb.init(project=project, name=name, config=cfg_dict)

    def summary(self, values: Dict[str, Any]) -> None:
        if self._run is not None:
            self._run.summary.update(values)

    def log(self, values: Dict[str, Any], step: Optional[int] = None) -> None:
        if self._run is not None:
            self._run.log(values, step=step)

    def finish(self) -> None:
        if self._run is not None:
            self._run.finish()
