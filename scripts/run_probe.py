"""Kernel launches and plain-version calls around the port's ``run()``, for
the outcome scripts (``scripts/equivalence_run.py``, ``scripts/soak_run.py``)
and ``chip_smoke.py`` phase 17.

While entered, ``RunLaunches`` wraps the train step and the eval step that
``train/loop.py`` builds, so that each step records the kernel launches it
made (read off the ops modules' host-side counts, which a wrapper raises
where it launches its kernel and nowhere else), and wraps every
``_plain_*`` function of the ops modules, so that a call of a kernel's plain
version is counted. ``check`` holds every step to the launches of the fused
route (``fused_route_launches``): on the card each train step and each eval
batch must launch exactly those kernels and no plain version may run; on the
CPU, where the wrappers take their plain versions, no kernel may launch.
"""

from __future__ import annotations

import collections
from typing import Dict, Tuple


def ops_modules():
    from deltakd_tpu_torch.ops import attention, fused_block, fused_mlp, sort

    return (fused_block, sort, attention, fused_mlp)


def read_launches(mods) -> Dict:
    return {k: n for mod in mods for k, n in mod.LAUNCHES.items()}


def fused_route_launches(cfg) -> Tuple[Dict, Dict]:
    """(per train step, per eval batch) launches of ``cfg`` on the fused block
    route (kernels on, no model axis, no block pairs): every teacher block's
    forward, every student block's forward and backward at ``cfg.dtype``'s
    form, and WassKD's three ``sorted_l1`` layers; an eval batch runs the
    student's forwards."""
    from deltakd_tpu_torch.models.registry import MODEL_REGISTRY

    form = "_f32" if cfg.dtype == "float32" else ""
    teacher = MODEL_REGISTRY[cfg.teacher_model]
    student = MODEL_REGISTRY[cfg.student_model]
    per_step = collections.Counter()
    if cfg.distillation_type != "none":
        per_step[(f"fused_block_fwd{form}", teacher.embed_dim)] += teacher.depth
    per_step[(f"fused_block_fwd{form}", student.embed_dim)] += student.depth
    per_step[(f"fused_block_bwd{form}", student.embed_dim)] += student.depth
    if cfg.distillation_type == "wasskd" and cfg.wasskd_type == "l1":
        per_step.update({"sorted_l1_fwd": 3, "sorted_l1_bwd": 3})
    return dict(per_step), {(f"fused_block_fwd{form}", student.embed_dim): student.depth}


class RunLaunches:
    """The launches of every train step and eval batch that ``run()`` builds
    while entered, and the calls of every plain version."""

    def __init__(self):
        self.mods = ops_modules()
        self.steps, self.evals = [], []
        self.plain = collections.Counter()

    def _delta(self, before):
        after = read_launches(self.mods)
        return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}

    def _counted_step(self, build, record):
        probe = self

        def built(**kw):
            inner = build(**kw)

            def step(*args, **skw):
                before = read_launches(probe.mods)
                out = inner(*args, **skw)
                record.append(probe._delta(before))
                return out

            return step

        return built

    def _counted_plain(self, key, fn):
        def wrapper(*args, **kw):
            self.plain[key] += 1
            return fn(*args, **kw)

        return wrapper

    def __enter__(self):
        from deltakd_tpu_torch.train import loop

        self._saved = [(loop, name, getattr(loop, name))
                       for name in ("build_train_step", "build_eval_step")]
        for mod in self.mods:
            self._saved += [(mod, name, getattr(mod, name))
                            for name in vars(mod) if name.startswith("_plain_")]
        for mod, name, fn in self._saved:
            if name == "build_train_step":
                setattr(mod, name, self._counted_step(fn, self.steps))
            elif name == "build_eval_step":
                setattr(mod, name, self._counted_step(fn, self.evals))
            else:
                setattr(mod, name, self._counted_plain(
                    f"{mod.__name__.split('.')[-1]}.{name}", fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def totals(self) -> Dict:
        out = collections.Counter()
        for launches in self.steps + self.evals:
            out.update(launches)
        return dict(out)

    def check(self, what: str, per_step: Dict, per_eval: Dict, on_card: bool) -> Dict:
        """Raises unless every train step launched ``per_step`` and every eval
        batch ``per_eval`` (on the card, with no plain version called), or,
        off the card, nothing launched. Returns the totals."""
        if not self.steps:
            raise AssertionError(f"{what}: run() took no train step")
        if not on_card:
            per_step, per_eval = {}, {}
        bad = [("train step", i, got) for i, got in enumerate(self.steps) if got != per_step]
        bad += [("eval batch", i, got) for i, got in enumerate(self.evals) if got != per_eval]
        if bad:
            kind, i, got = bad[0]
            raise AssertionError(
                f"{what}: {len(bad)} steps launched other kernels than expected; {kind} {i}: "
                f"{got}, expected {per_eval if kind == 'eval batch' else per_step}")
        if on_card and self.plain:
            raise AssertionError(f"{what}: plain versions ran on the card: {dict(self.plain)}")
        return self.totals()


def launch_names(launches: Dict) -> Dict[str, int]:
    """Launch counts keyed by strings, as in a JSON file: 'fused_block_fwd
    384'."""
    return {(" ".join(map(str, k)) if isinstance(k, tuple) else k): n
            for k, n in sorted(launches.items(), key=lambda kv: str(kv[0]))}
