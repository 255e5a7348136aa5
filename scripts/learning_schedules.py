#!/usr/bin/env python3
"""How chip_smoke.py phase 16a's routes learn the texture task under a few
learning-rate settings, over several seeds, on one NVIDIA GPU.

    python3 scripts/learning_schedules.py [--seeds 6] [--first-seed 0]
        [--settings KEY,...] [--routes fused,...] [--dtypes bfloat16,float32]
        [--weights PATH]

Each run is chip_smoke.learn_route: a DeiT-Tiny from fresh weights (the
seed's, or the state dict at ``--weights``), 100 steps at B = 128 on phase
16's texture data; it prints the train top-1 of the last step, the mean
train top-1 of the last 10 steps, the first step above 85% and the held-out
top-1. The settings (SETTINGS: TrainConfig fields over phase 16's, one
schedule epoch a step) run in turn, each on every dtype and route. Routes:
chip_smoke's 'fused', 'pairs' and 'unfused'; 'plain', the model's own
PyTorch ops with no kernel; and 'fused-plain', the fused route with the
block's plain versions (the functions its kernels are held against) in
place of its kernels, on the card. The defaults are the fused route, both
dtypes, every setting and six seeds.

``--weights`` takes the JAX 224 px test's initial weights as
``python -m tests.test_torch_learning --deit-tiny-224 PATH`` writes them
(on the CPU, where JAX runs); with it the seeds move only the augmentation.
"""

import contextlib
import os
import subprocess
import sys

# key -> (name, TrainConfig fields); every other field is phase 16's
_CONSTANT = dict(sched="step", decay_rate=1.0, warmup_epochs=0)
_COSINE = dict(sched="cosine", warmup_epochs=0)
SETTINGS = {
    "constant": ("constant 2e-3 (the JAX TPU test's)", dict(_CONSTANT, lr=2e-3)),
    "cosine": ("cosine from 2e-3", dict(_COSINE, lr=2e-3)),
    "constant-1e-3": ("constant 1e-3", dict(_CONSTANT, lr=1e-3)),
    "cosine-1e-3": ("cosine from 1e-3", dict(_COSINE, lr=1e-3)),
    "step-1e-3": ("1e-3, a tenth of it from step 80",
                  dict(sched="step", decay_rate=0.1, decay_epochs=80, warmup_epochs=0,
                       lr=1e-3)),
    "constant-1e-3-clip": ("constant 1e-3, clip 1.0", dict(_CONSTANT, lr=1e-3, clip_grad=1.0)),
    "cosine-1e-3-clip": ("cosine from 1e-3, clip 1.0", dict(_COSINE, lr=1e-3, clip_grad=1.0)),
    "warmup10-constant-1e-3": ("10 warmup steps, constant 1e-3",
                               dict(_CONSTANT, lr=1e-3, warmup_epochs=10)),
    "warmup10-cosine-1e-3": ("10 warmup steps, cosine from 1e-3",
                             dict(_COSINE, lr=1e-3, warmup_epochs=10)),
    "warmup10-cosine": ("10 warmup steps, cosine from 2e-3",
                        dict(_COSINE, lr=2e-3, warmup_epochs=10)),
    "warmup20-cosine": ("20 warmup steps, cosine from 2e-3 (phase 16's)",
                        dict(_COSINE, lr=2e-3, warmup_epochs=20)),
}


def _option(argv, flag, default):
    return argv[argv.index(flag) + 1] if flag in argv else default


@contextlib.contextmanager
def _plain_block(cs, fb):
    """The fused block's plain forward and backward in place of its kernels,
    with no kernel launch expected."""
    saved = fb.block_fwd, fb.block_bwd, cs._no_fallback

    def no_launch(what, launches, expect, plain):
        if launches:
            raise AssertionError(f"{what}: kernel launches {launches}, expected none")

    fb.block_fwd, fb.block_bwd, cs._no_fallback = fb._plain_fwd, fb._plain_bwd, no_launch
    try:
        yield
    finally:
        fb.block_fwd, fb.block_bwd, cs._no_fallback = saved


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("learning_schedules: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs
    from deltakd_tpu_torch.ops import _build
    from deltakd_tpu_torch.ops import attention as at
    from deltakd_tpu_torch.ops import fused_block as fb
    from deltakd_tpu_torch.ops import fused_mlp as fm
    from deltakd_tpu_torch.ops import sort as so

    first = int(_option(argv, "--first-seed", "0"))
    seeds = range(first, first + int(_option(argv, "--seeds", "6")))
    settings = _option(argv, "--settings", ",".join(SETTINGS)).split(",")
    routes = _option(argv, "--routes", "fused").split(",")
    dtypes = _option(argv, "--dtypes", "bfloat16,float32").split(",")
    path = _option(argv, "--weights", None)
    weights = torch.load(path) if path else None
    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.py runs phase 16
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    _build.build(_build.SOURCES)
    mods = (fb, so, at, fm)
    data = cs.learn_data()
    for key in settings:
        name, fields = SETTINGS[key]
        for dtype in dtypes:
            for route in routes:
                what = f"{name}, {route} {dtype}" + (f", from {path}" if path else "")
                passed = 0
                for seed in seeds:
                    with (_plain_block(cs, fb) if route == "fused-plain"
                          else contextlib.nullcontext()):
                        out = cs.learn_route(mods, route.split("-")[0], dtype, data, seed, smi,
                                             weights, **fields)
                    passed += out["ok"]
                    print(f"[schedules] {what} seed {seed} ({smi}): train top-1 "
                          f"{out['train']:.1f}% at step {cs.LEARN_STEPS}, {out['last10']:.1f}% "
                          f"over the last 10 steps, first above {cs.LEARN_BAR:.0f}% at step "
                          f"{out['first']}, held-out top-1 {out['heldout']:.1f}%, loss "
                          f"{out['loss']:.3f}: {'ok' if out['ok'] else 'below the bar'}",
                          flush=True)
                print(f"[schedules] {what}: {passed} of {len(seeds)} seeds (from seed {first}) "
                      f"above the bar")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
