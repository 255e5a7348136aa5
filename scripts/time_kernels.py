#!/usr/bin/env python3
"""Times the unfused path's and the sort path's kernels of one checkout of
deltakd_tpu_torch on one NVIDIA GPU: the attention kernels (flash_fwd,
flash_bwd) and the sort kernels (value sort, sorted_l1 forward and backward)
at the main path's shapes beside their plain versions, bounds and library
calls, and the fused-MLP forward at every zoo width (D = 192, 384, 768, 1024;
M = 50688, fp32 parameters as the model passes them) beside its library call.

    python3 scripts/time_kernels.py                  # this checkout's package
    python3 scripts/time_kernels.py --package DIR    # the package under DIR
    python3 scripts/time_kernels.py --steps 8        # and 8 train steps of each path below

DIR is the root of another checkout (for example an earlier commit unpacked
with `git archive` into a git-ignored directory), so that two commits'
kernels can be timed in one run on one card: run it as parent, change,
change, parent. The timing is chip_smoke.py's `time_attention_kernels`,
`time_sort_kernels` and `time_mlp_widths`, which call the package's kernel
wrappers and plain versions only; the kernels are built on their first call
into DIR's own build directory. With --steps N it also runs N unfused
soft-KD steps and N WassKD-l1 steps on the fused-block path (chip_smoke.py's
`run_train_path`: full width, batch 256, random weights), the steps that
launch flash_bwd and the sorted_l1 forward. Prints the card's name and power
limit, chip_smoke.py's `[time]` lines, and last one JSON object {"package":
DIR, "rows": {name: {"ms", "plain_ms", "library_ms", "bound_ms", and for the
value sort the same in fp32 with a "fp32_" prefix}},
"mlp_widths": {D: {"ms", "library_ms", "bound_ms"}}, "step_ms": {path: ms}}.
Exits 1 without a card.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", default=ROOT,
                    help="root of the checkout whose deltakd_tpu_torch is timed")
    ap.add_argument("--steps", type=int, default=0,
                    help="also time this many unfused soft and fused wasskd train steps")
    args = ap.parse_args()
    pkg = os.path.abspath(args.package)
    sys.path.insert(0, pkg)

    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    # this checkout's chip_smoke.py, whatever checkout the package comes from
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from deltakd_tpu_torch.ops import attention as at
    from deltakd_tpu_torch.ops import fused_block as fb
    from deltakd_tpu_torch.ops import fused_mlp as fm
    from deltakd_tpu_torch.ops import sort as so

    for mod in (at, fb, fm, so):
        if not os.path.abspath(mod.__file__).startswith(pkg + os.sep):
            raise RuntimeError(f"imported {mod.__file__}, not the package under {pkg}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    rows = {**chip_smoke.time_attention_kernels(at), **chip_smoke.time_sort_kernels(so)}
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    keys += tuple(f"fp32_{k}" for k in keys)   # the value sort's fp32 timing
    result = {"package": pkg,
              "rows": {(k if isinstance(k, str) else f"{k[0]}[BH={k[1]}]"):
                       {n: r[n] for n in keys if n in r} for k, r in rows.items()},
              "mlp_widths": {D: dict(ms=ms, library_ms=lib, bound_ms=bound)
                             for D, (ms, lib, bound) in chip_smoke.time_mlp_widths(fm).items()}}
    if args.steps:
        mods = (fb, so, at, fm)
        result["step_ms"] = {
            "unfused soft": chip_smoke.run_train_path(mods, "soft", args.steps, unfused=True)[1],
            "wasskd": chip_smoke.run_train_path(mods, "wasskd", args.steps)[1]}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
