#!/usr/bin/env python3
"""Times the fused-MLP forward kernel of one checkout of deltakd_tpu_torch at
every zoo width (D = 192, 384, 768, 1024; M = 50688, fp32 parameters as the
model passes them) beside its library call, on one NVIDIA GPU.

    python3 scripts/time_mlp_forward.py                  # this checkout's package
    python3 scripts/time_mlp_forward.py --package DIR    # the package under DIR

DIR is the root of another checkout (for example an earlier commit unpacked
with `git archive` into a git-ignored directory), so that two commits' kernels
can be timed in one run on one card: run it as parent, change, change,
parent. The timing is chip_smoke.py's `time_mlp_widths`, which calls nothing
of the package but `kernel_fused_mlp`; the kernel is built on its first call
into DIR's own build directory. Prints the card's name and power limit, one
`[time]` line a width, and last one JSON object
{"package": DIR, "rows": {D: {"ms", "library_ms", "bound_ms"}}}.
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
    pkg = os.path.abspath(ap.parse_args().package)
    sys.path.insert(0, pkg)

    import torch

    if not torch.cuda.is_available():
        print("time_mlp_forward: no CUDA device", file=sys.stderr)
        return 1
    # this checkout's chip_smoke.py, whatever checkout the package comes from
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from deltakd_tpu_torch.ops import fused_mlp as fm

    if not os.path.abspath(fm.__file__).startswith(pkg + os.sep):
        raise RuntimeError(f"imported {fm.__file__}, not the package under {pkg}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    rows = chip_smoke.time_mlp_widths(fm)
    print(json.dumps({"package": pkg, "rows": {
        D: dict(ms=ms, library_ms=lib, bound_ms=bound) for D, (ms, lib, bound) in rows.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
