#!/usr/bin/env python3
"""Times the fp32 attention forward (`flash_fwd_f32`) of this checkout's
package at the main path's shapes ([1536, 198, 64] and [768, 198, 64],
chip_smoke.py's ATTN_MAIN) beside copies of the package with one edit of
its source each (VARIANTS), on one NVIDIA GPU, in turns: the tree, the
variant, the variant, the tree. Each copy lives under the git-ignored
`.scratch/variants/`, builds its own attention library there and is timed
in a process of its own (chip_smoke.py's `_timed`: the median of per-call
CUDA-event times).

    python3 scripts/time_attention_variants.py           # every variant
    python3 scripts/time_attention_variants.py turns     # the named ones

Prints the card's name and power limit, each run's ms, and last one JSON
object {"rows": {variant: {"tree": [[ms teacher, ms student], ...],
"variant": [...]}}}. Exits 1 without a card.
"""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "deltakd_tpu_torch/ops/csrc/attention_fwd.cuh"
# name -> (file, text, its replacement)
VARIANTS = {
    # the two consumer warpgroups issue their batches of wgmmas when they are
    # ready, without taking turns
    "turns": (SRC, "constexpr bool TAKE_TURNS = true;", "constexpr bool TAKE_TURNS = false;"),
    # other splits of the registers between the producer and the consumers
    "registers 72/216": (SRC, "constexpr int PRODUCER_REGS = 120, CONSUMER_REGS = 192;",
                         "constexpr int PRODUCER_REGS = 72, CONSUMER_REGS = 216;"),
    "registers 152/176": (SRC, "constexpr int PRODUCER_REGS = 120, CONSUMER_REGS = 192;",
                          "constexpr int PRODUCER_REGS = 152, CONSUMER_REGS = 176;"),
}


def _time_package(pkg):
    """Worker: the ms of flash_fwd_f32 at each main shape for the package
    under pkg, as one JSON line."""
    sys.path.insert(0, pkg)
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke
    from deltakd_tpu_torch.ops import attention as at

    if not os.path.abspath(at.__file__).startswith(pkg + os.sep):
        raise RuntimeError(f"imported {at.__file__}, not the package under {pkg}")
    ms = []
    for bh in (chip_smoke.ATTN_MAIN["teacher"], chip_smoke.ATTN_MAIN["student"]):
        q, k, v, _ = chip_smoke._attention_inputs((bh, chip_smoke.N_TOK, chip_smoke.HEAD_DIM), 3,
                                                  fp32=True)
        ms.append(chip_smoke._timed(lambda: at.kernel_flash_fwd(q, k, v), 20))
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps(ms))


def _run(pkg):
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--package", pkg],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"timing {pkg} failed:\n{proc.stdout}{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    if sys.argv[1:2] == ["--package"]:
        _time_package(os.path.abspath(sys.argv[2]))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_attention_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    rows = {}
    for name in sys.argv[1:] or list(VARIANTS):
        rel, old, new = VARIANTS[name]
        copy = os.path.join(ROOT, ".scratch", "variants", name.replace(" ", "_").replace("/", "_"))
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "deltakd_tpu_torch"),
                        os.path.join(copy, "deltakd_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        path = os.path.join(copy, rel)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise AssertionError(f"variant '{name}': its edit no longer applies to {rel}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
        got = {"tree": [], "variant": []}
        for which, pkg in (("tree", ROOT), ("variant", copy), ("variant", copy), ("tree", ROOT)):
            got[which].append(_run(pkg))
            print(f"[variant] {name} {which}: flash_fwd_f32 teacher {got[which][-1][0]:.4f} ms, "
                  f"student {got[which][-1][1]:.4f} ms", flush=True)
        rows[name] = got
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
