#!/usr/bin/env python3
"""Times an attention kernel of this checkout's package beside copies of the
package with one edit of its source each (VARIANTS), on one NVIDIA GPU, in
turns: the tree, the variant, the variant, the tree. A variant names its
kernel: the fp32 attention forward (`flash_fwd_f32`) at the main path's
shapes ([1536, 198, 64] and [768, 198, 64], chip_smoke.py's ATTN_MAIN), or
the bf16 attention backward (`flash_bwd`) on its split route at the student's
448 and 512 px shapes ([96, 786, 64], [96, 1026, 64]) and at [768, 704, 64].
Each copy lives under the git-ignored `.scratch/variants/`, builds its own
attention library there and is timed in a process of its own (chip_smoke.py's
`_timed`: the median of per-call CUDA-event times).

    python3 scripts/time_attention_variants.py           # every variant
    python3 scripts/time_attention_variants.py turns     # the named ones

Prints the card's name and power limit, each run's ms, and last one JSON
object {"rows": {variant: {"tree": [[ms at each shape], ...],
"variant": [...]}}}. Exits 1 without a card.
"""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "deltakd_tpu_torch/ops/csrc/attention_fwd.cuh"
BWD = "deltakd_tpu_torch/ops/csrc/attention_bwd.cuh"
# the shapes each kernel is timed at: [B*H, N, 64]
SHAPES = {"flash_fwd_f32": ((1536, 198), (768, 198)),
          "flash_bwd": ((96, 786), (96, 1026), (768, 704))}
# name -> (kernel, file, text, its replacement)
VARIANTS = {
    # the two consumer warpgroups issue their batches of wgmmas when they are
    # ready, without taking turns
    "turns": ("flash_fwd_f32", SRC, "constexpr bool TAKE_TURNS = true;",
              "constexpr bool TAKE_TURNS = false;"),
    # other splits of the registers between the producer and the consumers
    "registers 72/216": ("flash_fwd_f32", SRC,
                         "constexpr int PRODUCER_REGS = 120, CONSUMER_REGS = 192;",
                         "constexpr int PRODUCER_REGS = 72, CONSUMER_REGS = 216;"),
    "registers 152/176": ("flash_fwd_f32", SRC,
                          "constexpr int PRODUCER_REGS = 120, CONSUMER_REGS = 192;",
                          "constexpr int PRODUCER_REGS = 152, CONSUMER_REGS = 176;"),
    # its registers not held to three CTAs an SM
    "registers unbounded": ("flash_bwd", BWD, "constexpr int SPLIT_CTAS = 3;",
                            "constexpr int SPLIT_CTAS = 1;"),
    # a diagnostic, not a design (its gradients are wrong): the split route's
    # dK/dV half without the copies of the query tiles after the first, every
    # pair on it (what the L2 traffic of its Q and dO costs)
    "no next query tiles (wrong results)": (
        "flash_bwd", BWD,
        "    if (i + 1 < tiles) {\n      load_tile_async(Qs + (cur ^ 1) * TILE",
        "    if (false) {\n      load_tile_async(Qs + (cur ^ 1) * TILE"),
}


def _time_package(pkg, kernel):
    """Worker: the ms of ``kernel`` at each of its shapes for the package
    under pkg, as one JSON line."""
    sys.path.insert(0, pkg)
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke
    from deltakd_tpu_torch.ops import attention as at

    if not os.path.abspath(at.__file__).startswith(pkg + os.sep):
        raise RuntimeError(f"imported {at.__file__}, not the package under {pkg}")
    ms = []
    for bh, n in SHAPES[kernel]:
        fp32 = kernel.endswith("_f32")
        q, k, v, do = chip_smoke._attention_inputs((bh, n, chip_smoke.HEAD_DIM), 3, fp32=fp32)
        if kernel.startswith("flash_fwd"):
            ms.append(chip_smoke._timed(lambda: at.kernel_flash_fwd(q, k, v), 20))
        else:
            o, lse = at.kernel_flash_fwd(q, k, v)
            ms.append(chip_smoke._timed(lambda: at.kernel_flash_bwd(q, k, v, o, lse, do), 20))
            del o, lse
        del q, k, v, do
        torch.cuda.empty_cache()
    print(json.dumps(ms))


def _run(pkg, kernel):
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--package", pkg, kernel],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"timing {pkg} failed:\n{proc.stdout}{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    if sys.argv[1:2] == ["--package"]:
        _time_package(os.path.abspath(sys.argv[2]), sys.argv[3])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_attention_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    rows = {}
    for name in sys.argv[1:] or list(VARIANTS):
        kernel, rel, old, new = VARIANTS[name]
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
            got[which].append(_run(pkg, kernel))
            print(f"[variant] {name} {which}: {kernel} " + ", ".join(
                f"[{bh},{n},64] {ms:.4f} ms" for (bh, n), ms in zip(SHAPES[kernel],
                                                                    got[which][-1])), flush=True)
        rows[name] = got
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
