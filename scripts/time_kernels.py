#!/usr/bin/env python3
"""Times the kernels of one checkout of deltakd_tpu_torch on one NVIDIA GPU:
the attention kernels (flash_fwd, flash_bwd) and the sort kernels (value
sort, sorted_l1 forward and backward) at the main path's shapes beside their
plain versions, bounds and library calls, and the fused-MLP forward at every
zoo width (D = 192, 384, 768, 1024; M = 50688, fp32 parameters as the model
passes them) beside its library call; with --blocks also the bf16 block and
pair kernels (rows 1, 2, 7, 8), with --fp32 the fp32 forms of rows 1-8,
with --long rows 2, 4 and 8 at 448 and 512 px, with --bits the digests of
rows 1, 3 and 9-11.

    python3 scripts/time_kernels.py                  # this checkout's package
    python3 scripts/time_kernels.py --package DIR    # the package under DIR
    python3 scripts/time_kernels.py --steps 8        # and 8 train steps of each path below
    python3 scripts/time_kernels.py --fp32 --blocks --steps 4   # every row, the fp32 steps
    python3 scripts/time_kernels.py --long --blocks  # rows 2, 4, 8 at N = 198 and the long N
    python3 scripts/time_kernels.py --blocks --bits  # and the bits of rows 1, 3, 9-11

DIR is the root of another checkout (for example an earlier commit unpacked
with `git archive` into a git-ignored directory), so that two commits'
kernels can be timed in one run on one card: run it as parent, change,
change, parent. The timing is chip_smoke.py's `time_attention_kernels`,
`time_sort_kernels` and `time_mlp_widths` (with --blocks `time_kernels` and
`time_pair_kernels`, phases 3b and 8b; with --fp32 `time_fp32_kernels` and
`time_fp32_rows_6_8`, phases 13d and 14a, the kernels inside one fp32
block forward at D = 384 and at D = 192, one fp32 attention backward and
one fp32 block backward by `torch.profiler` (`profile_calls`; the
forward's show the attention forward's share of rows 1 and 2, whose
recompute is the D = 192 forward), and, where the package has them, the fp32 weight
gradient alone at the backward's four products, `check_fp32_weight_grads`,
and the fp32 linear product alone at the forward's four products and the
backward's four input gradients, `check_fp32_linear`), which
call the package's kernel wrappers and plain versions only, each holding
its kernels at the main shape first; the kernels are built first into
DIR's own build directory (the build's seconds are printed). With
--steps N it also runs N unfused soft-KD steps and N WassKD-l1 steps on the
fused-block path (chip_smoke.py's `run_train_path`: full width, batch 256,
random weights), the steps that launch flash_bwd and the sorted_l1 forward;
with --fp32 instead the three fp32 soft steps (fused, paired, unfused),
and their peak allocated memory. With --long: chip_smoke.py's
`time_long_sequences` (phase 18c: rows 2, 4, 8 at B = 32, 3 heads, N = 786
and 1026 beside SDPA and the library blocks, rows 9-11 at [16, 1296, 384]),
`time_split_switch` where the package has the split route (flash_bwd's
short and split routes forced at N = 198 to 704, B*H = 96 and 768), and one
soft-KD step at 448 px (B = 32) on the fused, paired and unfused routes
with its peak allocated memory (`_long_step`). Prints the card's name and power limit,
chip_smoke.py's `[time]` lines, and last one JSON object {"package": DIR,
"rows": {name: {"ms", "plain_ms", "library_ms", "bound_ms", and for the
value sort the same in fp32 with a "fp32_" prefix}}, "mlp_widths": {D:
{"ms", "library_ms", "bound_ms"}}, "step_ms": {path: ms}, "peak_gib":
{path: GiB}, "wgrad_f32": {product: [fp32 ms, bf16 ms, TF32 matmul ms]},
"linear_f32": {product: [fp32 ms, TF32 matmul ms, fp32 matmul ms]},
"workspace": {kernel: bytes}, "long": {"kernel N=n": {...}}, "split_switch":
{"BHxN": [short ms, split ms]}, "long_peak_bytes": {route: bytes}, "bits":
{output: digest}}. With --bits: chip_smoke.py's `main_shape_bits` (a
sha256 digest of each output of rows 1, 3 and 9-11 at the main shapes and
of the sorts at n = 1296 and 4096, inputs drawn with numpy), so that two
packages' bits can be compared. Exits 1 without a card.
"""

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", default=ROOT,
                    help="root of the checkout whose deltakd_tpu_torch is timed")
    ap.add_argument("--steps", type=int, default=0,
                    help="also time this many unfused soft and fused wasskd train steps "
                         "(with --fp32: the fp32 soft steps, fused, paired and unfused)")
    ap.add_argument("--blocks", action="store_true",
                    help="also time the bf16 block and pair kernels (rows 1, 2, 7, 8)")
    ap.add_argument("--fp32", action="store_true",
                    help="also time the fp32 forms of rows 1-8")
    ap.add_argument("--long", action="store_true",
                    help="also time rows 2, 4, 8 at 448 and 512 px (phase 18c), the bf16 "
                         "attention backward's two routes below its switch and the 448 px "
                         "step's peak memory")
    ap.add_argument("--bits", action="store_true",
                    help="also print the digests of rows 1, 3 and 9-11 at the main shapes")
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    from deltakd_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build()
    print(f"[build] compiled {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    worst = {}
    rows = {**chip_smoke.time_attention_kernels(at), **chip_smoke.time_sort_kernels(so)}
    if args.blocks:
        rows.update(chip_smoke.time_kernels(fb, worst))
        rows.update(chip_smoke.time_pair_kernels(fb))
    wgrad, linear = {}, {}
    if args.fp32:
        rows.update(chip_smoke.time_fp32_kernels(fb, at, fm, worst, smi))
        rows.update(chip_smoke.time_fp32_rows_6_8(fb, fm, worst, smi))
        # the kernels inside one fp32 block forward at either width, the fp32
        # attention backward and the fp32 block backward
        for D, H in ((384, 6), (192, 3)):
            p, x, sa, sm = chip_smoke._block_inputs(D, H, chip_smoke.B_MAIN, 7, "cuda", fp32=True)
            chip_smoke.profile_calls(
                f"fused_block_fwd_f32 D={D}", lambda: fb.kernel_block_fwd(
                    x, p, num_heads=H, scale_attn=sa, scale_mlp=sm, need_features=False))
        bh, n = chip_smoke.ATTN_MAIN["student"], chip_smoke.N_TOK
        q, k, v, do = chip_smoke._attention_inputs((bh, n, chip_smoke.HEAD_DIM), 3, fp32=True)
        o, lse = at.kernel_flash_fwd(q, k, v)
        chip_smoke.profile_calls(f"flash_bwd_f32 [{bh},{n},64]",
                                 lambda: at.kernel_flash_bwd(q, k, v, o, lse, do))
        p, x, sa, sm = chip_smoke._block_inputs(192, 3, chip_smoke.B_MAIN, 7, "cuda", fp32=True)
        g_out = torch.randn_like(x)
        chip_smoke.profile_calls("fused_block_bwd_f32 D=192", lambda: fb.kernel_block_bwd(
            x, p, g_out, None, num_heads=3, scale_attn=sa, scale_mlp=sm))
        try:
            fb._library("fused_block_bwd").dk_weight_grad_sm90_f32
        except AttributeError:   # a package from before the fp32 weight gradient's entry
            pass
        else:
            wgrad = {f"{name} D={D}": list(t) for (name, D), t in
                     chip_smoke.check_fp32_weight_grads(fb, worst, timed=True).items()}
        if hasattr(fb, "kernel_tf32_split"):   # a package with the fp32 linear product alone
            linear = {f"{kind} {name} D={D}": list(t) for (kind, name, D), t in
                      chip_smoke.check_fp32_linear(fb, worst, timed=True).items()}
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    keys += tuple(f"fp32_{k}" for k in keys)   # the value sort's fp32 timing
    result = {"package": pkg,
              "rows": {(k if isinstance(k, str) else f"{k[0]}[{k[1]}]"):
                       {n: r[n] for n in keys if n in r} for k, r in rows.items()},
              "mlp_widths": {D: dict(ms=ms, library_ms=lib, bound_ms=bound)
                             for D, (ms, lib, bound) in chip_smoke.time_mlp_widths(fm).items()}}
    if wgrad:
        result["wgrad_f32"] = wgrad
    if linear:
        result["linear_f32"] = linear
    if args.fp32:
        shape = (chip_smoke.B_MAIN, chip_smoke.N_TOK, 192)
        result["workspace"] = {name: fb.workspace_bytes(name, shape, 3, 4 * 192)
                               for name in ("fused_block_bwd_f32", "fused_pair_bwd_f32")}
        result["workspace"]["fused_mlp_bwd_f32"] = fm.workspace_bytes(
            chip_smoke.M_MAIN, 192, 4 * 192, "fused_mlp_bwd_f32")
    if args.long:
        long_rows = chip_smoke.time_long_sequences(fb, at, so)
        result["long"] = {f"{kernel if isinstance(kernel, str) else kernel[0]} N={n}": r
                          for kernel, by_n in long_rows.items() for n, r in by_n.items()}
        if "route" in inspect.signature(at.kernel_flash_bwd).parameters:
            result["split_switch"] = chip_smoke.time_split_switch(at)
        cfg = chip_smoke._long_config("soft", chip_smoke.LONG_STEP_PX, chip_smoke.LONG_STEP_B)
        result["long_peak_bytes"] = {}
        for route in ("fused", "paired", "unfused"):
            torch.cuda.empty_cache()
            kept = chip_smoke._long_step((fb, so, at, fm), cfg, route)
            result["long_peak_bytes"][route] = kept[3]
            del kept
        torch.cuda.empty_cache()
    if args.bits:
        result["bits"] = chip_smoke.main_shape_bits(fb, at, so)
    if args.steps:
        mods = (fb, so, at, fm)
        run = chip_smoke.run_train_path
        if args.fp32:
            f32 = dict(dtype="float32")
            steps = {"fp32 soft": run(mods, "soft", args.steps, name="fp32 soft", options=f32),
                     "fp32 paired soft": run(mods, "soft", args.steps, paired=True,
                                             name="fp32 paired soft", options=f32),
                     "fp32 unfused soft": run(mods, "soft", args.steps, name="fp32 unfused soft",
                                              options=dict(f32, mesh_shape=(1, 2)))}
        else:
            steps = {"unfused soft": run(mods, "soft", args.steps, unfused=True),
                     "wasskd": run(mods, "wasskd", args.steps)}
        result["step_ms"] = {k: v[1] for k, v in steps.items()}
        result["peak_gib"] = {k: v[2] / 2**30 for k, v in steps.items()}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
