#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (deltakd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                    # the run below, on one card
    python3 chip_smoke.py --faults           # the planted faults (FAULTS), each in a copy
    python3 chip_smoke.py --forward-checks   # only the forward's checks (phase 3a, 3b, 5a)
    python3 chip_smoke.py --backward-checks  # only the backward's checks (phase 3c, 3d)
    python3 chip_smoke.py --mlp-checks       # only the fused-MLP kernels' checks (phase 5c)
    python3 chip_smoke.py --attention-checks # only flash_fwd's and flash_bwd's checks (phase 5a)
    python3 chip_smoke.py --sort-checks      # only the sort kernels' checks (phase 4a)

Phases, each of which fails the run:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from deltakd_tpu_torch/ops/csrc with nvcc (one
     nvcc per source, all started together);
  3. holds each fused-block kernel against its plain PyTorch version on the
     card, for the student (D=192) and teacher (D=384) widths, with and
     without the feature output, with drop-path scales of 0 and 1/keep, at
     B=8; the forward and the backward also at N = 50, 198 and 578 for
     D = 192, 384 and 768 (the pair backward at D = 192 and 384); the GEMM
     alone (gemm_sm90.cuh) against its plain version on the forward's four
     products and the backward's four input and four weight gradients at
     D=192/384, timed beside cuBLAS; prints the forward's and the backward's
     workspace beside the ones that held the [N, N] scores; then
     the block kernels again at the main-path shape (B=256, N=198), where it
     times them beside their plain versions, their bounds and the same block
     built from PyTorch library calls, and splits the backward's time by
     kernel with torch.profiler. Times are medians of per-call CUDA-event
     times with the calls queued behind a sleep on the card, so they are the
     card's and not the host's;
  4. holds the sort kernels (value sort, sorted_l1 forward and backward)
     against their plain versions on inputs with ties at B=8 (n=196, a
     power-of-two n, a d that is no multiple of the column tile, n = 2 and 33
     with d = 40), at [2, 1024, 20] and at the main-path shape
     [256, 196, 384], each float input with -0.0 at one row tied to +0.0 at
     an earlier one: the value sort in bf16, fp16, fp32 and int32 (also at
     d = 1 with n = 196 and 700), its floats with +-inf, a column of NaNs and
     scattered NaNs, its int32 with the extremes, exactly against torch.sort
     (NaNs at the same places, each column's -0.0 count kept, two runs the
     same bits); the sorted_l1 kernels in bf16 and fp32: signs and gradients
     exactly, the loss to 1e-5, t's gradient zero, two runs the same bits;
     then times them at the main-path shape in bf16, the value sort in fp32
     as well;
  5. holds the attention kernels (forward: o and lse; backward: dq, dk, dv) and
     the fused-MLP kernels (forward; backward: dx, dW1, db1, dW2, db2) against
     their plain versions on O(1) inputs (q, k of std 1.5, weights of std
     1/sqrt(fan-in)): attention at [24,198,64], at N=50 (no multiple of 16),
     N=65 (a 64-row tile and one row), N=578 ([4,578,64] and [48,578,64]),
     N=656 (the longest it takes; the backward's shared memory at its
     largest), through the autograd Function on strided views of a packed
     qkv projection, and at the main-path shapes
     [1536,198,64] and [768,198,64]; the MLP at every zoo width D = 192,
     384, 768, 1024 with M=1584 and M=1001 (no row tile divides them) and at
     M=50688 for D = 192, 384; two runs give the same bits; prints the MLP
     backward's workspace, which must be below the earlier design's; then
     times them at the main-path shapes beside their plain versions, their
     bounds and one PyTorch library call (scaled_dot_product_attention;
     linear + gelu + linear), the MLP forward beside the same MLP as two
     products on the block's GEMM (`[mlp two-gemm]`), and the MLP forward
     at every zoo width at M=50688 beside its library call;
  6. runs train steps at full width (DeiT-Small-distilled teacher, DeiT-Tiny-
     distilled student, 224 px, batch 256, random weights from a seed) for
     soft KD, WassKD-l1, MGD and ViTKD, each path with the launch counts set
     to 0 just before and read just after, checking the kernel launches,
     finite metrics, a positive distill loss and changed student (and aux)
     parameters; one eval batch; and the value sort through its public
     function in its four dtypes (no model calls it); then the unfused model path (block_fn=None:
     the teacher through flash_attention and fused_mlp, the student through
     flash_attention): 8 soft-KD steps with exactly 24 attention-forward, 12
     attention-backward, 12 MLP-forward and no fused-block launches a step,
     the device time of one unfused soft step by kernel and by the step's
     parts (`[profile]`), one eval batch on the student's eval view with
     fused_mlp (12 + 12),
     fused_mlp_train forward and backward through its public function (no
     model calls it), and a model without a qkv bias;
  7. checks on 4 images that the card agrees with the plain path on the CPU:
     both models' logits, and for the feature path the features of blocks
     0-2 and the WassKD distill loss; and that the unfused path's logits
     agree with the CPU plain path and with the fused-block path on the card
     on the same weights;
  8. the block-pair path: holds the pair forward and backward kernels against
     their plain versions at B=8 for D=192 and D=384 and the four
     (feat1, feat2) variants, with drop-path scales that hold zeros (one
     sample with all four at 0 must come back as x), and at the main-path
     shape [256, 198, 192] (out - x, feat1, feat2, dx, all 24 dW), two runs
     the same bits; prints how far the pair is from the two single kernels
     chained (they round the activation between the blocks to bf16); checks
     that the cotangent between the two reverse sweeps keeps its fp32 bits
     (one fp32 weight gradient is additive in two cotangents 2^-10 apart); times
     the pair beside its plain version, its bound, two library blocks, the
     two single kernels' sum and the single-forward variant, and prints the
     backward's workspace bytes; then runs the soft, wasskd and vitkd steps
     with the student on block pairs (12 teacher block forwards, 6 pair
     forwards and 6 pair backwards a step, no single-block launch at the
     student's width), an eval batch on the single-block view of the paired
     student (12 block forwards, no pair launch), a depth-3 student (one pair
     and one single block, forward and backward), and compares on the card,
     on the same weights and drop-path masks, the paired student's logits
     with the single-block student's and the CPU plain path, and the
     gradient of a soft-KD loss through both;
  9. (run after phase 6's fused-block paths) the train-time data path at
     B=256, 224 px, cifar-100 (AUG_VARIANTS):
     RandAugment rand-m9-mstd0.5-inc1 and AutoAugment original-mstd0.5 with
     fp32 and bf16 pixel stages from 32 px sources (the geometric ops as a
     dense warp at the source) and from 256 px sources (a gather warp at the
     output), 3-Augment, --src, colour jitter without aa, and aa='' beside
     them: draws made on the card, the transform twice under torch.cuda's
     sync debug mode 'error' (no host sync), the same bits twice, the card
     against the CPU on the same draws stage by stage (the geometric stage,
     then the pixel stage from the same integers); mixup in its batch, elem
     and pair modes, card against CPU; each timed in ms a batch on the card;
 10. the soft recipe path: exp/soft-deit-tiny.sh's configuration (TrainConfig's
     defaults: RandAugment, mixup 0.8 / cutmix 1.0, erasing 0.25, the bf16
     pixel stage; weight decay 1e-4, alpha 0.1, tau 3), its teacher imported
     from a DeiT-S-distilled checkpoint that the script writes to a temporary
     directory (1000-class heads, a 24 x 24 grid, 'module.' keys in a
     {"model": ...} wrapper): the import report (both heads skipped, every
     block loaded, the grid interpolated to 14 x 14, the blocks equal to the
     file's), 8 steps with their launch counts (12 + 12 block forwards and 12
     block backwards a step) and times beside the aa='' soft step, and the
     device time of one step by part, the transform and mixup their own parts
     (`[profile] soft recipe step by part`; the aa='' soft step's too).
It prints a JSON line with the kernels' numbers, then, as the last line,
{"ok": true, "device": {...}}. Without CUDA it exits non-zero and prints no
result.
"""

import copy
import json
import math
import os
import subprocess
import sys
import time

B_CHECK, B_MAIN, N_TOK = 8, 256, 198
TOL = 2e-2            # max |kernel - plain| <= TOL * max |plain| (bf16 rounding
#                       of intermediates at different points; a few bf16 ulps);
#                       for `out` the residual x is taken off both sides first
LOGIT_TOL = 5e-2      # logits, features and the distill loss, card kernels vs
#                       CPU plain path, same formula
LSE_TOL = 1e-3        # attention lse, kernel vs plain, absolute (fp32 both sides)
LOSS_TOL = 1e-5       # sorted_l1 loss, kernel vs plain, relative (fp32 sums in
#                       another order); sorted values, signs, gradients: exact
DMID_TOL = 1e-2       # additivity of one fp32 weight gradient of the pair backward
#                       in its two cotangents (check_pair_cotangent_fp32)
SLEEP_CYCLES = 200_000_000  # about 0.1 s of the card's clock (_timed)
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16
PEAK_FP32_OPS = 67e12      # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
SORT_MAIN = (B_MAIN, 196, 384)   # one WassKD layer: patch tokens x teacher width
HEAD_DIM = 64
M_MAIN = B_MAIN * N_TOK          # token rows of one batch: 50688
# (batch * heads) of the main path's attention calls, and the MLP widths
ATTN_MAIN = {"teacher": B_MAIN * 6, "student": B_MAIN * 3}
MLP_MAIN = {"teacher": 384, "student": 192}
MLP_WIDTHS = (192, 384, 768, 1024)   # the model zoo's (models/registry.py)
UNFUSED_STEPS = 8
# train steps per distillation type, in the order they run
PATHS = (("soft", 8), ("wasskd", 4), ("mgd", 2), ("vitkd", 2))
# the same with the student on block pairs; between them the three types ask
# every (feat1, feat2) variant of a pair
PAIRED_PATHS = (("soft", 8), ("wasskd", 2), ("vitkd", 2))
PAIR_FLAGS = ((False, False), (True, False), (False, True), (True, True))
# the train-time data path (phase 9): (name, TrainConfig values, source px) at
# B_MAIN, 224 px, cifar-100; from 32 px the RA/AA geometric ops run as a dense
# warp at the source, from 256 px as a gather warp at the output
RA_SPEC, AA_SPEC = "rand-m9-mstd0.5-inc1", "original-mstd0.5"
AUG_VARIANTS = tuple(
    (f"{name} {'bf16' if bf16 else 'fp32'} {px}px", dict(kw, aug_pixel_bf16=bf16), px)
    for name, kw in (("RA", dict(aa=RA_SPEC)), ("AA", dict(aa=AA_SPEC)))
    for bf16 in (False, True) for px in (32, 256)) + (
    ("3-Augment bf16 32px", dict(ThreeAugment=True), 32),
    ("src RA bf16 32px", dict(src=True), 32),
    ("colour jitter bf16 32px", dict(aa="", color_jitter=0.3), 32),
    ("aa='' bf16 32px", dict(aa="", color_jitter=0.0), 32),
    ("aa='' bf16 256px", dict(aa="", color_jitter=0.0), 256))
CIFAR100_STD = (0.2675, 0.2565, 0.2761)
GREY_LEVEL = 1.0 / (255.0 * min(CIFAR100_STD))   # one grey level after normalisation
RECIPE_STEPS = 8
# the kernels that the fused block's wrappers launch (gemm_sm90.cuh,
# attention_{fwd,bwd}.cuh, fused_block_{common,reverse}.cuh)
BLOCK_KERNELS = ("linear_kernel", "weight_grad_kernel", "attention_fwd_kernel",
                 "attention_bwd_kernel", "attn_delta_kernel", "ln_fwd_kernel",
                 "ln_bwd_kernel", "gfeat_kernel", "reduce_chunks_kernel",
                 "reduce_partials_kernel", "transpose_kernel", "colsum_kernel")


def _timed(fn, iters, warmup=3):
    """Median ms of ``iters`` calls, each between its own pair of CUDA events,
    after ``warmup`` calls. The calls are queued behind a 0.1 s sleep on the
    card, so that the host's launch work runs ahead of the card and the events
    bracket the card's work, not the host's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for e0, e1 in events:
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    times = sorted(e0.elapsed_time(e1) for e0, e1 in events)
    return times[len(times) // 2]


def _host_ms(fn, iters):
    """Median ms of ``iters`` calls of ``fn`` on the host's clock, each to the
    end of its work on the card (synchronised): the time a caller waits."""
    import torch

    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def _ptxas_summary(log):
    """(kernel, registers, spills or '') per entry function of an nvcc -Xptxas
    -v log, the kernel's name demangled as far as c++filt goes."""
    out, kernel, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel, spill = line.split("'")[1], ""
        elif "bytes spill stores" in line:
            counts = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            spill = line.strip() if any(counts) else ""
        elif "Used" in line and "registers" in line and kernel:
            out.append((kernel, line.split(":", 1)[1].strip(), spill))
            kernel = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(k for k, _, _ in out),
                               capture_output=True, text=True, check=True).stdout.splitlines()
        out = [(n.replace("(anonymous namespace)::", "").split("(")[0], r, sp)
               for n, (_, r, sp) in zip(names, out)]
    except (OSError, subprocess.CalledProcessError):
        pass
    return out


def profile_calls(label, fn, calls=5):
    """Device time of each kernel inside one call of ``fn`` (one entry point
    that launches a chain of kernels), from torch.profiler over ``calls``
    calls (per-call means); prints the kernels by time and their sum, or says
    that the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / calls / 1e3, e.count / calls, e.key))
    if not rows:
        print(f"[profile] {label}: torch.profiler saw no device time (not measured)")
        return
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    for ms, n, key in rows:
        print(f"[profile] {label}: {ms:.4f} ms ({100 * ms / total:.1f}%) in {n:g} launches of "
              f"{key[:90]}")
    print(f"[profile] {label}: {total:.4f} ms of kernels a call")


# The parts of an unfused train step (profile_parts): the first whose test
# takes a kernel gets its time. A test sees the kernel's name and the chain of
# PyTorch ops that launched it, innermost first, as (name, input shapes).
_MATMULS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul", "aten::linear",
            "MmBackward0", "AddmmBackward0", "BmmBackward0", "LinearBackward0")


def _names(chain):
    return [name for name, _ in chain]


def _has_dim(chain, n):
    return any(n in shape for _, shapes in chain for shape in shapes if isinstance(shape, list))


def _token_products(chain):
    return any(n in _MATMULS for n in _names(chain)) and _has_dim(chain, M_MAIN)


UNFUSED_PARTS = (
    ("the port's kernels (flash_fwd, flash_bwd, fused_mlp_fwd)",
     lambda kernel, chain: any(k in kernel for k in ("attention_fwd_kernel",
                                                     "attention_bwd_kernel",
                                                     "mlp_fwd_kernel"))),
    # flash_bwd's dq, dk, dv reach the packed qkv through select's backward
    # (a zero [B, N, 3, H, 64] tensor and a copy into it, each) and two adds
    ("the copies that assemble the qkv gradient",
     lambda kernel, chain: any("select_backward" in n or n == "SelectBackward0"
                               for n in _names(chain))
     or any(n.startswith("aten::add") and shapes and isinstance(shapes[0], list)
            and len(shapes[0]) == 5 and shapes[0][2] == 3 for n, shapes in chain)),
    ("the LayerNorms", lambda kernel, chain: any("layer_norm" in n for n in _names(chain))),
    # the student's fc1, fc2 (hidden 4 x 192 = 768 columns) and GELU
    ("the student's MLP (fc1, GELU, fc2)",
     lambda kernel, chain: any("gelu" in n.lower() for n in _names(chain))
     or (_token_products(chain) and _has_dim(chain, 4 * 192))),
    ("the qkv and proj products", lambda kernel, chain: _token_products(chain)),
    # x + y, y * s (drop path) on [B, N, D] tokens, and the gradient sums
    # where the residual stream branches
    ("the residual adds and drop-path scales",
     lambda kernel, chain: any(n.split("::")[-1] in ("add", "add_", "mul", "mul_")
                               and shapes and isinstance(shapes[0], list)
                               and shapes[0][:2] == [B_MAIN, N_TOK] for n, shapes in chain)),
    ("the casts (.to, .float)",
     lambda kernel, chain: any(n in ("aten::to", "aten::_to_copy", "ToCopyBackward0")
                               for n in _names(chain))),
)


# The parts of a fused train step (profile_parts): the block kernels by name,
# then the ranges that build_train_step names around its transform and mixup
STEP_PARTS = (
    ("the fused-block kernels", lambda kernel, chain: any(k in kernel for k in BLOCK_KERNELS)),
    ("the train transform", lambda kernel, chain: "train_transform" in _names(chain)),
    ("mixup", lambda kernel, chain: "mixup" in _names(chain)),
)


def profile_parts(label, fn, parts):
    """Device time of one call of ``fn`` (a train step) by part: torch.profiler
    with the CPU ops and their input shapes, each kernel given to the first
    part whose test takes it, what no test takes printed as the rest (kernels
    launched under no PyTorch op included). Prints only; gates nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        # a record_function range (the step names its transform and mixup) also
        # shows as a device interval over its kernels: it is no kernel
        ranges = {e.name for e in events if getattr(e, "is_user_annotation", False)}
        total = sum(e.time_range.end - e.time_range.start for e in events
                    if e.device_type == DeviceType.CUDA and e.name not in ranges)
        sums = {name: 0.0 for name, _ in parts}
        for e in events:
            if e.device_type != DeviceType.CPU or not e.kernels:
                continue
            chain, node = [], e
            while node is not None:
                chain.append((node.name, node.input_shapes or []))
                node = node.cpu_parent
            for k in e.kernels:
                if k.name in ranges:
                    continue
                part = next((name for name, test in parts if test(k.name, chain)), None)
                if part is not None:
                    sums[part] += k.duration
        if total <= 0:
            print(f"[profile] {label}: torch.profiler saw no device time (not measured)")
            return
        # the first part is taken by kernel name alone: the port's kernels are
        # launched through ctypes, under an autograd node or under no op at all
        sums[parts[0][0]] = sum(e.time_range.end - e.time_range.start for e in events
                                if e.device_type == DeviceType.CUDA and e.name not in ranges
                                and parts[0][1](e.name, []))
        rest = total - sum(sums.values())
        for name, us in list(sums.items()) + [("the rest", rest)]:
            print(f"[profile] {label} by part: {us / 1e3:.4f} ms ({100 * us / total:.1f}%) "
                  f"{name}")
        print(f"[profile] {label} by part: {total / 1e3:.4f} ms of device time a step")
    except Exception as exc:   # a measurement only: report it with its traceback and go on
        import traceback

        traceback.print_exc()
        print(f"[profile] {label} by part: not measured ({type(exc).__name__}: {exc})")


def profile_backward(fb, x, p, g_out, kw):
    """Phase 3b': the kernels inside one fused_block_bwd call."""
    profile_calls(f"fused_block_bwd D={x.shape[-1]} B={x.shape[0]}",
                  lambda: fb.kernel_block_bwd(x, p, g_out, None, **kw))


def _err(a, b):
    a, b = a.float(), b.float()
    mx = b.abs().max().item()
    return (a - b).abs().max().item(), mx


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def _block_inputs(D, H, B, seed, device, n=N_TOK):
    """A block's weights (LayerNorm params off their ones/zeros init), bf16
    input and drop-path scales with some 0 and some 1/keep. The matmul weights
    have std 1/sqrt(fan-in), and q, k twice that so the softmax is peaked:
    each branch is then O(1) next to x ~ N(0, 1), and a fault in either one
    moves `out` by far more than the tolerance."""
    import torch

    from deltakd_tpu_torch.ops.fused_block import PARAM_NAMES

    g = torch.Generator().manual_seed(seed)
    F = 4 * D

    def r(*shape, sc):
        return torch.randn(*shape, generator=g) * sc

    wqkv = torch.cat([r(2 * D, D, sc=2 / math.sqrt(D)), r(D, D, sc=1 / math.sqrt(D))])
    ws = [1 + r(D, sc=.1), r(D, sc=.1), wqkv, r(3 * D, sc=.02),
          r(D, D, sc=1 / math.sqrt(D)), r(D, sc=.02), 1 + r(D, sc=.1), r(D, sc=.1),
          r(F, D, sc=1 / math.sqrt(D)), r(F, sc=.02), r(D, F, sc=1 / math.sqrt(F)),
          r(D, sc=.02)]
    params = {n: w.to(device) for n, w in zip(PARAM_NAMES, ws)}
    x = r(B, n, D, sc=1.0).to(device).bfloat16()
    keep = 0.9
    sa = (torch.rand(B, generator=g) < keep).float() / keep
    sm = (torch.rand(B, generator=g) < keep).float() / keep
    sa[0], sm[1], sa[2], sm[2] = 0.0, 0.0, 1 / keep, 1 / keep
    return params, x, sa.to(device), sm.to(device)


def _hold(worst, tag, kernel, D, x, checks):
    """Fails unless each (name, kernel output, plain output) agrees within
    TOL of the plain output's largest value; `out` is compared as out - x, so
    that the residual does not hide the branches. Keeps the largest abs error
    per (kernel, D) in `worst`."""
    for name, a, b in checks:
        if name == "out":
            a, b = a.float() - x.float(), b.float() - x.float()
        abs_err, mx = _err(a, b)
        ok = abs_err <= TOL * mx
        what = "out - x" if name == "out" else name
        print(f"[kernel] {kernel} D={D} {tag} {what}: max_abs_err {abs_err:.3e} "
              f"max_rel_err {abs_err / mx:.3e} (tol {TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kernel} D={D} {tag} {what} disagrees with its "
                                 f"plain version")
        worst[(kernel, D)] = max(worst.get((kernel, D), 0.0), abs_err)


def check_kernels(fb, worst):
    """Phase 3a: kernel vs plain version at B=8, every width and option."""
    import torch

    for D, H in ((192, 3), (384, 6)):
        for need_feat in (False, True):
            p, x, sa, sm = _block_inputs(D, H, B_CHECK, D + need_feat, "cuda")
            kw = dict(num_heads=H, scale_attn=sa, scale_mlp=sm)
            out, feat = fb.kernel_block_fwd(x, p, need_features=need_feat, **kw)
            r_out, r_feat = fb.reference_vit_block(x, p, **kw)
            g = torch.Generator(device="cuda").manual_seed(D)
            g_out = torch.randn(x.shape, generator=g, device="cuda").bfloat16()
            g_feat = (torch.randn(x.shape, generator=g, device="cuda").bfloat16()
                      if need_feat else None)
            dx, dws = fb.kernel_block_bwd(x, p, g_out, g_feat, **kw)
            r_dx, r_dws = fb.reference_vit_block_bwd(x, p, g_out, g_feat, **kw)
            torch.cuda.synchronize()
            tag = f"B={B_CHECK} feat={need_feat}"
            _hold(worst, tag, "fused_block_fwd", D, x, [("out", out, r_out)] + (
                [("feat", feat, r_feat)] if need_feat else []))
            _hold(worst, tag, "fused_block_bwd", D, x, [("dx", dx, r_dx)] + [
                ("d" + n, dws[n], r_dws[n]) for n in fb.PARAM_NAMES])


def check_block_forward_shapes(fb, worst):
    """Phase 3a': the block forward against its plain version at B=8 for every
    sequence length N in (50, 198, 578) (ragged against the 64-row query
    tiles, 64-key chunks and 128-row GEMM tiles; 578 is the 384-px finetune),
    width (192, 384, 768) and feature option, with drop-path scales that hold
    zeros; two runs the same bits."""
    import torch

    for n in (50, N_TOK, 578):
        for D, H in ((192, 3), (384, 6), (768, 12)):
            for need_feat in (False, True):
                p, x, sa, sm = _block_inputs(D, H, B_CHECK, D + n + need_feat, "cuda", n=n)
                kw = dict(num_heads=H, scale_attn=sa, scale_mlp=sm)
                out, feat = fb.kernel_block_fwd(x, p, need_features=need_feat, **kw)
                again = fb.kernel_block_fwd(x, p, need_features=need_feat, **kw)
                r_out, r_feat = fb.reference_vit_block(x, p, **kw)
                torch.cuda.synchronize()
                _hold(worst, f"B={B_CHECK} N={n} feat={need_feat}", "fused_block_fwd", D, x,
                      [("out", out, r_out)] + ([("feat", feat, r_feat)] if need_feat else []))
                if not (torch.equal(out, again[0])
                        and (not need_feat or torch.equal(feat, again[1]))):
                    raise AssertionError(f"fused_block_fwd D={D} N={n}: two runs gave "
                                         f"different bits")


def check_block_backward_shapes(fb, worst):
    """Phase 3c: the block backward against its plain version at B=8 for
    every N in (50, 198, 578) (ragged against the attention backward's 64-row
    tiles and the weight gradients' 64-row k-blocks), width (192, 384, 768),
    with and without a feature cotangent; the pair backward (and its forward)
    at D=192 and 384 for the same N, with no feature cotangent and with both;
    drop-path scales that hold zeros; two runs the same bits."""
    import torch

    for n in (50, N_TOK, 578):
        for D, H in ((192, 3), (384, 6), (768, 12)):
            for need_feat in (False, True):
                p, x, sa, sm = _block_inputs(D, H, B_CHECK, D + n + need_feat, "cuda", n=n)
                kw = dict(num_heads=H, scale_attn=sa, scale_mlp=sm)
                g = torch.Generator(device="cuda").manual_seed(D + n)
                g_out = torch.randn(x.shape, generator=g, device="cuda").bfloat16()
                g_feat = (torch.randn(x.shape, generator=g, device="cuda").bfloat16()
                          if need_feat else None)
                dx, dws = fb.kernel_block_bwd(x, p, g_out, g_feat, **kw)
                dx2, dws2 = fb.kernel_block_bwd(x, p, g_out, g_feat, **kw)
                r_dx, r_dws = fb.reference_vit_block_bwd(x, p, g_out, g_feat, **kw)
                torch.cuda.synchronize()
                _hold(worst, f"B={B_CHECK} N={n} feat={need_feat}", "fused_block_bwd", D, x,
                      [("dx", dx, r_dx)] + [("d" + k, dws[k], r_dws[k]) for k in fb.PARAM_NAMES])
                if not (torch.equal(dx, dx2) and all(torch.equal(dws[k], dws2[k])
                                                     for k in fb.PARAM_NAMES)):
                    raise AssertionError(f"fused_block_bwd D={D} N={n}: two runs gave "
                                         f"different bits")
        for D, H in ((192, 3), (384, 6)):
            for nf in (False, True):
                _hold_pair(fb, worst, D, H, B_CHECK, nf, nf, D + n + nf, repeat=True, n=n)


# The backward's products per nn.Linear weight W [O, I] of the block:
# (name, O / D, I / D). Its input gradient dX [M, I] = G W runs on
# linear_sm90 against W^T (kernel_linear(G, W.t())), its weight gradient
# dW [O, I] = G^T X on weight_grad_kernel (kernel_weight_grad(G, X)).
BACKWARD_PRODUCTS = (("fc2", 1, 4), ("fc1", 4, 1), ("proj", 1, 1), ("qkv", 3, 1))
# What reverse_chain writes of each input gradient: dhpre (bf16, times gelu';
# its column sums, which the sweep also takes from this epilogue, are held
# through the block backward's fc1 bias gradient), dz, dO for the attention
# backward, dy.
DGRAD_OUTPUTS = {"fc2": ("bf16",), "fc1": ("f32",), "proj": ("bf16",), "qkv": ("f32",)}


def check_backward_gemms(fb, worst, timed=True):
    """Phase 3d: the backward's GEMM products alone at D=192 and D=384: each
    input gradient (fb.kernel_linear on W^T, fc2's with the GELU derivative
    as `mul`) against fb.plain_linear, each weight gradient
    (fb.kernel_weight_grad) against fb.plain_weight_grad; at M=1001 (ragged
    against the 128-row tile and the 64-row k-blocks) and M=50688 (the main
    path); within TOL, two runs the same bits. With ``timed``, each at
    M=50688 beside one torch.matmul of the same product (cuBLAS, bf16 out).
    Returns {(kind, name, D): (ms, cuBLAS ms)}."""
    import torch

    rows = {}
    for D in (192, 384):
        for name, o_mult, i_mult in BACKWARD_PRODUCTS:
            O, I = o_mult * D, i_mult * D
            for M in (1001, M_MAIN):
                g = torch.Generator().manual_seed(D + M + O)
                G = torch.randn(M, O, generator=g).cuda().bfloat16()
                X = torch.randn(M, I, generator=g).cuda().bfloat16()
                W = (torch.randn(O, I, generator=g) / math.sqrt(O)).cuda().bfloat16()
                mul = (1.2 * torch.rand(M, I, generator=g) - 0.1).cuda() if name == "fc2" else None
                Wt = W.t().contiguous()
                outs = DGRAD_OUTPUTS[name]
                got = fb.kernel_linear(G, Wt, mul=mul, outputs=outs)
                again = fb.kernel_linear(G, Wt, mul=mul, outputs=outs)
                ref = fb.plain_linear(G, Wt, mul=mul)
                dw, dw2 = fb.kernel_weight_grad(G, X), fb.kernel_weight_grad(G, X)
                r_dw = fb.plain_weight_grad(G, X)
                torch.cuda.synchronize()
                checks = [(tag, g_, r_, None) for tag, g_, r_ in zip(("out32", "out_bf16"), got, ref)
                          if g_ is not None]
                same = all(torch.equal(g_, a_) for g_, a_ in zip(got, again) if g_ is not None)
                _hold_all(worst, "linear_sm90", f"dgrad {name} D={D} M={M}", checks, same)
                _hold_all(worst, "weight_grad_sm90", f"{name} D={D} M={M}", [("dW", dw, r_dw, None)],
                          torch.equal(dw, dw2))
            if not timed:
                continue
            flops = 2 * M * O * I
            for kind, ours, lib, shape in (
                    ("dgrad", lambda: fb.kernel_linear(G, Wt, mul=mul, outputs=outs),
                     lambda: torch.matmul(G, W), f"[{M}x{O}]x[{O}x{I}]"),
                    ("wgrad", lambda: fb.kernel_weight_grad(G, X),
                     lambda: torch.matmul(G.t(), X), f"[{O}x{M}]x[{M}x{I}]")):
                ms, lib_ms = _timed(ours, 20), _timed(lib, 20)
                rows[(kind, name, D)] = (ms, lib_ms)
                what = (f"writing {'+'.join(outs)}{' (x gelu)' if mul is not None else ''}"
                        if kind == "dgrad" else "fp32, partials summed")
                print(f"[gemm] {kind} {name} D={D} {shape} {what}: {ms:.4f} ms "
                      f"{flops / ms / 1e9:.1f} TFLOP/s; cuBLAS (torch.matmul, bf16 out) "
                      f"{lib_ms:.4f} ms {flops / lib_ms / 1e9:.1f} TFLOP/s")
    return rows


# Workspace bytes of the two backward kernels at [256, 198, 192] in the
# design whose recompute kept the [B*H, N, N] scores and whose sweep carved
# two more [B*H, N, N] buffers.
BWD_WORKSPACE_BEFORE = {"fused_block_bwd": 1_744_579_584, "fused_pair_bwd": 2_588_027_904}


def print_backward_workspace(fb):
    """The backward's and the pair backward's workspace at the main path's
    shape beside BWD_WORKSPACE_BEFORE: fails unless each is below it and is
    exactly the per-token buffers of the chain (a stash per block, the
    sweep's buffers, the four transposed weights, the widest weight
    gradient's row-range partials, the column-sum partials), that is, unless
    no [B*H, N, N] buffer and no fp32 copy kept only for a column sum is
    carved."""
    D, H, N, B = 192, 3, N_TOK, B_MAIN
    F, M, BH = 4 * D, B * N, B * H

    def r256(n):
        return (n + 255) // 256 * 256

    lib = fb._library("fused_block_bwd")
    partial = max(lib.dk_weight_grad_sm90_workspace(M, o * D, i * D)
                  for _, o, i in BACKWARD_PRODUCTS)
    stash = [M * D * 2, M * 3 * D * 2, M * D * 2, M * D * 4, M * D * 2, M * F * 2, BH * N * 4,
             M * D * 4, M * 4, M * D * 4, M * 4, M * F * 4]
    transposed = [3 * D * D * 2, D * D * 2, F * D * 2, D * F * 2]
    # the column-sum partials: three sums over 128-row chunks, the fc2 input
    # gradient's per 128-row tile, or the attention backward's per element
    tiles = (M + 127) // 128
    col_partial = max(3 * tiles * D, tiles * F, 3 * B * D) * 4
    sweep = [M * D * 2, M * F * 2, M * D * 4, M * D * 4, M * D * 2, M * D * 2, BH * N * 4,
             M * 3 * D * 2, M * D * 4, *transposed, partial, col_partial]
    reckoned = {"fused_block_bwd": stash + sweep,
                "fused_pair_bwd": stash + stash + [M * D * 4, M * D * 4] + sweep}
    for name, before in BWD_WORKSPACE_BEFORE.items():
        now = fb.workspace_bytes(name, (B, N, D), H, F)
        parts = sum(r256(n) for n in reckoned[name])
        print(f"[workspace] {name} [{B},{N},{D}]: {now} bytes, before {before}, {before - now} "
              f"less; of it the delta rows {r256(BH * N * 4)}, the transposed weights "
              f"{sum(r256(n) for n in transposed)}, the weight-gradient partials {r256(partial)}, "
              f"the column-sum partials {r256(col_partial)}")
        if now != parts or now >= before:
            raise AssertionError(f"{name}: the workspace is {now} bytes, not the {parts} of the "
                                 f"chain's per-token buffers, or not below {before}")


# The forward's four linear products: (name, N / D, K / D).
LINEAR_PRODUCTS = (("qkv", 3, 1), ("proj", 1, 1), ("fc1", 4, 1), ("fc2", 1, 4))


def _linear_inputs(name, D, M, seed):
    """One product's operands and the epilogue that forward_chain gives it:
    qkv scales its q columns by 64^-1/2, proj adds the drop-path-scaled bf16
    block input, fc1 applies GELU (and keeps its derivative), fc2 adds the
    fp32 x2; the scales hold zeros."""
    import torch

    mult = {n: (a, b) for n, a, b in LINEAR_PRODUCTS}[name]
    N, K = mult[0] * D, mult[1] * D
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(M, K, generator=g).cuda().bfloat16()
    w = (torch.randn(N, K, generator=g) / math.sqrt(K)).cuda().bfloat16()
    bias = (0.1 * torch.randn(N, generator=g)).cuda()
    kw = {}
    if name == "qkv":
        kw = dict(scale_cols=D, col_scale=HEAD_DIM ** -0.5)
    elif name == "fc1":
        kw = dict(gelu=True)
    else:
        rps = N_TOK if M % N_TOK == 0 else 7
        s = (torch.rand(M // rps, generator=g) < 0.9).float() / 0.9
        s[0] = 0.0
        res = torch.randn(M, N, generator=g).cuda()
        kw = dict(residual=res.bfloat16() if name == "proj" else res, res_scale=s.cuda(),
                  rows_per_sample=rps)
    return a, w, bias, kw


# What forward_chain writes of each product on the main path (no stash, no
# feature): qkv_lp, x2, the hidden, the block output.
LINEAR_MAIN_OUTPUTS = {"qkv": ("bf16",), "proj": ("f32",), "fc1": ("bf16",), "fc2": ("bf16",)}


def check_linear(fb, worst):
    """Phase 3a'': the forward's GEMM alone (fb.kernel_linear, gemm_sm90.cuh)
    against F.linear plus the same epilogue (fb.plain_linear) on the four
    product shapes at D=192 and D=384: at M=1001 (ragged against the 128-row
    tile) with every output (fp32, bf16, the pre-residual bf16, GELU's
    derivative), at M=50688 (the main path) with the outputs forward_chain
    writes there; each within TOL, two runs the same bits. At M=50688 it is
    timed beside one cuBLAS call (F.linear, bf16) of the same product.
    Returns {(name, D): (ms, cuBLAS ms)}."""
    import torch
    import torch.nn.functional as F

    rows = {}
    for D in (192, 384):
        for name, _, _ in LINEAR_PRODUCTS:
            for M in (1001, M_MAIN):
                a, w, bias, kw = _linear_inputs(name, D, M, D + M)
                if M == M_MAIN:
                    kw["outputs"] = LINEAR_MAIN_OUTPUTS[name]
                got = fb.kernel_linear(a, w, bias, **kw)
                again = fb.kernel_linear(a, w, bias, **kw)
                ref = fb.plain_linear(a, w, bias, **{k: v for k, v in kw.items()
                                                     if k != "outputs"})
                torch.cuda.synchronize()
                checks = [(tag, g_, r_, None) for tag, g_, r_ in
                          zip(("out32", "out_bf16", "pre", "gelu'"), got, ref) if g_ is not None]
                same = all(torch.equal(g_, a_) for g_, a_ in zip(got, again) if g_ is not None)
                _hold_all(worst, "linear_sm90", f"{name} D={D} M={M}", checks, same)
            N, K = w.shape
            flops = 2 * M * N * K
            ms = _timed(lambda: fb.kernel_linear(a, w, bias, **kw), 20)
            b_lp = bias.bfloat16()
            lib = _timed(lambda: F.linear(a, w, b_lp), 20)
            rows[(name, D)] = (ms, lib)
            print(f"[gemm] {name} D={D} [{M}x{K}]x[{K}x{N}] writing "
                  f"{'+'.join(kw['outputs'])}: {ms:.4f} ms {flops / ms / 1e9:.1f} TFLOP/s; "
                  f"cuBLAS (F.linear, bf16 out) {lib:.4f} ms {flops / lib / 1e9:.1f} TFLOP/s")
    return rows


def print_forward_workspace(fb):
    """The block forward's workspace at the main path's shapes beside what it
    took while it materialised the scores (the same plus the fp32 scores,
    their bf16 copy and the row sums, [B*H, N, N] each): fails unless it is
    exactly the six activations of the no-stash chain (y, qkv, merged, x2, z,
    hidden), that is, unless the scores are gone."""
    def r256(n):
        return (n + 255) // 256 * 256

    for D, H in ((384, 6), (192, 3)):
        now = fb.workspace_bytes("fused_block_fwd", (B_MAIN, N_TOK, D), H, 4 * D)
        M, bh, nn = B_MAIN * N_TOK, B_MAIN * H, N_TOK * N_TOK
        scores = sum(r256(n) for n in (bh * nn * 4, bh * nn * 2, bh * N_TOK * 4))
        chain = sum(r256(M * D * k) for k in (2, 3 * 2, 2, 4, 2, 4 * 2))
        print(f"[workspace] fused_block_fwd [{B_MAIN},{N_TOK},{D}]: {now} bytes; with the "
              f"materialised scores {now + scores}; {scores} less")
        if now != chain:
            raise AssertionError(f"fused_block_fwd D={D}: the workspace is {now} bytes, not "
                                 f"the {chain} of the chain's activations alone")


def _library_block(x, w, H, eps, sa, sm):
    """The same block from PyTorch library calls (cuBLAS linear + SDPA):
    a yardstick only; the port never calls it."""
    import torch.nn.functional as F

    B, N, D = x.shape
    (g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bf1, w2, bf2) = w
    y = F.layer_norm(x, (D,), g1, b1, eps)
    q, k, v = F.linear(y, wqkv, bqkv).view(B, N, 3, H, D // H).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B, N, D)
    x2 = x + sa.view(-1, 1, 1).to(x.dtype) * F.linear(o, wproj, bproj)
    h = F.gelu(F.linear(F.layer_norm(x2, (D,), g2, b2, eps), w1, bf1))
    return x2 + sm.view(-1, 1, 1).to(x.dtype) * F.linear(h, w2, bf2)


def time_kernels(fb, worst):
    """Phase 3b: at the main-path shapes (B=256, N=198), each kernel held
    against its plain version, then the kernel, plain and library times, with
    the bound from this run's shapes."""
    import torch

    rows = {}
    for kernel, D, H in (("fused_block_fwd", 384, 6), ("fused_block_fwd", 192, 3),
                         ("fused_block_bwd", 192, 3)):
        p, x, sa, sm = _block_inputs(D, H, B_MAIN, 7, "cuda")
        kw = dict(num_heads=H, scale_attn=sa, scale_mlp=sm)
        g_out = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(D),
                            device="cuda", dtype=x.dtype)
        if kernel == "fused_block_fwd":
            out, feat = fb.kernel_block_fwd(x, p, need_features=True, **kw)
            again = fb.kernel_block_fwd(x, p, need_features=True, **kw)
            r_out, r_feat = fb.reference_vit_block(x, p, **kw)
            checks = [("out", out, r_out), ("feat", feat, r_feat)]
            same_bits = torch.equal(out, again[0]) and torch.equal(feat, again[1])
        else:
            dx, dws = fb.kernel_block_bwd(x, p, g_out, None, **kw)
            dx2, dws2 = fb.kernel_block_bwd(x, p, g_out, None, **kw)
            r_dx, r_dws = fb.reference_vit_block_bwd(x, p, g_out, None, **kw)
            checks = [("dx", dx, r_dx)] + [("d" + n, dws[n], r_dws[n])
                                           for n in fb.PARAM_NAMES]
            same_bits = torch.equal(dx, dx2) and all(torch.equal(dws[n], dws2[n])
                                                     for n in fb.PARAM_NAMES)
        torch.cuda.synchronize()
        _hold(worst, f"B={B_MAIN}", kernel, D, x, checks)
        if not same_bits:
            raise AssertionError(f"{kernel} D={D} B={B_MAIN}: two runs gave different bits")
        lib_w = [t.detach().bfloat16().requires_grad_(kernel == "fused_block_bwd")
                 for t in fb.block_params(p)]
        x_lib = x.detach().requires_grad_(kernel == "fused_block_bwd")

        def lib_fwd():
            with torch.no_grad():
                _library_block(x_lib, lib_w, H, 1e-6, sa, sm)

        extra = ""
        if kernel == "fused_block_fwd":
            ms = _timed(lambda: fb.kernel_block_fwd(x, p, need_features=False, **kw), 10)
            plain_ms = _timed(lambda: fb.reference_vit_block(x, p, **kw), 3)
            library_ms = _timed(lib_fwd, 20)
        else:
            ms = _timed(lambda: fb.kernel_block_bwd(x, p, g_out, None, **kw), 10)
            plain_ms = _timed(lambda: fb.reference_vit_block_bwd(x, p, g_out, None, **kw), 3)

            def lib_fwd_graph():    # the forward as the backward's run makes it
                _library_block(x_lib, lib_w, H, 1e-6, sa, sm)

            def lib_fwd_bwd():
                _library_block(x_lib, lib_w, H, 1e-6, sa, sm).backward(g_out)

            both, fwd = _timed(lib_fwd_bwd, 20), _timed(lib_fwd_graph, 20)
            library_ms = both - fwd
            extra = f" (library forward+backward {both:.3f} ms, forward {fwd:.3f} ms)"
            profile_backward(fb, x, p, g_out, kw)
        B, N = B_MAIN, N_TOK
        flops = B * (24 * N * D * D + 4 * N * N * D)
        weight_bytes = 12 * D * D * 2
        nbytes = 2 * B * N * D * 2 + weight_bytes
        if kernel == "fused_block_bwd":
            # two products per forward product, and the recompute, which stops
            # at the GELU: a forward less its fc2
            flops = 3 * flops - 2 * B * N * D * 4 * D
            nbytes = 3 * B * N * D * 2 + weight_bytes + 12 * D * D * 4
        rows[(kernel, D)] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                 **_bound(flops, nbytes))
        print(f"[time] {kernel} D={D} B={B}: {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"library {library_ms:.3f} ms, bound {rows[(kernel, D)]['bound_ms']:.4f} ms "
              f"({rows[(kernel, D)]['bound_by']}){extra}")
    return rows


def _pair_inputs(D, H, B, seed, device, n=N_TOK):
    """Two blocks' weights, x of n tokens and the four drop-path scales
    (s_attn1, s_mlp1, s_attn2, s_mlp2): _block_inputs twice, block 2's scales
    rolled so its zeros fall on other samples, and sample 5 with all four at
    0."""
    import torch

    p1, x, sa1, sm1 = _block_inputs(D, H, B, seed, device, n=n)
    p2, _, sa2, sm2 = _block_inputs(D, H, B, seed + 1000, device, n=n)
    scales = [sa1, sm1, sa2.roll(3), sm2.roll(3)]
    for s in scales:
        s[5] = 0.0
    g = torch.Generator(device=device).manual_seed(seed)
    gs = [torch.randn(x.shape, generator=g, device=device).bfloat16() for _ in range(3)]
    return p1, p2, x, tuple(scales), gs


def _hold_pair(fb, worst, D, H, B, nf1, nf2, seed, repeat=False, n=N_TOK):
    """Both pair kernels against their plain versions on one input of n
    tokens; with ``repeat`` a second run must give the same bits. Returns what
    the caller may compare further: (inputs, kernel forward outputs, kernel
    dx)."""
    import torch

    p1, p2, x, scales, (g_out, g_f1, g_f2) = inputs = _pair_inputs(D, H, B, seed, "cuda", n=n)
    g_f1, g_f2 = (g_f1 if nf1 else None), (g_f2 if nf2 else None)
    kw = dict(num_heads=H, scales=scales)
    fwd = fb.kernel_block_pair_fwd(x, p1, p2, need_features1=nf1, need_features2=nf2, **kw)
    r_fwd = fb.reference_vit_block_pair(x, p1, p2, **kw)
    dx, dw1, dw2 = bwd = fb.kernel_block_pair_bwd(x, p1, p2, g_out, g_f1, g_f2, **kw)
    r_dx, r_dw1, r_dw2 = fb.reference_vit_block_pair_bwd(x, p1, p2, g_out, g_f1, g_f2, **kw)
    torch.cuda.synchronize()
    tag = f"B={B}{'' if n == N_TOK else f' N={n}'} feat=({nf1}, {nf2})"
    for flag, feat in ((nf1, fwd[1]), (nf2, fwd[2])):
        if (feat is not None) != flag:
            raise AssertionError(f"fused_pair_fwd D={D} {tag}: a feature output does "
                                 f"not follow its flag")
    if not torch.equal(fwd[0][5], x[5]):
        raise AssertionError(f"fused_pair_fwd D={D} {tag}: all four scales 0 did not "
                             f"return x")
    _hold(worst, tag, "fused_pair_fwd", D, x, [("out", fwd[0], r_fwd[0])] + [
        (name, fwd[i], r_fwd[i]) for i, name in ((1, "feat1"), (2, "feat2"))
        if fwd[i] is not None])
    _hold(worst, tag, "fused_pair_bwd", D, x, [("dx", dx, r_dx)] + [
        (f"d{n}[{blk}]", dw[n], r_dw[n]) for blk, dw, r_dw in ((1, dw1, r_dw1), (2, dw2, r_dw2))
        for n in fb.PARAM_NAMES])
    if repeat:
        fwd2 = fb.kernel_block_pair_fwd(x, p1, p2, need_features1=nf1, need_features2=nf2,
                                        **kw)
        dx2, dw1b, dw2b = fb.kernel_block_pair_bwd(x, p1, p2, g_out, g_f1, g_f2, **kw)
        torch.cuda.synchronize()
        same = (all(torch.equal(a, b) for a, b in zip(fwd, fwd2) if a is not None)
                and torch.equal(dx, dx2)
                and all(torch.equal(a[n], b[n]) for a, b in ((dw1, dw1b), (dw2, dw2b))
                        for n in fb.PARAM_NAMES))
        if not same:
            raise AssertionError(f"pair kernels D={D} {tag}: two runs gave different bits")
    return inputs, fwd, bwd


def check_pair_kernels(fb, worst):
    """Phase 8a: the pair kernels vs their plain versions at B=8 for both
    widths and the four feature variants, then at the main-path shape with
    no feature and with both features, the latter twice; and, printed, the
    pair against the two single kernels chained, which round the activation
    between the blocks to bf16."""
    import torch

    for D, H in ((192, 3), (384, 6)):
        for nf1, nf2 in PAIR_FLAGS:
            _hold_pair(fb, worst, D, H, B_CHECK, nf1, nf2, D + 2 * nf1 + nf2)
    D, H = 192, 3
    _hold_pair(fb, worst, D, H, B_MAIN, False, False, 12)   # what the soft step launches
    (p1, p2, x, scales, (g_out, g_f1, g_f2)), fwd, (dx, dw1, _) = _hold_pair(
        fb, worst, D, H, B_MAIN, True, True, 11, repeat=True)
    kw1 = dict(num_heads=H, scale_attn=scales[0], scale_mlp=scales[1])
    kw2 = dict(num_heads=H, scale_attn=scales[2], scale_mlp=scales[3])
    mid, f1 = fb.kernel_block_fwd(x, p1, need_features=True, **kw1)
    out, f2 = fb.kernel_block_fwd(mid, p2, need_features=True, **kw2)
    dmid, _ = fb.kernel_block_bwd(mid, p2, g_out, g_f2, **kw2)
    s_dx, s_dw1 = fb.kernel_block_bwd(x, p1, dmid, g_f1, **kw1)
    torch.cuda.synchronize()
    for name, a, b in (("out - x", fwd[0].float() - x.float(), out.float() - x.float()),
                       ("feat2", fwd[2], f2), ("dx", dx, s_dx),
                       ("dmlp.fc1.weight[1]", dw1["mlp.fc1.weight"], s_dw1["mlp.fc1.weight"])):
        abs_err, mx = _err(a, b)
        print(f"[pair vs two single kernels] {name}: max_abs_diff {abs_err:.3e}, max |single| "
              f"{mx:.3e} (rel {abs_err / mx:.3e}; the singles round mid to bf16)")
        if abs_err > TOL * mx:
            raise AssertionError(f"pair kernels and two single kernels differ in {name}")
        if abs_err == 0.0:
            raise AssertionError(f"the pair's {name} has the bits of two single kernels: "
                                 f"the activation between its blocks was rounded to bf16")
    if not torch.equal(fwd[1], f1):
        raise AssertionError("feat1 of the pair and of the first single block differ: "
                             "both come from the same chain on the same input")


def check_pair_cotangent_fp32(fb):
    """Phase 8a': the cotangent between the two reverse sweeps keeps its low
    bits. Against the plain version a bf16 `dmid` hides under TOL, so this
    check needs none: with block 2's four scales at 0, dmid = g_out + J(g_feat2)
    where J does not depend on g_out, and block 1's fc2-bias gradient is the
    fp32 column sum of dmid. So that gradient is additive in (g_out, g_feat2)
    up to fp32 summation error, as long as a g_feat2 of 2^-10 the size of
    g_out survives beside g_out in dmid; rounded to bf16 it would not."""
    import torch

    D, H = 192, 3
    p1, p2, x, _, (g_out, _, g_f2) = _pair_inputs(D, H, B_CHECK, 17, "cuda")
    one, zero = torch.ones(B_CHECK, device="cuda"), torch.zeros(B_CHECK, device="cuda")
    small = (g_f2.float() * 2.0 ** -10).bfloat16()
    nothing = torch.zeros_like(g_out)

    def dbias(g, gf2):
        _, dw1, _ = fb.kernel_block_pair_bwd(x, p1, p2, g, None, gf2, num_heads=H,
                                             scales=(one, one, zero, zero))
        return dw1["mlp.fc2.bias"].double()

    both, only_out, only_feat = dbias(g_out, small), dbias(g_out, nothing), dbias(nothing, small)
    torch.cuda.synchronize()
    err = ((both - only_out) - only_feat).abs().max().item()
    mx = only_feat.abs().max().item()
    print(f"[pair dmid fp32] dmlp.fc2.bias[1] with (g_out, g_feat2) less that with g_out alone, "
          f"against that with g_feat2 alone: max_abs_diff {err:.3e}, max {mx:.3e} "
          f"(rel {err / mx:.3e}, limit {DMID_TOL})")
    if not (mx > 0.0 and err <= DMID_TOL * mx):
        raise AssertionError("fused_pair_bwd: a small cotangent did not survive beside g_out "
                             "between the two sweeps: dmid was rounded")


def time_pair_kernels(fb):
    """Phase 8b: the pair kernels at [256, 198, 192]: kernel, plain and
    library times (two library blocks chained; the backward's is
    forward+backward minus forward) and the bound; beside them the two single
    kernels chained, timed in turns with the pair (pair, singles, singles,
    pair); forward+backward through autograd for the pair, the single-forward
    variant and two single blocks; and the backward's workspace."""
    import torch

    D, H, B, N = 192, 3, B_MAIN, N_TOK
    p1, p2, x, scales, (g_out, _, _) = _pair_inputs(D, H, B, 13, "cuda")
    kw = dict(num_heads=H, scales=scales)
    kw1 = dict(num_heads=H, scale_attn=scales[0], scale_mlp=scales[1])
    kw2 = dict(num_heads=H, scale_attn=scales[2], scale_mlp=scales[3])
    mid, _ = fb.kernel_block_fwd(x, p1, need_features=False, **kw1)

    def pair_fwd():
        fb.kernel_block_pair_fwd(x, p1, p2, need_features1=False, need_features2=False, **kw)

    def singles_fwd():
        m, _ = fb.kernel_block_fwd(x, p1, need_features=False, **kw1)
        fb.kernel_block_fwd(m, p2, need_features=False, **kw2)

    def pair_bwd():
        fb.kernel_block_pair_bwd(x, p1, p2, g_out, **kw)

    def singles_bwd():
        dmid, _ = fb.kernel_block_bwd(mid, p2, g_out, None, **kw2)
        fb.kernel_block_bwd(x, p1, dmid, None, **kw1)

    lib_w = [[t.detach().bfloat16().requires_grad_(True) for t in fb.block_params(p)]
             for p in (p1, p2)]
    x_lib = x.detach().requires_grad_(True)

    def lib_fwd():
        m = _library_block(x_lib, lib_w[0], H, 1e-6, scales[0], scales[1])
        return _library_block(m, lib_w[1], H, 1e-6, scales[2], scales[3])

    def lib_fwd_no_grad():
        with torch.no_grad():
            lib_fwd()

    flops1 = B * (24 * N * D * D + 4 * N * N * D)
    fc2 = 2 * B * N * D * 4 * D
    io, weights = B * N * D * 2, 2 * 12 * D * D
    rows = {}
    for kernel, pair, singles, plain in (
            ("fused_pair_fwd", pair_fwd, singles_fwd,
             lambda: fb.reference_vit_block_pair(x, p1, p2, **kw)),
            ("fused_pair_bwd", pair_bwd, singles_bwd,
             lambda: fb.reference_vit_block_pair_bwd(x, p1, p2, g_out, **kw))):
        turns = [_timed(fn, 10) for fn in (pair, singles, singles, pair)]
        ms, singles_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        plain_ms = _timed(plain, 3)
        if kernel == "fused_pair_fwd":
            library_ms, extra = _timed(lib_fwd_no_grad, 20), ""
            bound = _bound(2 * flops1, 2 * io + weights * 2)
        else:
            both = _timed(lambda: lib_fwd().backward(g_out), 20)
            fwd = _timed(lib_fwd, 20)
            library_ms = both - fwd
            extra = f" (library forward+backward {both:.3f} ms, forward {fwd:.3f} ms)"
            # per block the recompute up to the GELU (a forward less its fc2) and
            # two products per forward product, and block 1's fc2 for mid; x,
            # g_out, dx, the bf16 weights, the fp32 gradients
            bound = _bound(2 * (3 * flops1 - fc2) + fc2, 3 * io + weights * (2 + 4))
        rows[(kernel, D)] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bound)
        print(f"[time] {kernel} D={D} B={B}: {ms:.3f} ms (turns {turns[0]:.3f}, {turns[3]:.3f}), "
              f"two single kernels {singles_ms:.3f} ms (turns {turns[1]:.3f}, {turns[2]:.3f}), "
              f"pair/singles {ms / singles_ms:.4f}, plain {plain_ms:.3f} ms, library "
              f"{library_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}){extra}")

    # forward + backward through autograd: which half of the pair costs or saves
    leaves = [{n: t.detach().requires_grad_(True) for n, t in p.items()} for p in (p1, p2)]
    x_leaf = x.detach().requires_grad_(True)
    skw = dict(zip(("scale_attn1", "scale_mlp1", "scale_attn2", "scale_mlp2"), scales),
               num_heads=H, need_features1=False, need_features2=False)

    def through_pair(single_forward):
        def run():
            out, _, _ = fb.fused_vit_block_pair(x_leaf, *leaves, single_forward=single_forward,
                                                **skw)
            out.backward(g_out)
        return run

    def through_singles():
        m, _ = fb.fused_vit_block(x_leaf, leaves[0], need_features=False, **kw1)
        out, _ = fb.fused_vit_block(m, leaves[1], need_features=False, **kw2)
        out.backward(g_out)

    both = {"pair": through_pair(False), "single forwards + pair backward": through_pair(True),
            "two single blocks": through_singles}
    first = {k: _timed(fn, 6) for k, fn in both.items()}
    second = {k: _timed(fn, 6) for k, fn in reversed(both.items())}
    print("[time] forward+backward through autograd D=192 B=256: " + ", ".join(
        f"{k} {(first[k] + second[k]) / 2:.3f} ms ({first[k]:.3f}, {second[k]:.3f})"
        for k in both))
    F = 4 * D
    sizes = {name: fb.workspace_bytes(name, (B, N, D), H, F)
             for name in ("fused_pair_fwd", "fused_pair_bwd", "fused_block_fwd",
                          "fused_block_bwd")}
    print("[workspace] bytes at [256, 198, 192]: "
          + ", ".join(f"{k} {v}" for k, v in sizes.items()))
    return rows


def _sort_inputs(shape, dtype, seed):
    """s, t on the card with ties: a normal draw rounded to bf16 (many equal
    values in a column of 196), a few exact duplicate rows inside s, and a few
    positions where s equals t; in fp32 a quarter of the rows of s is left
    unrounded. From n = 4 on, row 2 of s is +0.0 and row 3 is -0.0: equal
    as floats, so the stable order keeps row 2 first, while their bit
    images order -0.0 first."""
    import torch

    g = torch.Generator().manual_seed(seed)
    s = torch.randn(shape, generator=g).bfloat16().to(dtype)
    t = torch.randn(shape, generator=g).bfloat16().to(dtype)
    n = shape[1]
    if dtype == torch.float32:     # and keys that need all 32 bits
        s[:, n // 4: n // 2] = torch.randn(s[:, n // 4: n // 2].shape, generator=g)
    s[:, 1] = s[:, 0]
    s[:, n - 1] = s[:, n // 2]
    if n >= 4:
        s[:, 2], s[:, 3] = 0.0, -0.0
    t[:, : max(1, n // 8)] = s[:, : max(1, n // 8)]
    return s.cuda(), t.cuda()


def _value_sort_input(shape, dtype, seed):
    """The value sort's input on the card: for a float dtype `_sort_inputs`'s
    s (ties, -0.0 after a tied +0.0) with +-inf and, from d = 2 on, a column
    of NaNs alone and NaNs scattered over a hundredth of the elements; for
    int32 a narrow draw (ties) with the int32 extremes, 0 and -1 planted."""
    import torch

    g = torch.Generator().manual_seed(seed)
    if dtype == torch.int32:
        x = torch.randint(-40, 40, shape, generator=g, dtype=torch.int32)
        specials = torch.tensor([-2**31, 2**31 - 1, 0, -1, 2**31 - 2], dtype=torch.int32)
    else:
        x = _sort_inputs(shape, torch.float32, seed)[0].cpu()
        if shape[2] >= 2:
            x[:, :, 1] = float("nan")
        specials = torch.tensor([float("inf"), -float("inf"), float("nan"), -0.0, 0.0])
    at = torch.randperm(x.numel(), generator=g)[: max(5, x.numel() // 100)]
    x.view(-1)[at] = specials[torch.arange(len(at)) % len(specials)]
    return x.to(dtype).cuda()


def _negative_zeros(x):
    """The count of -0.0 in each column of a [B, n, d] tensor."""
    import torch

    if not x.dtype.is_floating_point:
        return torch.zeros(x.shape[0], x.shape[2], dtype=torch.int64, device=x.device)
    return ((x == 0) & torch.signbit(x)).sum(dim=1)


def _value_sort_checks(x, out):
    """(name, ok) of a value sort's result against torch.sort's on the card:
    the values equal where torch.sort has no NaN, the NaNs at the same places
    (each column's last), the -0.0s of each column kept; and the largest
    error. torch.sort on the card puts a NaN with its sign bit set first
    (PyTorch's fp32 -> bf16 cast on the CPU makes every NaN 0xffff), where
    on the CPU it puts every NaN last; so the reference sorts the input with
    each NaN's sign bit cleared."""
    import torch

    if x.dtype.is_floating_point:
        x = torch.where(torch.isnan(x), x.abs(), x)
    ref = torch.sort(x, dim=1).values
    nan = torch.isnan(ref) if ref.dtype.is_floating_point else torch.zeros_like(ref, dtype=torch.bool)
    isnan = torch.isnan(out) if out.dtype.is_floating_point else nan
    err = (out[~nan].double() - ref[~nan].double()).abs().max().item() if bool((~nan).any()) else 0.0
    return [("sorted values equal torch.sort", torch.equal(out[~nan], ref[~nan])),
            ("NaN columns match", torch.equal(isnan, nan)),
            ("-0.0 count of each column kept", torch.equal(_negative_zeros(out), _negative_zeros(x)))], err


def _hold_value_sort(so, worst, shape, dtype):
    """Fails unless the value-sort kernel agrees with torch.sort on one input
    (`_value_sort_checks`) and a second run gives the same bits."""
    import torch

    x = _value_sort_input(shape, dtype, shape[1] + shape[2])
    tag = f"{tuple(shape)} {str(dtype).split('.')[-1]}"
    out, out2 = so.bitonic_sort_kernel(x), so.bitonic_sort_kernel(x)
    torch.cuda.synchronize()
    checks, err = _value_sort_checks(x, out)
    bits = torch.int16 if dtype.itemsize == 2 else torch.int32
    checks.append(("two runs give the same bits", torch.equal(out.view(bits), out2.view(bits))))
    nans = torch.isnan(x).sum().item() if dtype.is_floating_point else 0
    print(f"[kernel] value sort {tag} ({nans} NaN, {_negative_zeros(x).sum().item()} -0.0): "
          + "; ".join(f"{name}: {'ok' if ok else 'FAIL'}" for name, ok in checks))
    for name, ok in checks:
        if not ok:
            raise AssertionError(f"value sort {tag}: {name} failed")
    worst["bitonic_sort"] = max(worst.get("bitonic_sort", 0.0), err)


def _hold_sort(so, worst, shape, dtype):
    """Fails unless the sorted_l1 kernels agree with their plain versions on
    one input: signs and gradient exactly, the loss within LOSS_TOL, t's
    gradient zero, and a second run gives the same bits."""
    import torch

    s, t = _sort_inputs(shape, dtype, shape[1] + shape[2])
    tag = f"{tuple(shape)} {str(dtype).split('.')[-1]}"
    ties = (torch.sort(s, dim=1).values.diff(dim=1) == 0).sum().item()
    if ties == 0:
        raise AssertionError(f"sort check {tag}: the input has no ties")

    total, sign = so.kernel_sorted_l1_fwd(s, t)
    r_total, r_sign = so._plain_sl1_fwd(s, t)
    total2, sign2 = so.kernel_sorted_l1_fwd(s, t)
    loss, r_loss = (total / s.numel()).item(), (r_total / s.numel()).item()
    s_ref = s.clone().requires_grad_(True)
    (g_ref,) = torch.autograd.grad(so.sorted_l1_reference(s_ref, t, 1), [s_ref])
    scale = torch.ones((), device="cuda") / s.numel()
    g = so.kernel_sorted_l1_bwd(sign, scale, dtype)
    g2 = so.kernel_sorted_l1_bwd(sign, scale, dtype)
    # through the autograd Function, as the loss calls it
    s_fn, t_fn = s.clone().requires_grad_(True), t.clone().requires_grad_(True)
    g_fn, g_t = torch.autograd.grad(so.sorted_l1(s_fn, t_fn, 1), [s_fn, t_fn])
    torch.cuda.synchronize()

    loss_err = abs(loss - r_loss)
    grad_err = (g.float() - g_ref.float()).abs().max().item()
    checks = [
        ("loss", loss_err <= LOSS_TOL * abs(r_loss)),
        ("signs equal the plain version's", torch.equal(sign, r_sign)),
        ("gradient equals autograd through the stable sort",
         torch.equal(g, g_ref) and torch.equal(g_fn, g_ref)),
        ("gradient of t is zero", g_t.abs().max().item() == 0.0),
        ("two runs give the same bits", total.item() == total2.item()
         and torch.equal(sign, sign2) and torch.equal(g, g2)),
    ]
    print(f"[kernel] sort {tag} ({ties} ties): loss {loss:.8g} vs plain {r_loss:.8g} "
          f"(rel err {loss_err / abs(r_loss):.2e}, tol {LOSS_TOL}); "
          + "; ".join(f"{name}: {'ok' if ok else 'FAIL'}" for name, ok in checks))
    for name, ok in checks:
        if not ok:
            raise AssertionError(f"sort kernels {tag}: {name} failed")
    for kernel, err in (("sorted_l1_fwd", loss_err), ("sorted_l1_bwd", grad_err)):
        worst[kernel] = max(worst.get(kernel, 0.0), err)


def check_sort_kernels(so, worst):
    """Phase 4a: the sort kernels vs their plain versions, small shapes (the
    network with one key a lane at n = 2, two at n = 33 and 32 at n = 1024,
    16-byte loads at d = 384, one-element loads at d = 100, 40 and 20) and
    the main-path shape: the value sort in bf16, fp16, fp32 and int32, also
    at d = 1; the sorted_l1 kernels in bf16 and fp32."""
    import torch

    shapes = ((B_CHECK, 196, 384), (B_CHECK, 256, 384), (B_CHECK, 196, 100),
              (B_CHECK, 2, 40), (B_CHECK, 33, 40), (2, 1024, 20), SORT_MAIN)
    for dtype in (torch.bfloat16, torch.float16, torch.float32, torch.int32):
        for shape in shapes + ((B_CHECK, 196, 1), (4, 700, 1)):
            _hold_value_sort(so, worst, shape, dtype)
    for dtype in (torch.bfloat16, torch.float32):
        for shape in shapes:
            _hold_sort(so, worst, shape, dtype)


def time_sort_kernels(so):
    """Phase 4b: the sort kernels at the main-path shape in bf16 (the value
    sort in fp32 as well, `fp32_*` keys of its row): kernel, plain and
    library times, and the bound. Library: torch.sort(dim=1,
    stable=True) for the value sort; for sorted_l1 the stable sort of s and
    the sort of t with autograd's index scatter as the backward (its time is
    forward+backward minus forward). Bound: the larger of the bytes each
    kernel must move (inputs, outputs and the int8 residual once each) over
    the memory rate, and the network's compare-exchanges at this n (two
    operations each) over the fp32 rate."""
    import torch

    B, n, d = SORT_MAIN
    numel, esize = B * n * d, 2
    s, t = _sort_inputs(SORT_MAIN, torch.bfloat16, 1)
    _, sign = so.kernel_sorted_l1_fwd(s, t)
    scale = torch.ones((), device="cuda") / numel
    s_grad = s.clone().requires_grad_(True)
    n_pad = 1 << (n - 1).bit_length()
    stages = sum(range(1, n_pad.bit_length()))
    exchanges = B * d * (n_pad // 2) * stages

    def lib_fwd():
        return so.sorted_l1_reference(s_grad, t, 1)

    def lib_fwd_bwd():
        torch.autograd.grad(lib_fwd(), [s_grad])

    lib_both, lib_f = _timed(lib_fwd_bwd, 20), _timed(lib_fwd, 20)
    rows = {
        "bitonic_sort": dict(
            ms=_timed(lambda: so.bitonic_sort_kernel(s), 20),
            plain_ms=_timed(lambda: torch.sort(s, dim=1).values, 20),
            library_ms=_timed(lambda: torch.sort(s, dim=1, stable=True), 20),
            nbytes=2 * numel * esize, ops=2 * exchanges),
        "sorted_l1_fwd": dict(
            ms=_timed(lambda: so.kernel_sorted_l1_fwd(s, t), 20),
            plain_ms=_timed(lambda: so._plain_sl1_fwd(s, t), 20),
            library_ms=lib_f,
            nbytes=2 * numel * esize + numel + 4, ops=2 * 2 * exchanges),
        "sorted_l1_bwd": dict(
            ms=_timed(lambda: so.kernel_sorted_l1_bwd(sign, scale, torch.bfloat16), 20),
            plain_ms=_timed(lambda: so._plain_sl1_bwd(sign, scale, torch.bfloat16), 20),
            library_ms=lib_both - lib_f,
            nbytes=numel + 4 + numel * esize, ops=numel),
    }
    x32 = s.float()
    fp32 = dict(ms=_timed(lambda: so.bitonic_sort_kernel(x32), 20),
                plain_ms=_timed(lambda: torch.sort(x32, dim=1).values, 20),
                library_ms=_timed(lambda: torch.sort(x32, dim=1, stable=True), 20),
                nbytes=2 * numel * 4, ops=2 * exchanges)
    for kernel, row in (*rows.items(), ("bitonic_sort", fp32)):
        t_bytes, t_ops = row.pop("nbytes") / PEAK_BYTES, row.pop("ops") / PEAK_FP32_OPS
        row["bound_ms"] = max(t_bytes, t_ops) * 1e3
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        print(f"[time] {kernel} {SORT_MAIN} {'fp32' if row is fp32 else 'bf16'}: "
              f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, library "
              f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    rows["bitonic_sort"].update({f"fp32_{k}": v for k, v in fp32.items() if k != "bound_by"})
    print(f"[time] sorted_l1 library forward+backward {lib_both:.3f} ms, forward {lib_f:.3f} ms")
    return rows


def _hold_all(worst, key, tag, checks, same_bits):
    """Fails unless each (name, kernel output, plain output, tolerance or
    None for TOL of the plain output's largest value) agrees and a second run
    of the kernel gave the same bits. Keeps the largest abs error in
    worst[key]."""
    for name, a, b, abs_tol in checks:
        abs_err, mx = _err(a, b)
        limit = abs_tol if abs_tol is not None else TOL * mx
        ok = abs_err <= limit
        print(f"[kernel] {key if isinstance(key, str) else key[0]} {tag} {name}: max_abs_err "
              f"{abs_err:.3e} max |plain| {mx:.3e} (limit {limit:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{key} {tag} {name} disagrees with its plain version")
        worst[key] = max(worst.get(key, 0.0), abs_err)
    if not same_bits:
        raise AssertionError(f"{key} {tag}: two runs gave different bits")


def _attention_inputs(shape, seed):
    """q, k of std 1.5 (scores of std about 2.2, a softmax far from flat), v
    and the cotangent dO of std 1, bf16 on the card."""
    import torch

    g = torch.Generator().manual_seed(seed)
    q, k = (1.5 * torch.randn(shape, generator=g) for _ in range(2))
    v, do = (torch.randn(shape, generator=g) for _ in range(2))
    return tuple(t.cuda().bfloat16() for t in (q, k, v, do))


def _hold_attention(at, worst, shape, main=False):
    """Both attention kernels against their plain versions at one shape."""
    import torch

    q, k, v, do = _attention_inputs(shape, shape[0] + shape[1])
    o, lse = at.kernel_flash_fwd(q, k, v)
    o2, lse2 = at.kernel_flash_fwd(q, k, v)
    r_o, r_lse = at._plain_fwd(q, k, v)
    grads = at.kernel_flash_bwd(q, k, v, o, lse, do)
    grads2 = at.kernel_flash_bwd(q, k, v, o, lse, do)
    r_grads = at._plain_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    spread = r_lse.std().item()
    if not spread > 0.1:
        raise AssertionError(f"attention check {shape}: lse barely varies ({spread})")
    tag = f"{tuple(shape)}"
    fwd_key = ("flash_fwd", shape[0]) if main else "flash_fwd"
    bwd_key = ("flash_bwd", shape[0]) if main else "flash_bwd"
    _hold_all(worst, fwd_key, tag, [("o", o, r_o, None), ("lse", lse, r_lse, LSE_TOL)],
              torch.equal(o, o2) and torch.equal(lse, lse2))
    _hold_all(worst, bwd_key, tag,
              [(n, a, b, None) for n, a, b in zip(("dq", "dk", "dv"), grads, r_grads)],
              all(torch.equal(a, b) for a, b in zip(grads, grads2)))


def _hold_attention_views(at, worst, B, H, N):
    """flash_attention's gradient through its autograd Function on strided
    [B, H, N, 64] views of a packed [B, N, 3, H, 64] qkv projection (the
    model's layout, read in place) against autograd through the plain
    reference_attention on the same views: one launch of each kernel, two
    runs the same bits."""
    import torch

    g = torch.Generator().manual_seed(N + H)
    qkv = (1.5 * torch.randn(B, N, 3, H, HEAD_DIM, generator=g)).cuda().bfloat16()
    do = torch.randn(B, H, N, HEAD_DIM, generator=g).cuda().bfloat16()

    def grad(fn):
        leaf = qkv.clone().requires_grad_(True)
        views = [leaf[:, :, i].transpose(1, 2) for i in range(3)]
        return torch.autograd.grad(fn(*views), [leaf], do)[0]

    at.reset_launches()
    g1 = grad(at.flash_attention)
    launches = dict(at.LAUNCHES)
    g2 = grad(at.flash_attention)
    ref = grad(at.reference_attention)
    torch.cuda.synchronize()
    if launches != {("flash_fwd", B * H): 1, ("flash_bwd", B * H): 1}:
        raise AssertionError(f"attention on views [{B},{N},3,{H},64]: launches {launches}")
    _hold_all(worst, "flash_bwd", f"views [{B},{N},3,{H},{HEAD_DIM}]", [("dqkv", g1, ref, None)],
              torch.equal(g1, g2))


def check_attention_kernels(at, worst):
    """Phase 5a: the attention kernels vs their plain versions: 8 images of
    the student (3 heads), an N that is no multiple of 16, a 64-row tile and
    one row, N = 578 for 4 and for 48 (batch, head) pairs, N = 656 (the
    longest they take: the backward keeps dQ and delta of 11 row tiles in
    227,072 bytes of shared memory), the gradient through the autograd
    Function on strided views of a packed qkv projection, and the main
    path's two shapes."""
    for shape in ((B_CHECK * 3, N_TOK, HEAD_DIM), (4, 50, HEAD_DIM), (4, 65, HEAD_DIM),
                  (4, 578, HEAD_DIM), (B_CHECK * 6, 578, HEAD_DIM), (4, 656, HEAD_DIM)):
        _hold_attention(at, worst, shape)
    _hold_attention_views(at, worst, 2, 3, N_TOK)
    _hold_attention_views(at, worst, 1, 2, 656)
    for bh in ATTN_MAIN.values():
        _hold_attention(at, worst, (bh, N_TOK, HEAD_DIM), main=True)


def time_attention_kernels(at):
    """Phase 5b: the attention kernels at the main path's shapes: kernel,
    plain and library times and the bound. Library: one
    F.scaled_dot_product_attention call in bf16 (its backward's time is
    forward+backward minus forward). Bound: q, k, v, o (and for the backward
    dO, dq, dk, dv) and lse once each over the memory rate, against two (five)
    N x N x 64 products over the bf16 rate."""
    import torch
    import torch.nn.functional as F

    rows = {}
    for kernel, who in (("flash_fwd", "teacher"), ("flash_fwd", "student"),
                        ("flash_bwd", "student")):
        bh = ATTN_MAIN[who]
        q, k, v, do = _attention_inputs((bh, N_TOK, HEAD_DIM), 3)
        o, lse = at.kernel_flash_fwd(q, k, v)
        q4, k4, v4, do4 = (t.reshape(B_MAIN, -1, N_TOK, HEAD_DIM) for t in (q, k, v, do))
        tensor_bytes, product = bh * N_TOK * HEAD_DIM * 2, 2 * bh * N_TOK * N_TOK * HEAD_DIM
        extra = ""
        if kernel == "flash_fwd":
            ms = _timed(lambda: at.kernel_flash_fwd(q, k, v), 20)
            plain_ms = _timed(lambda: at._plain_fwd(q, k, v), 5)
            with torch.no_grad():
                library_ms = _timed(lambda: F.scaled_dot_product_attention(q4, k4, v4), 20)
            bound = _bound(2 * product, 4 * tensor_bytes + bh * N_TOK * 4)
        else:
            ms = _timed(lambda: at.kernel_flash_bwd(q, k, v, o, lse, do), 20)
            plain_ms = _timed(lambda: at._plain_bwd(q, k, v, o, lse, do), 5)
            leaves = [t.detach().requires_grad_(True) for t in (q4, k4, v4)]

            def lib_fwd():
                return F.scaled_dot_product_attention(*leaves)

            def lib_fwd_bwd():
                torch.autograd.grad(lib_fwd(), leaves, do4)

            both, fwd = _timed(lib_fwd_bwd, 20), _timed(lib_fwd, 20)
            library_ms = both - fwd
            extra = f" (library forward+backward {both:.3f} ms, forward {fwd:.3f} ms)"
            bound = _bound(5 * product, 8 * tensor_bytes + bh * N_TOK * 4)
        rows[(kernel, bh)] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bound)
        print(f"[time] {kernel} {who} [{bh},{N_TOK},{HEAD_DIM}]: {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, library {library_ms:.3f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}){extra}")
    return rows


def _mlp_inputs(M, D, seed):
    """x and the cotangent dy of std 1 in bf16, fp32 weights of std
    1/sqrt(fan-in) in nn.Linear layout and biases of std 0.1, on the card."""
    import torch

    g = torch.Generator().manual_seed(seed)
    F = 4 * D
    x, dy = (torch.randn(M, D, generator=g).cuda().bfloat16() for _ in range(2))
    w1 = (torch.randn(F, D, generator=g) / math.sqrt(D)).cuda()
    w2 = (torch.randn(D, F, generator=g) / math.sqrt(F)).cuda()
    b1, b2 = ((0.1 * torch.randn(n, generator=g)).cuda() for n in (F, D))
    return x, w1, b1, w2, b2, dy


def _hold_mlp(fm, worst, M, D, main=False):
    """Both fused-MLP kernels against their plain versions at one shape."""
    import torch

    x, w1, b1, w2, b2, dy = _mlp_inputs(M, D, M + D)
    out, out2 = (fm.kernel_fused_mlp(x, w1, b1, w2, b2) for _ in range(2))
    r_out = fm._plain_fwd(x, w1, b1, w2, b2)
    grads, grads2 = (fm.kernel_fused_mlp_bwd(x, w1, b1, w2, dy) for _ in range(2))
    r_grads = fm._plain_bwd(x, w1, b1, w2, dy)
    torch.cuda.synchronize()
    tag = f"M={M} D={D}"
    _hold_all(worst, ("fused_mlp_fwd", D) if main else "fused_mlp_fwd", tag,
              [("out", out, r_out, None)], torch.equal(out, out2))
    _hold_all(worst, ("fused_mlp_bwd", D) if main else "fused_mlp_bwd", tag,
              [(n, a, b, None) for n, a, b in
               zip(("dx", "dW1", "db1", "dW2", "db2"), grads, r_grads)],
              all(torch.equal(a, b) for a, b in zip(grads, grads2)))


def check_mlp_kernels(fm, worst):
    """Phase 5c: the fused-MLP kernels vs their plain versions at every width
    of the model zoo (D = 192, 384, 768, 1024: every forward plan, one to four
    column passes): 8 images' rows (1584 = 24.75 row tiles) and an odd M;
    then the main path's M = 50688 at the student's and the teacher's
    width."""
    for D in MLP_WIDTHS:
        for M in (B_CHECK * N_TOK, 1001):
            _hold_mlp(fm, worst, M, D)
    for D in MLP_MAIN.values():
        _hold_mlp(fm, worst, M_MAIN, D, main=True)


# Workspace bytes of the MLP backward at [50688, 192] in the design that ran
# its products on a WMMA tile and kept an fp32 copy of dhpre.
MLP_BWD_WORKSPACE_BEFORE = 525_837_312


def print_mlp_backward_workspace(fm):
    """The MLP backward's workspace at the main path's [50688, 192], beside
    MLP_BWD_WORKSPACE_BEFORE and per element of the [M, F] hidden (h and
    dhpre in bf16 and gelu' in fp32 are 8 bytes of it; the earlier design's
    fp32 copy of dhpre made it 12 and more). Fails unless it is below
    MLP_BWD_WORKSPACE_BEFORE."""
    D, M = MLP_MAIN["student"], M_MAIN
    F = 4 * D
    now, before = fm.workspace_bytes(M, D, F), MLP_BWD_WORKSPACE_BEFORE
    print(f"[workspace] fused_mlp_bwd [{M},{D}]: {now} bytes, before {before}, {before - now} "
          f"less; {now / (M * F):.4f} bytes an element of the [M, F] hidden (before "
          f"{before / (M * F):.4f})")
    if now >= before:
        raise AssertionError(f"fused_mlp_bwd: the workspace is {now} bytes, not below {before}")


def time_mlp_widths(fm):
    """The forward kernel at every zoo width at M = 50688 on fp32 parameters,
    as the model passes them (the wrapper casts them on every call), beside
    the library call (F.linear + F.gelu + F.linear on bf16 copies) and the
    bound of the MLP's own work (above D = 384 the kernel recomputes fc1 once
    per column pass: 1.5x the MLP's operations at D = 768, 2.5x at 1024).
    Uses nothing of ``fm`` but kernel_fused_mlp, so that an earlier commit's
    package can be timed the same way (scripts/time_kernels.py). Returns
    {D: (ms, library_ms, bound_ms)}."""
    import torch
    import torch.nn.functional as F

    rows = {}
    for D in MLP_WIDTHS:
        x, w1, b1, w2, b2, _ = _mlp_inputs(M_MAIN, D, 5)
        lib = [t.bfloat16() for t in (x, w1, b1, w2, b2)]
        ms = _timed(lambda: fm.kernel_fused_mlp(x, w1, b1, w2, b2), 10)
        with torch.no_grad():
            library_ms = _timed(
                lambda: F.linear(F.gelu(F.linear(lib[0], lib[1], lib[2])), lib[3], lib[4]), 10)
        bound = _bound(2 * 2 * M_MAIN * D * 4 * D, 2 * M_MAIN * D * 2 + 2 * D * 4 * D * 2 + 5 * D * 4)
        rows[D] = (ms, library_ms, bound["bound_ms"])
        print(f"[time] fused_mlp_fwd width M={M_MAIN} D={D}: {ms:.4f} ms (fp32 parameters), "
              f"library {library_ms:.4f} ms, kernel/library {ms / library_ms:.4f}, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        del x, w1, b1, w2, b2, lib
    return rows


def time_mlp_kernels(fb, fm):
    """Phase 5d: the fused-MLP kernels at the main path's shapes, on fp32
    parameters as the model passes them (the wrappers cast them to bf16 on
    every call). Library: F.linear + F.gelu + F.linear in bf16 and its
    autograd backward (forward+backward minus forward). Bound: two (five)
    M x D x 4D products over the bf16 rate, against x and out (x, dy, dx),
    the bf16 weights and, for the backward, the fp32 weight gradients over
    the memory rate. Beside the forward, `[mlp two-gemm]`: the same MLP as two
    products on the block's GEMM (fb.kernel_linear with GELU, then without,
    the hidden through device memory) on bf16 weights and bf16-rounded
    biases, held against the fused kernel on the same operands within TOL
    and timed in turns with it (fused, two-gemm, two-gemm, fused)."""
    import torch
    import torch.nn.functional as F

    rows = {}
    for kernel, who in (("fused_mlp_fwd", "teacher"), ("fused_mlp_fwd", "student"),
                        ("fused_mlp_bwd", "student")):
        D = MLP_MAIN[who]
        x, w1, b1, w2, b2, dy = _mlp_inputs(M_MAIN, D, 5)
        lib = [t.bfloat16() for t in (x, w1, b1, w2, b2)]
        product, weights = 2 * M_MAIN * D * 4 * D, 2 * D * 4 * D
        extra = ""

        def lib_fwd():
            return F.linear(F.gelu(F.linear(lib[0], lib[1], lib[2])), lib[3], lib[4])

        if kernel == "fused_mlp_fwd":
            # the two-gemm chain takes bf16 weights and bf16-rounded biases;
            # the fused kernel is timed on those too, beside its time on the
            # fp32 parameters the model passes (`ms`, the row's time)
            w1b, w2b = w1.bfloat16(), w2.bfloat16()
            b1r, b2r = b1.bfloat16().float(), b2.bfloat16().float()

            def fused():
                return fm.kernel_fused_mlp(x, w1b, b1r, w2b, b2r)

            def two_gemm():
                h = fb.kernel_linear(x, w1b, b1r, gelu=True, outputs=("bf16",))[1]
                return fb.kernel_linear(h, w2b, b2r, outputs=("bf16",))[1]

            abs_err, mx = _err(two_gemm(), fused())
            if abs_err > TOL * mx:
                raise AssertionError(f"fused_mlp_fwd D={D}: the two-gemm chain and the fused "
                                     f"kernel differ by {abs_err:.3e} of {mx:.3e}")
            turns = [_timed(fn, 10) for fn in (fused, two_gemm, two_gemm, fused)]
            lp_ms, chain_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            print(f"[mlp two-gemm] {who} M={M_MAIN} D={D}, bf16 operands: fused {lp_ms:.4f} ms "
                  f"(turns {turns[0]:.4f}, {turns[3]:.4f}), two linear_sm90 products "
                  f"{chain_ms:.4f} ms (turns {turns[1]:.4f}, {turns[2]:.4f}), fused/two-gemm "
                  f"{lp_ms / chain_ms:.4f}; max |fused - two-gemm| {abs_err:.3e} of {mx:.3e}")
            ms = _timed(lambda: fm.kernel_fused_mlp(x, w1, b1, w2, b2), 10)
            extra = (f" (fp32 parameters, cast on every call; on bf16 operands "
                     f"{lp_ms:.3f} ms)")
            plain_ms = _timed(lambda: fm._plain_fwd(x, w1, b1, w2, b2), 3)
            with torch.no_grad():
                library_ms = _timed(lib_fwd, 20)
            bound = _bound(2 * product, 2 * M_MAIN * D * 2 + weights * 2 + 5 * D * 4)
        else:
            ms = _timed(lambda: fm.kernel_fused_mlp_bwd(x, w1, b1, w2, dy), 10)
            plain_ms = _timed(lambda: fm._plain_bwd(x, w1, b1, w2, dy), 3)
            lib = [t.requires_grad_(True) for t in lib]

            def lib_fwd_bwd():
                torch.autograd.grad(lib_fwd(), lib, dy)

            both, fwd = _timed(lib_fwd_bwd, 20), _timed(lib_fwd, 20)
            library_ms = both - fwd
            extra = f" (library forward+backward {both:.3f} ms, forward {fwd:.3f} ms)"
            bound = _bound(5 * product, 3 * M_MAIN * D * 2 + weights * (2 + 4) + 9 * D * 4)
            profile_calls(f"fused_mlp_bwd M={M_MAIN} D={D}",
                          lambda: fm.kernel_fused_mlp_bwd(x, w1, b1, w2, dy))
        rows[(kernel, D)] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bound)
        print(f"[time] {kernel} {who} M={M_MAIN} D={D}: {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"library {library_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}){extra}")
    return rows


def _block_launches(steps):
    return {("fused_block_fwd", 384): 12 * steps, ("fused_block_fwd", 192): 12 * steps,
            ("fused_block_bwd", 192): 12 * steps}


def _paired_launches(steps):
    return {("fused_block_fwd", 384): 12 * steps, ("fused_pair_fwd", 192): 6 * steps,
            ("fused_pair_bwd", 192): 6 * steps}


def _unfused_launches(steps):
    return {("flash_fwd", ATTN_MAIN["teacher"]): 12 * steps,
            ("flash_fwd", ATTN_MAIN["student"]): 12 * steps,
            ("flash_bwd", ATTN_MAIN["student"]): 12 * steps,
            ("fused_mlp_fwd", MLP_MAIN["teacher"]): 12 * steps}


def _reset_launches(mods):
    for mod in mods:
        mod.reset_launches()


def _read_launches(mods):
    return {k: n for mod in mods for k, n in mod.LAUNCHES.items()}


def _unfused_models(cfg, num_classes):
    """Teacher and student on the unfused path, built as the JAX package's
    bench builds them: explicit attention_fn / mlp_fn and no block_fn; the
    forward-only teacher also takes fused_mlp."""
    import torch

    from deltakd_tpu_torch.models.factory import create_model
    from deltakd_tpu_torch.ops.attention import flash_attention
    from deltakd_tpu_torch.ops.fused_mlp import fused_mlp

    kw = dict(num_classes=num_classes, img_size=cfg.input_size, dtype=torch.bfloat16,
              attention_fn=flash_attention, block_fn=None, collect_features=False,
              device="cuda")
    teacher = create_model(cfg.teacher_model, mlp_fn=fused_mlp, seed=1, **kw)
    teacher.requires_grad_(False)
    student = create_model(cfg.student_model, drop_path_rate=cfg.drop_path_rate, seed=2, **kw)
    return teacher, student


def run_train_path(mods, kd_type, steps, unfused=False, paired=False,
                   teacher_checkpoint=None):
    """Phase 6: ``steps`` train steps of one distillation type at full width
    through load_teacher_student (the fused block; with ``paired`` the student
    on block pairs, block_pair=True) or, with ``unfused``, create_model with
    attention_fn / mlp_fn and no block_fn, then TrainState ->
    build_train_step. The launch counts are set to 0 just before the steps
    and read just after. With ``teacher_checkpoint`` the config is the
    recipe's (exp/soft-deit-tiny.sh: TrainConfig's defaults, RandAugment and
    colour jitter 0.3 among them, and the teacher from that file); otherwise
    aa='', no colour jitter and a random teacher. Returns (launches, step ms,
    what the later phases need)."""
    import numpy as np
    import torch

    from deltakd_tpu_torch.configs.config import TrainConfig
    from deltakd_tpu_torch.data.augment import AugmentConfig
    from deltakd_tpu_torch.data.mixup import MixupConfig
    from deltakd_tpu_torch.kd.losses import KDSettings
    from deltakd_tpu_torch.models.factory import load_teacher_student
    from deltakd_tpu_torch.train.optim import make_optimizer
    from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
    from deltakd_tpu_torch.train.step import build_train_step

    if teacher_checkpoint is None:
        cfg = TrainConfig(teacher_model="deit_small_distilled_patch16_224",
                          student_model="deit_tiny_distilled_patch16_224",
                          batch_size=B_MAIN, distillation_type=kd_type, dataset="cifar-100",
                          input_size=224, dtype="bfloat16", drop_path_rate=0.1, epochs=300,
                          aug_pixel_bf16=True, aa="", color_jitter=0.0,
                          allow_random_teacher=True)
    else:
        cfg = TrainConfig(teacher_model="deit_small_distilled_patch16_224",
                          student_model="deit_tiny_distilled_patch16_224",
                          batch_size=B_MAIN, distillation_type=kd_type, dataset="cifar-100",
                          weight_decay=1e-4, alpha=0.1, tau=3.0,
                          teacher_checkpoint=teacher_checkpoint)
    if unfused:
        from deltakd_tpu_torch.data.registry import DATASET_STATS

        teacher, student = _unfused_models(cfg, DATASET_STATS[cfg.dataset]["num_classes"])
        aux = None
    else:
        teacher, student, aux = load_teacher_student(cfg, block_pair=paired, seed=0,
                                                     device="cuda")
    num_classes = student.cfg.num_classes
    name = (f"unfused {kd_type}" if unfused else f"paired {kd_type}" if paired
            else f"{kd_type} recipe" if teacher_checkpoint else kd_type)
    tx = make_optimizer(cfg, trainable_parameters(student, aux), 100)
    state = TrainState(student, tx=tx, aux=aux)
    aug = AugmentConfig.from_config(cfg)
    kd = KDSettings.from_config(cfg, student_prefix=student.cfg.num_prefix_tokens,
                                teacher_prefix=teacher.cfg.num_prefix_tokens)
    step = build_train_step(cfg=cfg, kd=kd, student=student, teacher=teacher, aux=aux,
                            aug=aug, mixup=MixupConfig.from_config(cfg, num_classes), tx=tx)
    host = np.random.RandomState(0)
    images = torch.from_numpy(host.randint(0, 256, (B_MAIN, 32, 32, 3), dtype=np.uint8)).cuda()
    labels = torch.from_numpy(host.randint(0, num_classes, (B_MAIN,))).cuda()
    gen = torch.Generator(device="cuda").manual_seed(4)
    params0 = state.params.clone()
    n_student = sum(p.numel() for p in student.parameters())

    torch.cuda.synchronize()
    _reset_launches(mods)
    times, metrics = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = step(state, images, labels, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = _read_launches(mods)
    print(f"[{name}] launches over {steps} steps: {launches}")
    if unfused:   # after the counts are read: where the step's device time goes
        profile_calls(f"{name} step", lambda: step(state, images, labels, gen), calls=2)
        profile_parts(f"{name} step", lambda: step(state, images, labels, gen), UNFUSED_PARTS)
    elif kd_type == "soft" and not paired:
        profile_parts(f"{name} step", lambda: step(state, images, labels, gen), STEP_PARTS)
    expect = (_unfused_launches if unfused else _paired_launches if paired
              else _block_launches)(steps)
    if kd_type == "wasskd":
        expect.update(sorted_l1_fwd=3 * steps, sorted_l1_bwd=3 * steps)
    if launches != expect:
        raise AssertionError(f"{name}: kernel launches {launches}, expected {expect}")
    for i, m in enumerate(metrics):
        print(f"[{name}] step {i}: " + " ".join(f"{k}={v:.5g}" for k, v in m.items())
              + f" time={times[i] * 1e3:.1f} ms")
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"{name}: non-finite metrics at step {i}: {m}")
        if kd_type != "soft" and not m["distill_loss"] > 0:
            raise AssertionError(f"{name}: distill_loss {m['distill_loss']} at step {i}")
    delta = (state.params - params0).abs()
    changed = {"student": delta[:n_student].max().item()}
    if aux is not None:
        changed["aux"] = delta[n_student:].max().item()
    if not all(v > 0 for v in changed.values()):
        raise AssertionError(f"{name}: parameters did not change: {changed}")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    print(f"[{name}] step time (median of steps 1-{steps - 1}) {steady * 1e3:.2f} ms, "
          f"{B_MAIN / steady:.1f} images/s; max |param change| {changed}")
    return launches, steady * 1e3, (teacher, student, aux, aug, kd, images, labels)


def write_teacher_checkpoint(path):
    """A random-weight DeiT-S-distilled as timm and DeiT save one: a
    1000-class head, a 24 x 24 position grid (384 px), every key with
    'module.' inside {"model": ...} beside non-tensor entries. Returns the
    state_dict (timm names, CPU tensors)."""
    import torch

    from deltakd_tpu_torch.models.vit import ViTConfig, VisionTransformer, init_weights

    src = VisionTransformer(ViTConfig(img_size=384, patch_size=16, embed_dim=384, depth=12,
                                      num_heads=6, num_classes=1000, distilled=True),
                            dtype=torch.float32)
    init_weights(src, torch.Generator().manual_seed(7))
    with torch.no_grad():   # non-zero biases and gains, so that loading them shows
        for p in src.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    state = src.state_dict()
    torch.save({"model": {"module." + k: v for k, v in state.items()}, "epoch": 299,
                "args": "deit_small_distilled_patch16_384"}, path)
    return state


def run_recipe_path(mods):
    """Phase 10, the soft recipe path: exp/soft-deit-tiny.sh's configuration
    (TrainConfig's defaults: rand-m9-mstd0.5-inc1, mixup 0.8 / cutmix 1.0,
    reprob 0.25, the bf16 pixel stage; weight decay 1e-4, alpha 0.1, tau 3)
    with its teacher imported from a checkpoint written here. Checks the
    import report (both heads skipped, every block loaded, nothing
    unconsumed), that the teacher's blocks equal the file's and that its
    position embedding is the file's 24 x 24 grid interpolated to 14 x 14,
    then runs RECIPE_STEPS train steps through run_train_path."""
    import tempfile

    import torch

    from deltakd_tpu_torch.models.pos_embed import interpolate_pos_embed

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "deit_small_distilled_patch16_384.pth")
        state = write_teacher_checkpoint(path)
        launches, ms, kept = run_train_path(mods, "soft", RECIPE_STEPS, teacher_checkpoint=path)
    teacher = kept[0]
    report = teacher.import_report
    heads = ["head.weight", "head.bias", "head_dist.weight", "head_dist.bias"]
    blocks = [k for k in state if k.startswith("blocks.")]
    sd = {k: v.cpu() for k, v in teacher.state_dict().items()}
    differ = [k for k in blocks if not torch.equal(sd[k], state[k])]
    grid = interpolate_pos_embed(state["pos_embed"], 2, 14 * 14)
    ok = (report["skipped"] == heads and set(blocks) <= set(report["loaded"])
          and not report["unconsumed"] and not differ
          and tuple(sd["pos_embed"].shape) == (1, 2 + 14 * 14, 384)
          and torch.equal(sd["pos_embed"], grid))
    print(f"[teacher import] skipped {report['skipped']}; loaded {len(report['loaded'])} "
          f"(the {len(blocks)} block tensors among them, {len(differ)} differ from the file); "
          f"unconsumed {report['unconsumed']}; pos_embed {tuple(state['pos_embed'].shape)} -> "
          f"{tuple(sd['pos_embed'].shape)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the teacher import does not match its checkpoint")
    return launches, ms, kept


def _pixels_agree(what, a, b, tol, level, ops=None):
    """At most ``level`` + ``tol`` anywhere and under 1% of the values beyond
    ``tol`` (the port's CPU tests hold it to JAX so). On a failure, prints
    what the worst image drew from ``ops`` (RA layers or AA slots)."""
    diff = (a.float().cpu() - b.float().cpu()).abs()
    mx, share = diff.max().item(), (diff > tol).float().mean().item()
    ok = mx <= level + tol and share < 0.01
    where = [int(i) for i in (diff == mx).nonzero()[0]] if mx > 0 else []
    print(f"[augment] {what}: max diff {mx:.3e} at {where} (bound {level + tol:.3e}), share "
          f"beyond {tol:g} {share:.5f} (bound 0.01) {'ok' if ok else 'FAIL'}")
    if not ok:
        for i, op in enumerate(ops or []):
            b_ = where[0]
            print(f"[augment] {what}: image {b_}, layer {i}: op {int(op.op_idx[b_])}, "
                  f"applied {bool(op.apply[b_])}, magnitude {float(op.m[b_]):.4f}")
        raise AssertionError(f"{what}: the card disagrees with the CPU")


def check_augment():
    """Phase 9, the train-time data path at B_MAIN, 224 px: for each of
    AUG_VARIANTS the draws are made on the card, the transform runs on them
    twice under torch.cuda's sync debug mode 'error' (a host sync raises)
    and must give the same bits; the CPU runs the same draws, and the card
    is held against it stage by stage: the geometric stage (integer pixels:
    a difference is a rounding flip, one level at each of the bicubic
    resample's two roundings), then the pixel stage from the CPU's
    integers. Then mixup in its three modes on the RA batch, card
    against CPU on the same draws, twice the same bits. Each is timed on the
    card (draws and transform, as the step calls it; and by stage). Returns
    {variant: ms}."""
    import numpy as np
    import torch

    from deltakd_tpu_torch.configs.config import TrainConfig
    from deltakd_tpu_torch.data import augment as ta
    from deltakd_tpu_torch.data import mixup as tm

    host = np.random.RandomState(5)
    u8 = {px: torch.from_numpy(host.randint(0, 256, (B_MAIN, px, px, 3), dtype=np.uint8)).cuda()
          for px in (32, 256)}
    rows, ra_batch = {}, None
    for name, kw, px in AUG_VARIANTS:
        ac = ta.AugmentConfig.from_config(TrainConfig(dataset="cifar-100", **kw))
        x = u8[px]
        gen = torch.Generator(device="cuda").manual_seed(11)
        ta.train_transform(gen, x, ac)      # first calls: handles and caches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            d = ta.draw_train_transform(gen, x.shape, ac, device="cuda")
            out = ta.apply_train_transform(x, ac, d)
            again = ta.apply_train_transform(x, ac, d)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if not torch.equal(out, again):
            raise AssertionError(f"{name}: two runs of the transform differ")
        d_cpu = ta.draws_to(d, "cpu")
        geo = ta.geometric_stage(x, ac, d)
        geo_cpu = ta.geometric_stage(x.cpu(), ac, d_cpu)
        # integer pixels: the bicubic resample rounds twice (between its passes
        # and at the end), and a sum that differs in its last bit can flip each
        # rounding by one level
        _pixels_agree(f"{name}: geometric stage, card vs CPU", geo, geo_cpu, 1e-3, 2.0)
        tol = 1.6e-2 if ac.pixel_bf16 else 1e-5
        _pixels_agree(f"{name}: pixel stage from the same integers, card vs CPU",
                      ta.pixel_stage(geo_cpu.cuda(), ac, d), ta.pixel_stage(geo_cpu, ac, d_cpu),
                      tol, GREY_LEVEL, ops=d_cpu.ra or d_cpu.aa)
        whole = (out.float().cpu() - ta.apply_train_transform(x.cpu(), ac, d_cpu).float()).abs()
        # 4 calls stay inside _timed's head start, so the events bracket the
        # card's work; the host's time a call is taken beside it
        ms = _timed(lambda: ta.train_transform(gen, x, ac), 4)
        geo_ms = _timed(lambda: ta.geometric_stage(x, ac, d), 4)
        pix_ms = _timed(lambda: ta.pixel_stage(geo, ac, d), 4)
        host_ms = _host_ms(lambda: ta.train_transform(gen, x, ac), 4)
        print(f"[augment] {name}: whole transform card vs CPU: share beyond {tol:g} "
              f"{(whole > tol).float().mean().item():.5f}, max diff {whole.max().item():.3e}; "
              f"{ms:.3f} ms a batch of {B_MAIN} on the card (geometric stage {geo_ms:.3f}, "
              f"pixel stage {pix_ms:.3f}), {host_ms:.3f} ms on the host's clock to the end, "
              f"two runs the same bits, no host sync")
        rows[name] = dict(ms=ms, geometric_ms=geo_ms, pixel_ms=pix_ms, host_ms=host_ms)
        if name == "RA bf16 32px":   # the recipe's: where its time goes
            ra_batch = out
            profile_calls(f"train transform {name}", lambda: ta.train_transform(gen, x, ac))
    labels = torch.from_numpy(host.randint(0, 100, (B_MAIN,))).cuda()
    S = ra_batch.shape[1]
    for mode in ("batch", "elem", "pair"):
        mc = tm.MixupConfig(num_classes=100, mode=mode)
        gen = torch.Generator(device="cuda").manual_seed(12)
        torch.cuda.set_sync_debug_mode("error")
        try:
            md = tm.draw_mixup(gen, mc, B_MAIN, S, S, "cuda")
            img, tgt = tm.mix_batch(ra_batch, labels, mc, md)
            img2, tgt2 = tm.mix_batch(ra_batch, labels, mc, md)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if not (torch.equal(img, img2) and torch.equal(tgt, tgt2)):
            raise AssertionError(f"mixup {mode}: two runs differ")
        img_c, tgt_c = tm.mix_batch(ra_batch.cpu(), labels.cpu(), mc, ta.draws_to(md, "cpu"))
        _pixels_agree(f"mixup {mode}: images, card vs CPU", img, img_c, 1.6e-2, 0.0)
        _pixels_agree(f"mixup {mode}: targets, card vs CPU", tgt, tgt_c, 1e-6, 0.0)
        ms = _timed(lambda: tm.apply_mixup(gen, ra_batch, labels, mc), 4)
        print(f"[augment] mixup {mode}: {ms:.3f} ms a batch on the card, two runs the same "
              f"bits, no host sync")
        rows[f"mixup {mode}"] = dict(ms=ms)
    return rows


def run_eval(mods, student, aug, images, labels, expect, name="eval"):
    """One eval batch through build_eval_step; returns its launches, which
    must be exactly ``expect``."""
    import torch

    from deltakd_tpu_torch.train.step import build_eval_step

    eval_step = build_eval_step(student=student, aug=aug)
    torch.cuda.synchronize()
    _reset_launches(mods)
    sums = {k: float(v) for k, v in eval_step(images, labels, B_MAIN).items()}
    torch.cuda.synchronize()
    eval_launches = _read_launches(mods)
    print(f"[{name}] {sums}; launches {eval_launches}")
    if eval_launches != expect:
        raise AssertionError(f"{name} launches {eval_launches}, expected {expect}")
    if sums["count"] != B_MAIN or not all(math.isfinite(v) for v in sums.values()):
        raise AssertionError(f"bad {name} sums {sums}")
    return eval_launches


def run_mlp_train(mods, fm):
    """fused_mlp_train forward and backward through its public function at the
    student's [256, 198, 192] (no model calls it, in the JAX package either):
    one forward and one backward launch, finite gradients of the operands'
    shapes and dtypes."""
    import torch

    D = MLP_MAIN["student"]
    x, w1, b1, w2, b2, dy = _mlp_inputs(M_MAIN, D, 9)
    ops = [t.requires_grad_(True) for t in (x.reshape(B_MAIN, N_TOK, D), w1, b1, w2, b2)]
    _reset_launches(mods)
    out = fm.fused_mlp_train(*ops)
    grads = torch.autograd.grad(out, ops, dy.reshape(out.shape))
    torch.cuda.synchronize()
    launches = _read_launches(mods)
    print(f"[fused_mlp_train] launches {launches}")
    if launches != {("fused_mlp_fwd", D): 1, ("fused_mlp_bwd", D): 1}:
        raise AssertionError(f"fused_mlp_train launches {launches}, expected one forward "
                             f"and one backward")
    for g, t in zip(grads, ops):
        if g.shape != t.shape or g.dtype != t.dtype or not torch.isfinite(g).all():
            raise AssertionError("fused_mlp_train: a gradient is not finite or not of "
                                 "its operand's shape and dtype")
    return launches


def run_no_qkv_bias(mods, images, aug):
    """A model without a qkv bias (2 blocks at the student's width) on the
    card: it takes the unfused path through the attention and MLP kernels,
    never the fused block it was also given, and agrees with its CPU plain
    path."""
    import torch

    from deltakd_tpu_torch.data.augment import eval_transform
    from deltakd_tpu_torch.models.vit import ViTConfig, VisionTransformer, init_weights
    from deltakd_tpu_torch.ops.attention import flash_attention
    from deltakd_tpu_torch.ops.fused_block import fused_vit_block
    from deltakd_tpu_torch.ops.fused_mlp import fused_mlp

    cfg = ViTConfig(num_classes=100, embed_dim=192, depth=2, num_heads=3, qkv_bias=False,
                    distilled=True)
    model = VisionTransformer(cfg, attention_fn=flash_attention, mlp_fn=fused_mlp,
                              block_fn=fused_vit_block)
    init_weights(model, torch.Generator().manual_seed(7))
    x = eval_transform(images[:4], aug).bfloat16()
    with torch.no_grad():
        on_cpu = model(x.cpu(), train=False).logits.float()
        model = model.cuda()
        _reset_launches(mods)
        on_card = model(x, train=False).logits.float().cpu()
    launches = _read_launches(mods)
    print(f"[no qkv bias] launches {launches}")
    if launches != {("flash_fwd", 4 * 3): 2, ("fused_mlp_fwd", 192): 2}:
        raise AssertionError(f"no-qkv-bias launches {launches}, expected 2 attention and "
                             f"2 MLP forward launches and no fused block")
    _agree("no-qkv-bias model logits", on_card, on_cpu, (4, 100))
    return launches


def run_value_sort(so):
    """The value sort through its public function, at the main-path shape in
    its four dtypes (no model calls it, in the JAX package either)."""
    import torch

    dtypes = (torch.bfloat16, torch.float16, torch.float32, torch.int32)
    inputs = [_value_sort_input(SORT_MAIN, dtype, 2) for dtype in dtypes]
    so.reset_launches()
    outs = [so.bitonic_sort(x, axis=1) for x in inputs]
    launches = dict(so.LAUNCHES)
    for x, out in zip(inputs, outs):
        checks, _ = _value_sort_checks(x, out)
        for name, ok in checks:
            if not ok:
                raise AssertionError(f"bitonic_sort {x.dtype}: {name} failed")
    print(f"[value sort] launches {launches}")
    if launches != {"bitonic_sort": len(dtypes)}:
        raise AssertionError(f"value sort launches {launches}, expected {len(dtypes)}")
    return launches


def run_odd_depth_pair(mods, images, aug):
    """A depth-3 student at the student's width on block pairs: blocks 0-1 go
    through the pair kernels, the odd last block through the single-block
    kernels, forward and backward; its eval logits agree with its CPU plain
    path."""
    import torch

    from deltakd_tpu_torch.data.augment import eval_transform
    from deltakd_tpu_torch.models.vit import ViTConfig, VisionTransformer, init_weights
    from deltakd_tpu_torch.ops.fused_block import fused_vit_block, fused_vit_block_pair

    cfg = ViTConfig(num_classes=100, embed_dim=192, depth=3, num_heads=3, distilled=True,
                    drop_path_rate=0.1)
    model = VisionTransformer(cfg, block_fn=fused_vit_block, block_pair_fn=fused_vit_block_pair,
                              collect_features=frozenset({1, 2}))
    init_weights(model, torch.Generator().manual_seed(8))
    x = eval_transform(images[:8], aug).bfloat16()
    with torch.no_grad():
        on_cpu = model(x.cpu(), train=False).logits.float()
    model = model.cuda()
    _reset_launches(mods)
    out = model(x, train=True, generator=torch.Generator(device="cuda").manual_seed(1))
    loss = out.logits.square().mean() + sum(f.float().square().mean()
                                            for f in out.features if f is not None)
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    torch.cuda.synchronize()
    launches = _read_launches(mods)
    print(f"[depth-3 pair] launches {launches}")
    if launches != {("fused_pair_fwd", 192): 1, ("fused_pair_bwd", 192): 1,
                    ("fused_block_fwd", 192): 1, ("fused_block_bwd", 192): 1}:
        raise AssertionError(f"depth-3 paired model launches {launches}, expected one pair "
                             f"and one single block, forward and backward")
    if [f is not None for f in out.features] != [False, True, True]:
        raise AssertionError("depth-3 paired model: features do not follow collect_features")
    block_grads = [g for (n, _), g in zip(model.named_parameters(), grads)
                   if n.startswith("blocks.")]
    if len(block_grads) != 36 or not all(g is not None and torch.isfinite(g).all()
                                         and g.abs().max() > 0 for g in block_grads):
        raise AssertionError("depth-3 paired model: a block gradient is missing, zero or "
                             "not finite")
    with torch.no_grad():
        on_card = model(x, train=False).logits.float().cpu()
    _agree("depth-3 paired model logits", on_card, on_cpu, (8, 100))
    return launches


def check_paired_against_single(mods, teacher, student, aug, kd, images, labels):
    """The paired student against the single-block student on the card, the
    same parameters (a view) and the same drop-path masks: eval logits on 4
    images (also against the CPU plain path), and the flat gradient of the
    soft-KD loss of one batch through both."""
    import torch

    from deltakd_tpu_torch.data.augment import eval_transform
    from deltakd_tpu_torch.kd.losses import total_loss

    single = student.view(block_pair_fn=None)
    x = eval_transform(images[:4], aug).bfloat16()
    with torch.no_grad():
        on_card = student(x, train=False).logits.float().cpu()
        by_single = single(x, train=False).logits.float().cpu()
        on_cpu = copy.deepcopy(student).cpu()(x.cpu(), train=False).logits.float()
    _agree("paired student logits", on_card, on_cpu, (4, student.cfg.num_classes))
    _agree("paired student logits", on_card, by_single, (4, student.cfg.num_classes),
           other="the single-block student on the card")

    batch = eval_transform(images, aug).bfloat16()
    scales = student.draw_drop_scales(B_MAIN, torch.Generator(device="cuda").manual_seed(5),
                                      "cuda")
    with torch.no_grad():
        teacher_logits = teacher(batch, train=False).logits
    targets = torch.nn.functional.one_hot(labels.long(), student.cfg.num_classes).float()
    params = list(student.parameters())
    flat, launches = {}, {}
    for name, model in (("paired", student), ("single", single)):
        _reset_launches(mods)
        out = model(batch, train=True, drop_scales=scales)
        loss, _ = total_loss(kd, student_logits=out.logits, student_dist_logits=out.logits_dist,
                             student_feats=None, teacher_logits=teacher_logits,
                             teacher_feats=None, aux=None, targets=targets, train=True)
        flat[name] = torch.cat([g.reshape(-1).float()
                                for g in torch.autograd.grad(loss, params)])
        torch.cuda.synchronize()
        launches[name] = _read_launches(mods)
    if launches["paired"] != {("fused_pair_fwd", 192): 6, ("fused_pair_bwd", 192): 6} or \
            launches["single"] != {("fused_block_fwd", 192): 12, ("fused_block_bwd", 192): 12}:
        raise AssertionError(f"gradient comparison launches {launches}")
    abs_err, mx = _err(flat["paired"], flat["single"])
    ok = abs_err <= LOGIT_TOL * mx and bool(torch.isfinite(flat["paired"]).all())
    print(f"[reference] soft-KD gradient ({flat['paired'].numel()} values) through the paired "
          f"student vs the single-block student: max_abs_diff {abs_err:.3e}, max |single| "
          f"{mx:.3e} (rel {abs_err / mx:.3e}, tol {LOGIT_TOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the paired student's gradient disagrees with the single-block "
                             "student's")


def _agree(what, on_card, on_cpu, shape=None, other="the CPU plain path"):
    abs_err, mx = _err(on_card, on_cpu)
    ok = abs_err <= LOGIT_TOL * max(mx, 1e-3) and (shape is None
                                                   or tuple(on_card.shape) == shape)
    print(f"[reference] {what} on the card vs {other}: max_abs_err {abs_err:.3e}, "
          f"max |ref| {mx:.3e} (tol {LOGIT_TOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what} on the card disagrees with {other}")


def check_against_cpu(teacher, student, aug, images):
    """Phase 6a: card (kernels) vs CPU (plain path) logits on a small batch."""
    import torch

    from deltakd_tpu_torch.data.augment import eval_transform

    x = eval_transform(images[:4], aug).bfloat16()
    for name, model in (("teacher", teacher), ("student", student)):
        with torch.no_grad():
            on_card = model(x, train=False).logits.float().cpu()
            on_cpu = copy.deepcopy(model).cpu()(x.cpu(), train=False).logits.float()
        _agree(f"{name} logits", on_card, on_cpu, (4, model.cfg.num_classes))


def check_unfused_logits(teacher, student, aug, images):
    """Phase 7c: the unfused path's logits on 4 images against the CPU plain
    path, and against the fused-block path on the card with the same weights
    (a view of the same parameters): two independent kernel routes to the
    same logits."""
    import torch

    from deltakd_tpu_torch.data.augment import eval_transform
    from deltakd_tpu_torch.ops.fused_block import fused_vit_block

    x = eval_transform(images[:4], aug).bfloat16()
    for name, model in (("teacher", teacher), ("student", student)):
        with torch.no_grad():
            on_card = model(x, train=False).logits.float().cpu()
            on_cpu = copy.deepcopy(model).cpu()(x.cpu(), train=False).logits.float()
            fused = model.view(block_fn=fused_vit_block)(x, train=False).logits.float().cpu()
        _agree(f"unfused {name} logits", on_card, on_cpu, (4, model.cfg.num_classes))
        _agree(f"unfused {name} logits", on_card, fused, (4, model.cfg.num_classes),
               other="the fused-block path on the card")


def check_features_against_cpu(teacher, student, aux, aug, kd, images):
    """Phase 6b: the feature path on 4 images, card (kernels) vs CPU (plain
    path): both models' features of blocks 0-2 (the only ones WassKD makes
    them write) and the WassKD distill loss."""
    import torch

    from deltakd_tpu_torch.data.augment import eval_transform
    from deltakd_tpu_torch.kd.losses import wasskd_loss

    x = eval_transform(images[:4], aug).bfloat16()
    feats = {}
    for name, model in (("teacher", teacher), ("student", student)):
        with torch.no_grad():
            on_card = model(x, train=False).features
            on_cpu = copy.deepcopy(model).cpu()(x.cpu(), train=False).features
        written = [i for i, f in enumerate(on_card) if f is not None]
        if written != [0, 1, 2]:
            raise AssertionError(f"{name} wrote the features of blocks {written}, "
                                 f"expected [0, 1, 2]")
        for i in written:
            _agree(f"{name} block {i} features", on_card[i].float().cpu(),
                   on_cpu[i].float(), (4, N_TOK, model.cfg.embed_dim))
        feats[name] = (on_card, on_cpu)
    with torch.no_grad():
        on_card = wasskd_loss(kd, aux, feats["student"][0], feats["teacher"][0]).float().cpu()
        on_cpu = wasskd_loss(kd, copy.deepcopy(aux).cpu(), feats["student"][1],
                             feats["teacher"][1]).float()
    if not (torch.isfinite(on_card) and on_card > 0):
        raise AssertionError(f"wasskd distill loss on the card is {on_card}")
    _agree("wasskd distill loss", on_card, on_cpu, ())


# Planted faults (``--faults``): each is an edit of one kernel source in a
# copy of the package; the copy's checks of that kernel (``--forward-checks``,
# ``--backward-checks``, ``--mlp-checks``, ``--attention-checks`` or
# ``--sort-checks``) must then fail (exit 1).
FAULTS = (
    ("the online rescale left out", "deltakd_tpu_torch/ops/csrc/attention_fwd.cuh",
     (("l[r] *= alpha[r];", "l[r] *= 1.0f;"),
      ("o[i] *= alpha[(i / 2) & 1];", "o[i] *= 1.0f;")), "--forward-checks"),
    ("a padding key left in the sum", "deltakd_tpu_torch/ops/csrc/attention_fwd.cuh",
     (("const float v = key + 8 * (i / 4) + (i & 1) < N ? s[i] * scale_log2 : -INFINITY;",
       "const float v = s[i] * scale_log2;"),), "--forward-checks"),
    ("a wrong head offset in the merged write",
     "deltakd_tpu_torch/ops/csrc/fused_block_common.cuh",
     (("a.o_sh = hd;", "a.o_sh = 0;"),), "--forward-checks"),
    # the consumers read the stage after the one whose barrier they waited on
    # (the ring itself stays in step, so the run ends)
    ("a stage of the ring read before its barrier", "deltakd_tpu_torch/ops/csrc/gemm_sm90.cuh",
     (("sw128_desc(As + stage * BM * BK + wg * 64 * BK)",
       "sw128_desc(As + (stage + 1) % STAGES * BM * BK + wg * 64 * BK)"),), "--forward-checks"),
    ("delta left out of dS", "deltakd_tpu_torch/ops/csrc/attention_bwd.cuh",
     (("sv[e] = pv[e] * (dp[idx] - delta_s[col]);", "sv[e] = pv[e] * dp[idx];"),),
     "--backward-checks"),
    ("the dQ share of key tile 1 added twice", "deltakd_tpu_torch/ops/csrc/attention_bwd.cuh",
     (("v.x += dqi[4 * jb + 2 * hh];", "v.x += (j == 1 ? 2.f : 1.f) * dqi[4 * jb + 2 * hh];"),
      ("v.y += dqi[4 * jb + 2 * hh + 1];",
       "v.y += (j == 1 ? 2.f : 1.f) * dqi[4 * jb + 2 * hh + 1];")), "--backward-checks"),
    ("the last row range of a weight gradient left out of the sum",
     "deltakd_tpu_torch/ops/csrc/fused_block_common.cuh",
     (("partial, splits, (long long)O * I, out);", "partial, splits - 1, (long long)O * I, out);"),),
     "--backward-checks"),
    ("a warp's rows left out of a row kernel's column sums",
     "deltakd_tpu_torch/ops/csrc/fused_block_reverse.cuh",
     (("for (int w = 0; w < ROWS_PER_BLOCK; ++w) s += acc[w * n + i];",
       "for (int w = 1; w < ROWS_PER_BLOCK; ++w) s += acc[w * n + i];"),), "--backward-checks"),
    ("the GELU derivative left out of the fc2 input gradient",
     "deltakd_tpu_torch/ops/csrc/gemm_sm90.cuh",
     (("v0 *= mu.x;", "v0 *= 1.0f;"), ("v1 *= mu.y;", "v1 *= 1.0f;")), "--backward-checks"),
    ("GELU left out of one hidden chunk of the MLP forward",
     "deltakd_tpu_torch/ops/csrc/fused_mlp.cu",
     (("__floats2bfloat162_rn(gelu_rational(v0), gelu_rational(v1));",
       "j == 1 ? __floats2bfloat162_rn(v0, v1) : "
       "__floats2bfloat162_rn(gelu_rational(v0), gelu_rational(v1));"),),
     "--mlp-checks"),
    ("the last row chunk of db2 left out of the MLP backward's sum",
     "deltakd_tpu_torch/ops/csrc/fused_mlp.cu",
     (("reduce_chunks(g.col_partial, chunks, D, (float*)db2, st);",
       "reduce_chunks(g.col_partial, chunks - 1, D, (float*)db2, st);"),), "--mlp-checks"),
    # flash_bwd hands the unscaled q to the block's attention backward
    ("flash's score scale left out of the exponent", "deltakd_tpu_torch/ops/csrc/attention_bwd.cuh",
     (("const float s_log2e = p.scale * LOG2E;", "const float s_log2e = LOG2E;"),),
     "--attention-checks"),
    ("flash's score scale left out of dK", "deltakd_tpu_torch/ops/csrc/attention_bwd.cuh",
     (("for (int i = 0; i < 32; ++i) dk[i] *= p.scale;",
       "for (int i = 0; i < 32; ++i) dk[i] *= 1.0f;"),), "--attention-checks"),
    ("the row index left out of the packed s key", "deltakd_tpu_torch/ops/csrc/sort.cu",
     (("return (image << 16) | (uint32_t)row;", "return image << 16;"),), "--sort-checks"),
    # the exchange with lane ^ 8 keeps each key where it is (sorted_l1's s
    # keys and fp32 t keys, the value sort's fp32 and int32 keys; the 16-bit
    # pairs have a network of their own)
    ("one shuffle stage of the key network skipped", "deltakd_tpu_torch/ops/csrc/sort.cu",
     (("const K o = __shfl_xor_sync(0xffffffffu, v[r], J / R);",
       "const K o = J == 8 * R ? v[r] : __shfl_xor_sync(0xffffffffu, v[r], J / R);"),),
     "--sort-checks"),
    # the 16-bit pairs (the value sort's bf16 and fp16 keys, sorted_l1's bf16
    # t) exchange with lane ^ 9 where the stage's partner is lane ^ 8
    ("a wrong partner lane in one shuffle stage of the pair network",
     "deltakd_tpu_torch/ops/csrc/sort.cu",
     (("const uint32_t o = __shfl_xor_sync(0xffffffffu, w[i], J / R);",
       "const uint32_t o = __shfl_xor_sync(0xffffffffu, w[i], J == 8 * R ? J / R ^ 1 : J / R);"),),
     "--sort-checks"),
)


def run_faults() -> int:
    """For each planted fault: a copy of the package and this script under
    .scratch/faults/ (ignored by git), the edit, then ``chip_smoke.py`` with
    the fault's check mode in the copy, which must exit 1. Returns 0 when
    every fault failed its run."""
    import shutil

    root = os.path.dirname(os.path.abspath(__file__))
    caught = []
    for i, (name, rel, edits, checks) in enumerate(FAULTS):
        copy = os.path.join(root, ".scratch", "faults", str(i))
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(os.path.join(root, "deltakd_tpu_torch"),
                        os.path.join(copy, "deltakd_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy2(os.path.abspath(__file__), copy)
        path = os.path.join(copy, rel)
        with open(path) as f:
            text = f.read()
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"fault '{name}': its edit no longer applies to {rel}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "chip_smoke.py", checks], cwd=copy,
                              capture_output=True, text=True, timeout=300)
        first = ([line for line in proc.stdout.splitlines() if "FAIL" in line]
                 or proc.stderr.strip().splitlines()[-1:] or ["(none)"])[0]
        print(f"[fault] {name}: exit {proc.returncode} after {time.perf_counter() - t0:.1f} s; "
              f"first failure: {first}")
        caught.append(proc.returncode == 1)
        shutil.rmtree(copy)
    print(f"[fault] {sum(caught)} of {len(FAULTS)} planted faults failed their run")
    return 0 if all(caught) else 1


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 1
    if "--faults" in sys.argv[1:]:
        return run_faults()
    forward_checks = "--forward-checks" in sys.argv[1:]
    backward_checks = "--backward-checks" in sys.argv[1:]
    mlp_checks = "--mlp-checks" in sys.argv[1:]
    attention_checks = "--attention-checks" in sys.argv[1:]
    sort_checks = "--sort-checks" in sys.argv[1:]
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deltakd_tpu_torch.ops import _build
    from deltakd_tpu_torch.ops import attention as at
    from deltakd_tpu_torch.ops import fused_block as fb
    from deltakd_tpu_torch.ops import fused_mlp as fm
    from deltakd_tpu_torch.ops import sort as so

    mods = (fb, so, at, fm)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = _build.build(["fused_block_fwd", "attention"] if forward_checks else
                        ["fused_block_fwd", "fused_block_bwd", "fused_block_pair"]
                        if backward_checks else ["fused_mlp"] if mlp_checks else
                        ["attention"] if attention_checks else ["sort"] if sort_checks
                        else _build.SOURCES)
    print(f"[build] sources {list(_build.SOURCES)}, compiled {sorted(logs)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for kernel, regs, spill in _ptxas_summary(log):
            print(f"[build] {name}: {kernel}: {regs}{'; ' + spill if spill else ''}")

    worst = {}
    if forward_checks:   # a planted-fault copy: the checks of the redesigned forward only
        check_block_forward_shapes(fb, worst)
        check_linear(fb, worst)
        check_attention_kernels(at, worst)
        return 0
    if backward_checks:  # a planted-fault copy: the checks of the redesigned backward only
        check_block_backward_shapes(fb, worst)
        check_backward_gemms(fb, worst, timed=False)
        return 0
    if mlp_checks:       # a planted-fault copy: the checks of the MLP kernels only
        check_mlp_kernels(fm, worst)
        return 0
    if attention_checks:  # a planted-fault copy: flash_fwd's and flash_bwd's checks only
        check_attention_kernels(at, worst)
        return 0
    if sort_checks:      # a planted-fault copy: the sort kernels' checks only
        check_sort_kernels(so, worst)
        return 0
    check_kernels(fb, worst)
    check_block_forward_shapes(fb, worst)
    check_block_backward_shapes(fb, worst)
    check_linear(fb, worst)
    check_backward_gemms(fb, worst)
    print_forward_workspace(fb)
    print_backward_workspace(fb)
    timing = time_kernels(fb, worst)
    check_sort_kernels(so, worst)
    timing.update(time_sort_kernels(so))
    check_attention_kernels(at, worst)
    timing.update(time_attention_kernels(at))
    check_mlp_kernels(fm, worst)
    print_mlp_backward_workspace(fm)
    timing.update(time_mlp_kernels(fb, fm))
    time_mlp_widths(fm)
    check_pair_kernels(fb, worst)
    check_pair_cotangent_fp32(fb)
    timing.update(time_pair_kernels(fb))
    torch.cuda.empty_cache()

    by_path, step_ms = {}, {}
    for kd_type, steps in PATHS:
        by_path[kd_type], step_ms[kd_type], kept = run_train_path(mods, kd_type, steps)
        teacher, student, aux, aug, kd, images, labels = kept
        if kd_type == "soft":
            by_path["eval"] = run_eval(mods, student, aug, images, labels,
                                       {("fused_block_fwd", 192): 12})
            check_against_cpu(teacher, student, aug, images)
        elif kd_type == "wasskd":
            check_features_against_cpu(teacher, student, aux, aug, kd, images)
        del teacher, student, aux, kept
        torch.cuda.empty_cache()
    by_path["value_sort"] = run_value_sort(so)

    # the train-time data path, then the recipe's soft step with its teacher
    # imported from a checkpoint
    aug_ms = check_augment()
    torch.cuda.empty_cache()
    by_path["soft recipe"], step_ms["soft recipe"], kept = run_recipe_path(mods)
    del kept
    torch.cuda.empty_cache()
    plain_ms = aug_ms["aa='' bf16 32px"]["ms"]
    ra = aug_ms["RA bf16 32px"]
    print(f"[recipe] soft recipe step {step_ms['soft recipe']:.2f} ms beside the aa='' soft "
          f"step {step_ms['soft']:.2f} ms; the transform alone {ra['ms']:.3f} ms a batch on "
          f"the card, {ra['host_ms']:.3f} on the host's clock (aa='': {plain_ms:.3f}), mixup "
          f"{aug_ms['mixup batch']['ms']:.3f}")

    # the unfused model path: its train steps, its eval batch on the eval view
    by_path["unfused_soft"], step_ms["unfused soft"], kept = run_train_path(
        mods, "soft", UNFUSED_STEPS, unfused=True)
    teacher, student, _, aug, _, images, labels = kept
    by_path["unfused_eval"] = run_eval(
        mods, student.view(mlp_fn=fm.fused_mlp, collect_features=False), aug, images, labels,
        {("flash_fwd", ATTN_MAIN["student"]): 12, ("fused_mlp_fwd", MLP_MAIN["student"]): 12},
        name="unfused eval")
    check_unfused_logits(teacher, student, aug, images)
    del teacher, student, kept
    torch.cuda.empty_cache()
    by_path["fused_mlp_train"] = run_mlp_train(mods, fm)
    by_path["no_qkv_bias"] = run_no_qkv_bias(mods, images, aug)

    # the block-pair path: the student's blocks two per kernel
    for kd_type, steps in PAIRED_PATHS:
        name = f"paired {kd_type}"
        by_path[name], step_ms[name], kept = run_train_path(mods, kd_type, steps, paired=True)
        teacher, student, aux, aug, kd, images, labels = kept
        if kd_type == "soft":
            by_path["paired_eval"] = run_eval(
                mods, student.view(block_pair_fn=None, collect_features=False), aug, images,
                labels, {("fused_block_fwd", 192): 12}, name="paired eval")
            check_paired_against_single(mods, teacher, student, aug, kd, images, labels)
        del teacher, student, aux, kept
        torch.cuda.empty_cache()
    by_path["odd_depth_pair"] = run_odd_depth_pair(mods, images, aug)
    print("[slice] step ms by path: "
          + ", ".join(f"{k} {v:.2f}" for k, v in step_ms.items()))

    csrc = "deltakd_tpu_torch/ops/csrc/"
    src = {"fused_block_fwd": (csrc + "fused_block_fwd.cu", "deltakd_tpu/ops/fused_block.py:313"),
           "fused_block_bwd": (csrc + "fused_block_bwd.cu", "deltakd_tpu/ops/fused_block.py:478"),
           "fused_pair_fwd": (csrc + "fused_block_pair.cu", "deltakd_tpu/ops/fused_block.py:929"),
           "fused_pair_bwd": (csrc + "fused_block_pair.cu", "deltakd_tpu/ops/fused_block.py:982"),
           "bitonic_sort": (csrc + "sort.cu", "deltakd_tpu/ops/sort.py:83"),
           "sorted_l1_fwd": (csrc + "sort.cu", "deltakd_tpu/ops/sort.py:317"),
           "sorted_l1_bwd": (csrc + "sort.cu", "deltakd_tpu/ops/sort.py:338"),
           "flash_fwd": (csrc + "attention.cu", "deltakd_tpu/ops/attention.py:46"),
           "flash_bwd": (csrc + "attention.cu", "deltakd_tpu/ops/attention.py:62"),
           "fused_mlp_fwd": (csrc + "fused_mlp.cu", "deltakd_tpu/ops/fused_mlp.py:50"),
           "fused_mlp_bwd": (csrc + "fused_mlp.cu", "deltakd_tpu/ops/fused_mlp.py:126")}
    teacher_keys = (384, ATTN_MAIN["teacher"])
    kernels = []
    for key, row in timing.items():
        kernel = key[0] if isinstance(key, tuple) else key
        name = kernel
        if isinstance(key, tuple):
            what = "D" if key[1] in MLP_MAIN.values() else "BH"
            name = (f"{kernel}[{'teacher' if key[1] in teacher_keys else 'student'} "
                    f"{what}={key[1]}]")
        launched = {path: n[key] for path, n in by_path.items() if n.get(key)}
        if not launched:
            raise AssertionError(f"{name} was launched on no driven path")
        # the row's own checks at the main shape, and the kernel's at small shapes
        max_abs_err = max(worst[key], worst.get(kernel, 0.0))
        kernels.append({"name": name, "route": "cuda", "source": src[kernel][0],
                        "replaces": src[kernel][1], "launches": sum(launched.values()),
                        "launches_by_path": launched, "max_abs_err": max_abs_err, **row})
    if {k["source"] for k in kernels} != {csrc + f"{n}.cu" for n in _build.SOURCES}:
        raise AssertionError("a built source has no kernel in the report")
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
