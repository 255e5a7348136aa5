#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (deltakd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from deltakd_tpu_torch/ops/csrc with nvcc;
  3. holds each kernel against its plain PyTorch version on the card, for the
     student (D=192) and teacher (D=384) widths, with and without the feature
     output, with drop-path scales of 0 and 1/keep, at B=8; then holds each
     kernel against its plain version again at the main-path shape (B=256,
     N=198) and times it there beside its plain version, its bound and the
     same block built from PyTorch library calls;
  4. runs the soft-KD train step at the bench configuration (DeiT-Small-
     distilled teacher, DeiT-Tiny-distilled student, 224 px, batch 256, random
     weights from a seed), checking the kernel launches of every step, finite
     losses and changed parameters; then one eval batch;
  5. checks that the models' logits on the card agree with the plain path on
     the CPU for a small batch.
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
LOGIT_TOL = 5e-2      # logits, card kernels vs CPU plain path, same formula
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
STEPS = 6


def _timed(fn, iters, warmup=1):
    """Mean ms per call on CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _err(a, b):
    a, b = a.float(), b.float()
    mx = b.abs().max().item()
    return (a - b).abs().max().item(), mx


def _block_inputs(D, H, B, seed, device):
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
    x = r(B, N_TOK, D, sc=1.0).to(device).bfloat16()
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
        g_out = torch.randn_like(x)
        if kernel == "fused_block_fwd":
            out, feat = fb.kernel_block_fwd(x, p, need_features=True, **kw)
            r_out, r_feat = fb.reference_vit_block(x, p, **kw)
            checks = [("out", out, r_out), ("feat", feat, r_feat)]
        else:
            dx, dws = fb.kernel_block_bwd(x, p, g_out, None, **kw)
            r_dx, r_dws = fb.reference_vit_block_bwd(x, p, g_out, None, **kw)
            checks = [("dx", dx, r_dx)] + [("d" + n, dws[n], r_dws[n])
                                           for n in fb.PARAM_NAMES]
        torch.cuda.synchronize()
        _hold(worst, f"B={B_MAIN}", kernel, D, x, checks)
        lib_w = [t.detach().bfloat16().requires_grad_(kernel == "fused_block_bwd")
                 for t in fb.block_params(p)]
        x_lib = x.detach().requires_grad_(kernel == "fused_block_bwd")

        def lib_fwd():
            with torch.no_grad():
                _library_block(x_lib, lib_w, H, 1e-6, sa, sm)

        if kernel == "fused_block_fwd":
            ms = _timed(lambda: fb.kernel_block_fwd(x, p, need_features=False, **kw), 10)
            plain_ms = _timed(lambda: fb.reference_vit_block(x, p, **kw), 3)
            library_ms = _timed(lib_fwd, 10)
        else:
            ms = _timed(lambda: fb.kernel_block_bwd(x, p, g_out, None, **kw), 10)
            plain_ms = _timed(lambda: fb.reference_vit_block_bwd(x, p, g_out, None, **kw), 3)

            def lib_fwd_bwd():
                _library_block(x_lib, lib_w, H, 1e-6, sa, sm).backward(g_out)

            library_ms = _timed(lib_fwd_bwd, 10) - _timed(lib_fwd, 10)
        B, N = B_MAIN, N_TOK
        flops = B * (24 * N * D * D + 4 * N * N * D)
        weight_bytes = 12 * D * D * 2
        nbytes = 2 * B * N * D * 2 + weight_bytes
        if kernel == "fused_block_bwd":
            flops *= 3    # the recompute plus two products per forward product
            nbytes = 3 * B * N * D * 2 + weight_bytes + 12 * D * D * 4
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        rows[(kernel, D)] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes")
        print(f"[time] {kernel} D={D} B={B}: {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"library {library_ms:.3f} ms, bound {rows[(kernel, D)]['bound_ms']:.4f} ms "
              f"({rows[(kernel, D)]['bound_by']})")
    return rows


def run_slice(fb):
    """Phase 4: the soft-KD train step at full width, then one eval batch.
    Returns (train launches, models)."""
    import numpy as np
    import torch

    from deltakd_tpu_torch.configs.config import TrainConfig
    from deltakd_tpu_torch.data.augment import AugmentConfig
    from deltakd_tpu_torch.data.mixup import MixupConfig
    from deltakd_tpu_torch.kd.losses import KDSettings
    from deltakd_tpu_torch.models.factory import load_teacher_student
    from deltakd_tpu_torch.train.optim import make_optimizer
    from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
    from deltakd_tpu_torch.train.step import build_eval_step, build_train_step

    cfg = TrainConfig(teacher_model="deit_small_distilled_patch16_224",
                      student_model="deit_tiny_distilled_patch16_224",
                      batch_size=B_MAIN, distillation_type="soft", dataset="cifar-100",
                      input_size=224, dtype="bfloat16", drop_path_rate=0.1, epochs=300,
                      aug_pixel_bf16=True, aa="", color_jitter=0.0,
                      allow_random_teacher=True)
    teacher, student = load_teacher_student(cfg, seed=0, device="cuda")
    num_classes = student.cfg.num_classes
    tx = make_optimizer(cfg, trainable_parameters(student), 100)
    state = TrainState(student, tx=tx)
    aug = AugmentConfig.from_config(cfg)
    step = build_train_step(cfg=cfg, kd=KDSettings.from_config(cfg), student=student,
                            teacher=teacher, aug=aug,
                            mixup=MixupConfig.from_config(cfg, num_classes), tx=tx)
    host = np.random.RandomState(0)
    images = torch.from_numpy(host.randint(0, 256, (B_MAIN, 32, 32, 3), dtype=np.uint8)).cuda()
    labels = torch.from_numpy(host.randint(0, num_classes, (B_MAIN,))).cuda()
    gen = torch.Generator(device="cuda").manual_seed(4)
    params0 = state.params.clone()

    torch.cuda.synchronize()
    fb.reset_launches()
    times, metrics = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        m = step(state, images, labels, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = dict(fb.LAUNCHES)
    print(f"[slice] launches over {STEPS} steps: {launches}")
    expect = {("fused_block_fwd", 384): 12 * STEPS, ("fused_block_fwd", 192): 12 * STEPS,
              ("fused_block_bwd", 192): 12 * STEPS}
    if launches != expect:
        raise AssertionError(f"kernel launches {launches}, expected {expect} "
                             f"(24 forward and 12 backward per step)")
    for i, m in enumerate(metrics):
        print(f"[slice] step {i}: " + " ".join(f"{k}={v:.5g}" for k, v in m.items())
              + f" time={times[i] * 1e3:.1f} ms")
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite metrics at step {i}: {m}")
    changed = (state.params - params0).abs().max().item()
    if not changed > 0:
        raise AssertionError("the parameters did not change")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    print(f"[slice] step time (median of steps 1-{STEPS - 1}) {steady * 1e3:.2f} ms, "
          f"{B_MAIN / steady:.1f} images/s; max |param change| {changed:.3e}")

    eval_step = build_eval_step(student=student, aug=aug)
    torch.cuda.synchronize()
    fb.reset_launches()
    sums = {k: float(v) for k, v in eval_step(images, labels, B_MAIN).items()}
    torch.cuda.synchronize()
    eval_launches = dict(fb.LAUNCHES)
    print(f"[eval] {sums}; launches {eval_launches}")
    if eval_launches != {("fused_block_fwd", 192): 12}:
        raise AssertionError(f"eval launches {eval_launches}, expected 12 forward")
    if sums["count"] != B_MAIN or not all(math.isfinite(v) for v in sums.values()):
        raise AssertionError(f"bad eval sums {sums}")
    return launches, teacher, student, aug, images


def check_against_cpu(teacher, student, aug, images):
    """Phase 5: card (kernels) vs CPU (plain path) logits on a small batch."""
    import torch

    from deltakd_tpu_torch.data.augment import eval_transform

    x = eval_transform(images[:4], aug).bfloat16()
    for name, model in (("teacher", teacher), ("student", student)):
        with torch.no_grad():
            on_card = model(x, train=False).logits.float().cpu()
            on_cpu = copy.deepcopy(model).cpu()(x.cpu(), train=False).logits.float()
        abs_err, mx = _err(on_card, on_cpu)
        ok = on_card.shape == (4, model.cfg.num_classes) and abs_err <= LOGIT_TOL * max(mx, 1e-3)
        print(f"[reference] {name} logits card vs CPU plain path: max_abs_err "
              f"{abs_err:.3e}, max |logit| {mx:.3e} (tol {LOGIT_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} logits on the card disagree with the CPU path")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deltakd_tpu_torch.ops import _build
    from deltakd_tpu_torch.ops import fused_block as fb

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[build] {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or ("spill" in line and "0 bytes spill stores, 0 bytes"
                                       not in line):
                print(f"[build] {name}: {line.strip()}")

    worst = {}
    check_kernels(fb, worst)
    timing = time_kernels(fb, worst)
    launches, teacher, student, aug, images = run_slice(fb)
    check_against_cpu(teacher, student, aug, images)

    src = {"fused_block_fwd": ("deltakd_tpu_torch/ops/csrc/fused_block_fwd.cu",
                               "deltakd_tpu/ops/fused_block.py:313"),
           "fused_block_bwd": ("deltakd_tpu_torch/ops/csrc/fused_block_bwd.cu",
                               "deltakd_tpu/ops/fused_block.py:478")}
    kernels = []
    for (kernel, D), row in timing.items():
        who = "teacher" if D == 384 else "student"
        kernels.append({"name": f"{kernel}[{who} D={D}]", "route": "cuda",
                        "source": src[kernel][0], "replaces": src[kernel][1],
                        "launches": launches.get((kernel, D), 0),
                        "max_abs_err": worst[(kernel, D)], **row})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
