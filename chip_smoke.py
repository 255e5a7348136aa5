#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (deltakd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from deltakd_tpu_torch/ops/csrc with nvcc (one
     nvcc per source, all started together);
  3. holds each fused-block kernel against its plain PyTorch version on the
     card, for the student (D=192) and teacher (D=384) widths, with and
     without the feature output, with drop-path scales of 0 and 1/keep, at
     B=8; then again at the main-path shape (B=256, N=198), where it times it
     beside its plain version, its bound and the same block built from
     PyTorch library calls;
  4. holds the sort kernels (value sort, sorted_l1 forward and backward)
     against their plain versions on inputs with ties, in bf16 and fp32, at
     B=8 (n=196, a power-of-two n, a d that is no multiple of the column
     tile) and at the main-path shape [256, 196, 384]: sorted values, signs
     and gradients exactly, the loss to 1e-5, t's gradient zero, two runs the
     same bits; then times them at the main-path shape in bf16;
  5. runs train steps at full width (DeiT-Small-distilled teacher, DeiT-Tiny-
     distilled student, 224 px, batch 256, random weights from a seed) for
     soft KD, WassKD-l1, MGD and ViTKD, each path with the launch counts set
     to 0 just before and read just after, checking the kernel launches,
     finite metrics, a positive distill loss and changed student (and aux)
     parameters; one eval batch; and the value sort through its public
     function (no model calls it);
  6. checks on 4 images that the card agrees with the plain path on the CPU:
     both models' logits, and for the feature path the features of blocks
     0-2 and the WassKD distill loss.
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
LOSS_TOL = 1e-5       # sorted_l1 loss, kernel vs plain, relative (fp32 sums in
#                       another order); sorted values, signs, gradients: exact
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16
PEAK_FP32_OPS = 67e12      # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
SORT_MAIN = (B_MAIN, 196, 384)   # one WassKD layer: patch tokens x teacher width
# train steps per distillation type, in the order they run
PATHS = (("soft", 3), ("wasskd", 4), ("mgd", 2), ("vitkd", 2))


def _timed(fn, iters, warmup=3):
    """Median ms of ``iters`` calls, each between its own pair of CUDA events,
    after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for e0, e1 in events:
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    times = sorted(e0.elapsed_time(e1) for e0, e1 in events)
    return times[len(times) // 2]


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
              f"({rows[(kernel, D)]['bound_by']}){extra}")
    return rows


def _sort_inputs(shape, dtype, seed):
    """s, t on the card with ties: a normal draw rounded to bf16 (many equal
    values in a column of 196), a few exact duplicate rows inside s, and a few
    positions where s equals t; in fp32 a quarter of the rows of s is left
    unrounded."""
    import torch

    g = torch.Generator().manual_seed(seed)
    s = torch.randn(shape, generator=g).bfloat16().to(dtype)
    t = torch.randn(shape, generator=g).bfloat16().to(dtype)
    n = shape[1]
    if dtype == torch.float32:     # and keys that need all 32 bits
        s[:, n // 4: n // 2] = torch.randn(s[:, n // 4: n // 2].shape, generator=g)
    s[:, 1] = s[:, 0]
    s[:, n - 1] = s[:, n // 2]
    t[:, : max(1, n // 8)] = s[:, : max(1, n // 8)]
    return s.cuda(), t.cuda()


def _hold_sort(so, worst, shape, dtype):
    """Fails unless the three sort kernels agree with their plain versions on
    one input: sorted values, signs and gradient exactly, the loss within
    LOSS_TOL, t's gradient zero, and a second run gives the same bits."""
    import torch

    s, t = _sort_inputs(shape, dtype, shape[1] + shape[2])
    tag = f"{tuple(shape)} {str(dtype).split('.')[-1]}"
    ties = (torch.sort(s, dim=1).values.diff(dim=1) == 0).sum().item()
    if ties == 0:
        raise AssertionError(f"sort check {tag}: the input has no ties")

    out = so.bitonic_sort_kernel(s)
    ref = torch.sort(s, dim=1).values
    sort_err = (out.float() - ref.float()).abs().max().item()

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
        ("sorted values equal torch.sort", torch.equal(out, ref)),
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
    for kernel, err in (("bitonic_sort", sort_err), ("sorted_l1_fwd", loss_err),
                        ("sorted_l1_bwd", grad_err)):
        worst[kernel] = max(worst.get(kernel, 0.0), err)


def check_sort_kernels(so, worst):
    """Phase 4a: the sort kernels vs their plain versions, small shapes and
    the main-path shape, bf16 and fp32."""
    import torch

    for dtype in (torch.bfloat16, torch.float32):
        for shape in ((B_CHECK, 196, 384), (B_CHECK, 256, 384), (B_CHECK, 196, 100),
                      SORT_MAIN):
            _hold_sort(so, worst, shape, dtype)


def time_sort_kernels(so):
    """Phase 4b: the sort kernels at the main-path shape in bf16: kernel,
    plain and library times, and the bound. Library: torch.sort(dim=1,
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
    for kernel, row in rows.items():
        t_bytes, t_ops = row.pop("nbytes") / PEAK_BYTES, row.pop("ops") / PEAK_FP32_OPS
        row["bound_ms"] = max(t_bytes, t_ops) * 1e3
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        print(f"[time] {kernel} {SORT_MAIN} bf16: {row['ms']:.3f} ms, plain "
              f"{row['plain_ms']:.3f} ms, library {row['library_ms']:.3f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    print(f"[time] sorted_l1 library forward+backward {lib_both:.3f} ms, forward {lib_f:.3f} ms")
    return rows


def _block_launches(steps):
    return {("fused_block_fwd", 384): 12 * steps, ("fused_block_fwd", 192): 12 * steps,
            ("fused_block_bwd", 192): 12 * steps}


def run_train_path(fb, so, kd_type, steps):
    """Phase 5: ``steps`` train steps of one distillation type at full width
    through load_teacher_student -> TrainState -> build_train_step. The launch
    counts are set to 0 just before the steps and read just after. Returns
    (launches, step ms, what the later phases need)."""
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

    cfg = TrainConfig(teacher_model="deit_small_distilled_patch16_224",
                      student_model="deit_tiny_distilled_patch16_224",
                      batch_size=B_MAIN, distillation_type=kd_type, dataset="cifar-100",
                      input_size=224, dtype="bfloat16", drop_path_rate=0.1, epochs=300,
                      aug_pixel_bf16=True, aa="", color_jitter=0.0,
                      allow_random_teacher=True)
    teacher, student, aux = load_teacher_student(cfg, seed=0, device="cuda")
    num_classes = student.cfg.num_classes
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
    fb.reset_launches()
    so.reset_launches()
    times, metrics = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = step(state, images, labels, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = {**fb.LAUNCHES, **so.LAUNCHES}
    print(f"[{kd_type}] launches over {steps} steps: {launches}")
    expect = _block_launches(steps)
    if kd_type == "wasskd":
        expect.update(sorted_l1_fwd=3 * steps, sorted_l1_bwd=3 * steps)
    if launches != expect:
        raise AssertionError(f"{kd_type}: kernel launches {launches}, expected {expect}")
    for i, m in enumerate(metrics):
        print(f"[{kd_type}] step {i}: " + " ".join(f"{k}={v:.5g}" for k, v in m.items())
              + f" time={times[i] * 1e3:.1f} ms")
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"{kd_type}: non-finite metrics at step {i}: {m}")
        if kd_type != "soft" and not m["distill_loss"] > 0:
            raise AssertionError(f"{kd_type}: distill_loss {m['distill_loss']} at step {i}")
    delta = (state.params - params0).abs()
    changed = {"student": delta[:n_student].max().item()}
    if aux is not None:
        changed["aux"] = delta[n_student:].max().item()
    if not all(v > 0 for v in changed.values()):
        raise AssertionError(f"{kd_type}: parameters did not change: {changed}")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    print(f"[{kd_type}] step time (median of steps 1-{steps - 1}) {steady * 1e3:.2f} ms, "
          f"{B_MAIN / steady:.1f} images/s; max |param change| {changed}")
    return launches, steady * 1e3, (teacher, student, aux, aug, kd, images, labels)


def run_eval(fb, student, aug, images, labels):
    """One eval batch through build_eval_step: 12 forward launches."""
    import torch

    from deltakd_tpu_torch.train.step import build_eval_step

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


def run_value_sort(so):
    """The value sort through its public function, at the main-path shape in
    both dtypes (no model calls it, in the JAX package either)."""
    import torch

    so.reset_launches()
    for dtype in (torch.bfloat16, torch.float32):
        x, _ = _sort_inputs(SORT_MAIN, dtype, 2)
        out = so.bitonic_sort(x, axis=1)
        torch.cuda.synchronize()
        if not torch.equal(out, torch.sort(x, dim=1).values):
            raise AssertionError(f"bitonic_sort {dtype} disagrees with torch.sort")
    launches = dict(so.LAUNCHES)
    print(f"[value sort] launches {launches}")
    if launches != {"bitonic_sort": 2}:
        raise AssertionError(f"value sort launches {launches}, expected 2")
    return launches


def _agree(what, on_card, on_cpu, shape=None):
    abs_err, mx = _err(on_card, on_cpu)
    ok = abs_err <= LOGIT_TOL * max(mx, 1e-3) and (shape is None
                                                   or tuple(on_card.shape) == shape)
    print(f"[reference] {what} card vs CPU plain path: max_abs_err {abs_err:.3e}, "
          f"max |ref| {mx:.3e} (tol {LOGIT_TOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what} on the card disagrees with the CPU path")


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deltakd_tpu_torch.ops import _build
    from deltakd_tpu_torch.ops import fused_block as fb
    from deltakd_tpu_torch.ops import sort as so

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[build] sources {list(_build.SOURCES)}, compiled {sorted(logs)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or ("spill" in line and "0 bytes spill stores, 0 bytes"
                                       not in line):
                print(f"[build] {name}: {line.strip()}")

    worst = {}
    check_kernels(fb, worst)
    timing = time_kernels(fb, worst)
    check_sort_kernels(so, worst)
    timing.update(time_sort_kernels(so))

    by_path, step_ms = {}, {}
    for kd_type, steps in PATHS:
        by_path[kd_type], step_ms[kd_type], kept = run_train_path(fb, so, kd_type, steps)
        teacher, student, aux, aug, kd, images, labels = kept
        if kd_type == "soft":
            run_eval(fb, student, aug, images, labels)
            check_against_cpu(teacher, student, aug, images)
        elif kd_type == "wasskd":
            check_features_against_cpu(teacher, student, aux, aug, kd, images)
        del teacher, student, aux, kept
        torch.cuda.empty_cache()
    by_path["value_sort"] = run_value_sort(so)
    print("[slice] step ms by path: "
          + ", ".join(f"{k} {v:.2f}" for k, v in step_ms.items()))

    csrc = "deltakd_tpu_torch/ops/csrc/"
    src = {"fused_block_fwd": (csrc + "fused_block_fwd.cu", "deltakd_tpu/ops/fused_block.py:313"),
           "fused_block_bwd": (csrc + "fused_block_bwd.cu", "deltakd_tpu/ops/fused_block.py:478"),
           "bitonic_sort": (csrc + "sort.cu", "deltakd_tpu/ops/sort.py:83"),
           "sorted_l1_fwd": (csrc + "sort.cu", "deltakd_tpu/ops/sort.py:317"),
           "sorted_l1_bwd": (csrc + "sort.cu", "deltakd_tpu/ops/sort.py:338")}
    kernels = []
    for key, row in timing.items():
        kernel = key[0] if isinstance(key, tuple) else key
        name = kernel
        if isinstance(key, tuple):
            name = f"{kernel}[{'teacher' if key[1] == 384 else 'student'} D={key[1]}]"
        launched = {path: n[key] for path, n in by_path.items() if n.get(key)}
        if not launched:
            raise AssertionError(f"{name} was launched on no driven path")
        kernels.append({"name": name, "route": "cuda", "source": src[kernel][0],
                        "replaces": src[kernel][1], "launches": sum(launched.values()),
                        "launches_by_path": launched, "max_abs_err": worst[key], **row})
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
