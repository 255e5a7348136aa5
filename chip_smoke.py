#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (deltakd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                    # the run below, on one card
    python3 chip_smoke.py --faults           # the planted faults (FAULTS), each in a copy
    python3 chip_smoke.py --faults --dp-checks  # only the faults of one check mode
    python3 chip_smoke.py --forward-checks   # only the forward's checks (phase 3a, 3b, 5a)
    python3 chip_smoke.py --backward-checks  # only the backward's checks (phase 3c, 3d)
    python3 chip_smoke.py --mlp-checks       # only the fused-MLP kernels' checks (phase 5c)
    python3 chip_smoke.py --attention-checks # only flash_fwd's and flash_bwd's checks (phase 5a)
    python3 chip_smoke.py --sort-checks      # only the sort kernels' checks (phase 4a)
    python3 chip_smoke.py --dp-checks        # only the data-parallel step's checks (phase 12a)
    python3 chip_smoke.py --tp-checks        # only the tensor-parallel checks (phase 15)
    python3 chip_smoke.py --fp32-checks      # only the fp32 forms' checks at B=8 (phase 13a, 13b,
                                             # 14a) and the optimizers' (14d, first half)
    python3 chip_smoke.py --fp32-checks --seeds 8  # ... the block, MLP and pair checks on 8 draws
    python3 chip_smoke.py --learning-checks  # only phase 16 (--seeds N: 16a, 16b at N seeds)
    python3 chip_smoke.py --outcome-checks   # only phase 17 (--seeds N: 17b at N seeds)
    python3 chip_smoke.py --long-sequence-checks  # only phase 18 (448 px and up)
    python3 chip_smoke.py --past-limit-checks     # only phase 18d's holds and bits
    python3 chip_smoke.py --faults --backward-checks --run-as --learning-checks
                                             # diagnostic: the backward's faults under
                                             # phase 16 (which of them it catches alone)

Phases, each of which fails the run:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from deltakd_tpu_torch/ops/csrc with nvcc (one
     nvcc per source, all started together);
  3. holds each fused-block kernel against its plain PyTorch version on the
     card, for the student (D=192) and teacher (D=384) widths, with and
     without the feature output, with drop-path scales of 0 and 1/keep, at
     B=8; the forward and the backward also at N = 50, 197, 198 and 578 for
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
     N=656 (these two on the backward's split route), through the autograd
     Function on strided views of a packed qkv projection, and at the
     main-path shapes
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
     parameters; one eval batch; then the objectives of the recipes that
     PATHS leaves out, each in its exp/*.sh configuration (OBJECTIVE_PATHS:
     WassKD-sinkhorn, Saliency-MGD method 1, LRKD rank 32, DiffKD, CurKD at
     epochs 0, 120 and 200, hard KD; the DeiT-Ti without a distillation
     token, N = 197, but for hard; weight decay 1e-4), 2 steps each (CurKD
     3) with the same launch, metric and parameter checks and the peak of
     allocated memory, and each objective on 4 images card against CPU
     (6c): the features the objective makes the kernels write, then its
     distill loss and feature gradients on the same fp32 features with the
     draws pinned on both sides (LRKD's targets held to their invariants,
     Saliency-MGD's scores to a tolerance, each then pinned to the card's;
     the Sinkhorn divergence also with TF32 on, the same bits); 6d: LRKD's
     rank_k_targets on a planted spectrum at [50176, 384], both solvers, card
     against CPU, the batched eigh and the subspace solver timed, and the
     Sinkhorn potential solve and divergence timed at [768, 196, 384]; and
     the value sort through its public
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
     (`[profile] soft recipe step by part`; the aa='' soft step's too);
 11. the runtime: run() and the CLIs (deltakd_tpu_torch.cli.train.main and
     cli.eval.main) with the flags of the port's exp/*.sh copies (each recipe
     run by bash with a stub `python` that records its arguments; --epochs,
     --save-dir and the like appended through EXTRA_FLAGS), phase 10's teacher
     checkpoint and CIFAR-100 pickles written here (4096 train and 1000 test
     images at 32 px: 16 steps of 256, 4 eval batches, the last one padded):
     11a soft-deit-tiny.sh for 2 epochs: 12 + 12 block forwards and 12 block
     backwards each train step, 12 block forwards each eval batch, finite
     metrics, the checkpoint layout and meta.json, and the host syncs of epoch
     0 under torch.cuda's sync debug mode, of which the loop's own (those
     outside the steps) must be the one epoch-end read; 11b resumed to a third
     epoch against 3 straight epochs: parameters, Adam moments, step count and
     the last val metrics the same bits; 11c cli.eval on 11b's checkpoint:
     test_loss and test_acc1 equal to run()'s last val_loss and val_acc1; 11d
     mgd-deit-tiny.sh for 4 steps, then mgd-deit-tiny-transfer.sh's flowers run
     on synthetic data (102 classes, 224 px, batch 512, 4 steps): the heads
     dropped and re-initialised, every block the checkpoint's, the launch
     counts of each step. Prints run()'s train step (CUDA events recorded
     after each step) beside phase 10's, the loader wait, validate, checkpoint
     save and load times and bytes, and peak allocated memory, each beside the
     card's name and power limit;
 12. data parallelism: 12a, two processes on the one card joined by a gloo
     group, each B = 128 of one pinned global batch of 256 (post-transform
     images, targets, drop-path scales, DiffKD's draws made from a seed):
     the soft step (4 steps), one lrkd and one diffkd step at full width,
     each rank's all-reduced gradient and the ranks' mean loss against the
     one-process step at 256 (DP_GRAD_TOL, DP_LOSS_TOL), both ranks'
     gradients and parameters the same bits, 12 + 12 / 12 block launches a
     step on each rank; mixup in its three modes across the ranks against
     the one-process mixup of the global batch on the same draws (the same
     bits); the epoch's per-image generators differ between the ranks and
     the global batch's are equal; the gradient all-reduce and the mixup
     exchange timed; 12b, run() on the two ranks with soft-deit-tiny.sh's
     flags on phase 11's pickles: the RASampler's 8 steps an epoch, the
     launches of each step, the val metrics equal on both ranks, rank 0
     alone writing checkpoints, one epoch resumed to a second against two
     straight epochs (the same bits); 12c, `bash soft-deit-tiny.sh 1`
     (torchrun, NCCL at world 1) for 2 epochs against phase 11a's plain run
     (the same bits); each with its seconds, step times and peak memory
     beside the card's name and power limit;
 13. the fp32 route (an fp32 TrainConfig takes the same kernels in their fp32
     forms, every product 3xTF32 on TF32 tensor cores): 13a holds the fp32 block
     forward and backward against their plain fp32 versions (TF32 off in
     PyTorch's products and convolutions) at B=8 for D = 192 and 384, N =
     198 and 197, with and without the feature output, drop-path scales 0
     and 1/keep, then at the main-path shape [256, 198, D]: out - x, the
     feature, dx and the 12 weight gradients, each error (the largest
     |difference| over the largest |plain value|) at most F32_RATIO of the
     bf16 kernel's against the same fp32 plain result on the same inputs (or
     below F32_FLOOR), two runs the same bits; the fp32 weight gradient and
     the fp32 linear product alone (`[gemm fp32 linear]`: the forward's four
     products and the backward's four input gradients with their chains'
     epilogues at D = 192 and 384, M = 1001 and 50688, each weight's TF32
     split bit for bit against its plain version, timed in TFLOP/s beside
     torch.matmul with TF32 allowed and off) the same way; the fp32 MLP
     forward the same way at D = 192, 384, 768, 1024 (M = 1584 and 1001)
     and at the teacher's [50688, 384]; 13b the fp32 attention kernels the
     same way (o, lse, dq, dk, dv), at [24, 198, 64], N
     = 50, 65, 578 (4 and 1 heads) and 656 (the longest they take), the
     warp-specialised forward's edges (N = 8, 9: one chunk, its tail of one
     and two 8-key groups; 64: one whole chunk; 128, 129: one and two
     128-row CTAs a head, the second's one row on a single consumer; 200: a
     whole 8-key tail; each at 4 heads; 198 at one head; N = 1 for the
     forward alone), at [24,
     198, 64] on bf16-exact inputs, through the autograd Function on strided
     views of a packed qkv, and at [1536, 198, 64] and [768, 198, 64]; the
     largest fp32/bf16 ratio of each quantity (`[fp32 worst]`); 13c
     the soft-KD train step at full width with dtype float32 through
     load_teacher_student: exactly 12 + 12 fp32 block forwards and 12 fp32
     block backwards a step and no bf16 launch, finite metrics, changed
     parameters, its ms beside phase 6's bf16 soft step, peak memory; an eval
     batch; both models' logits and the soft loss on 4 images against the
     CPU port at fp32 on the same weights, closer than the bf16 card path on
     the same weights; one unfused fp32 step (a model axis of 2: 24 + 12 fp32
     attention launches and 12 of the teacher's fp32 MLP forward); 13d the fp32
     forms' times at the main-path shapes beside their bounds (TF32 rate or
     4-byte elements), their plain versions and one library call with TF32
     allowed, each beside the card's name and power limit;
 14. the fp32 forms of rows 6-8, then the rest of the optimizer and token
     dropout: 14a holds the fp32 MLP backward (dx, dW1, db1, dW2, db2) at
     D = 192, 384, 768, 1024 (M = 1584 and 1001) and the fp32 pair forward and
     backward (out - x, the features, dx, the 24 weight gradients) at B=8 for
     D = 192 and 384 and the four feature variants (sample 5 with all four
     scales 0 comes back as x) against their plain fp32 versions, each error
     at most F32_RATIO of the bf16 form's on the same inputs, two runs the same
     bits; then at the main shapes (the pair at [256, 198, 192] with no and
     with both features, also against two fp32 single kernels chained within
     PAIR_SINGLES_TOL; the MLP backward at [50688, 192]) with their times,
     plain versions, library calls (two library blocks; the MLP through
     autograd; TF32 allowed) and bounds, and the fp32 workspaces; 14b the
     paired fp32 soft step at full width through load_teacher_student(dtype
     float32, block_pair=True): 12 fp32 block forwards, 6 fp32 pair forwards
     and 6 fp32 pair backwards a step, no other launch, its eval batch on the
     single-block view, logits and soft loss against the CPU port, its ms and
     peak memory; 14c fused_mlp_train at fp32 at [256, 198, 192], one fp32
     forward and one fp32 backward launch; 14d every optimizer and schedule
     (adamw, sgd, adam x cosine, step, plateau) with the LR scale set half-way,
     card against CPU on DeiT-Ti-distilled's flat vector, the scale
     multiplying the whole update, each update timed; run() on phase 11's
     pickles with --sched plateau and --lr-noise for 3 epochs (the scale in
     effect and the scale saved after each epoch against PlateauController on
     the logged val_acc1 and lr_noise_multiplier), 2 epochs resumed to a third
     (the same bits), one epoch each of --opt sgd --sched step and --opt
     adam; 14e a student with token dropout 0.1: the kept share, the kept
     values' scale, two soft steps, eval unchanged;
 15. tensor parallelism (the JAX package's model mesh axis): 15a, two
     processes sharing the card over gloo at mesh (1, 2), the DeiT-S-distilled
     teacher (6 heads, 3 a rank) and DeiT-Ti-distilled student (3 heads: the
     qkv output gathered, attention on all heads), 224 px, global B = 32, soft
     KD, 3 steps in bf16 then in fp32 on one pinned batch: the gathered
     gradient of every parameter tensor, the loss, the grad norm and the
     gathered parameters against the one-process unfused step on the same
     weights and draws (TP_GRAD_TOL, TP_LOSS_TOL), the replicated tensors the
     same bits on both ranks, exactly 24 flash_fwd, 12 flash_bwd and 12
     fused_mlp_fwd (F/2 = 768) launches a step and rank and no block or pair
     launch; the step's ms a rank and the model group's collectives' ms and
     bytes (gloo through the host on one card: not a TP speed); 15d, four
     processes at mesh (1, 4): the bf16 soft step against the same one
     process, 12 fused_mlp_fwd launches on F/4 = 384, the student's eval view
     (the MLP kernel on F/4 = 192) against the one process's; 15e, eight
     processes (the JAX package's eight-device meshes): at (4, 2) the JAX dry
     run's cases at its widths (depth 3, D = 64 / 128, 4 heads, 32 px, fp32,
     PyTorch's own ops: the kernels take head dim 64): mgd, soft with
     grad_accum_steps=2, wasskd-sinkhorn with 8 iterations, each then its
     masked eval step (the last 3 rows invalid), against one process on the
     global batch (TP_DRY_TOL; the eval count exact); at (8, 1) the dry run's
     fused case, the bf16 soft step with accumulation 2 on the block kernels
     at DeiT widths (depth 3, 224 px, B = 256 a micro-batch, phase 12's
     regime) against the one-process fused step (phase 12's
     DP_GRAD_TOL, DP_LOSS_TOL), 6 forward launches a model and 6 backward a
     rank; at (1, 8) the full-width bf16 soft step against the one-process
     unfused step (TP_GRAD_TOL, TP_LOSS_TOL), its launches a rank (the
     teacher's MLP on F/8 = 192) and the student's eval view (12
     fused_mlp_fwd launches on F/8 = 96, the plan's 32-wide tail) against
     the one process's; 15c, run() at (1, 2) with soft-deit-tiny.sh's flags on phase 11's
     pickles at fp32, B = 32, 4 steps: one epoch against one process
     (TP_RUN_TOL), rank 0 alone writing, a one-process checkpoint resumed at
     (1, 2) against its one-process resume, each side's checkpoint loaded
     and saved again by the other side the same bits;
 16. learning (the texture task of tests/test_learning.py: horizontal and
     vertical stripes, checkerboard, solid; 256 training and 128 held-out
     images at 224 px with 16 px stripes, made from a seed; lr 2e-3 after
     20 steps of warmup, then the cosine over each run's steps): 16a a
     DeiT-Tiny at full width and depth, 4 classes, fresh weights, no KD, 100
     steps at B = 128 over the two training batches in turn, on each of six
     routes: the fused block (rows 1, 2), block pairs (rows 7, 8) and the
     unfused path (rows 3, 4; row 5 in eval), each in bf16 and in the fp32
     forms, and the fused bf16 route also at the JAX TPU test's constant
     2e-3 with no warmup (at seeds 0, 3 and 5); each route's kernels
     launched the expected number of times a step and no plain version run
     (every ``_plain_*`` of the ops modules counted); train top-1 at step
     100 and held-out top-1 above 85%; 16b a DeiT-S-distilled teacher (100
     classes, labels 0-3) trained on the fused bf16 route for 160 steps
     (held-out top-1 above 85%), then from it DeiT-Ti-distilled students by
     soft KD at DeiT's alpha 0.5 and tau 1 and at the recipe's 0.1 and 3,
     and a DeiT-Ti by wasskd-l1, 100 steps each on the fused path, held-out
     top-1 above 85% (and at DeiT's weights the distillation head's; at the
     recipe's it is read), and one more soft student at the recipe's
     weights under 16c's run() schedule (96 steps; the class head held,
     the distillation head read); 16c
     the teacher written as a checkpoint (both heads kept on import) and
     cli.train.main with soft-deit-tiny.sh's flags at B = 128 for 12 epochs
     on CIFAR-100 pickles of the texture task at 32 px (16a's images
     reduced by 7 x 7 means; the distill loss by epoch, the teacher's and
     the final student's distillation head's val top-1 printed beside): the
     train loss falls from the first epoch to the last and the last val
     top-1 is at least 50%;
 17. the outcome checks of the JAX package's benchmarks, ported, each
     through run() on the fused bf16 route with the launches of every train
     step and eval batch held to the route's and no plain version run
     (scripts/run_probe.py): 17a scripts/soak_run.py in full, 24 epochs of
     soft KD at 224 px from a folder of JPEGs (FolderSource and the Loader),
     EMA 0.996, a checkpoint each epoch, --resume at epoch 12; every gate of
     its analyze (24 epochs logged, the loss descent, the resume's
     continuity, val top-1 at least 45%, no epoch-time creep), the loader
     wait a step and the epoch times printed; 17b scripts/equivalence_run.py
     --quick --objective soft --dtype bfloat16 at seed 0: the torch stack's
     teacher and student (fp32, TF32 off) and ours, each seed's ours final
     val top-1 at least EQUIVALENCE_BAR, both stacks' readings and the band
     verdict printed;
 18. long sequences (448 px and up; --long-sequence-checks alone): 18a the
     bf16 attention backward's split route forced (kernel_flash_bwd(...,
     route="split")) at N = 198 and 704 for 4 and 96 heads, its dq, dk and
     dv the short route's bits; each kernel of the long routes against its
     plain version on the card, two runs the same bits: flash_fwd and
     flash_bwd in bf16 and fp32 (also on strided views of a packed qkv) at
     N = 705, 786, 1026 and 1298 (past the 11 tiles of dQ that the
     short route holds in shared memory), the block and pair
     forwards and backwards in bf16 and fp32 at
     D = 192 and 384, N = 786 and 1026, with and without the feature output
     and cotangents, and the value sort (four dtypes) and sorted_l1 (bf16,
     fp32) at n = 1025, 1296 and 4096 (the merge across warps through shared
     memory); 18b one soft-KD step at full width and depth at 448 px (B =
     32) on the fused, paired and unfused routes, each launching its route's
     kernels, its loss, distill loss and gradient norm and the flat soft-KD
     gradient of one batch with pinned drop-path scales against the plain
     route on the card (no kernel, the same seeded weights, LOGIT_TOL), then
     one WassKD-l1 step at 576 px (B = 16, 1296 patch rows) with its three
     sorted_l1 launches each way, each step's peak allocated memory; 18c
     rows 2, 4 and 8 at B = 32, N = 786 and 1026, timed beside their plain
     versions, bounds and library calls and scaled_dot_product_attention's
     forward+backward at the same shape, and flash_bwd's short and split
     routes, each forced, at N = 198 to 704 for B*H = 96 and 768 (the
     switch between them at 256 rows); 18d past the old limits: the value
     sort (four dtypes, NaN, +-inf, -0.0) and sorted_l1 (bf16, fp32; ties,
     +0.0/-0.0, and NaN) on the long route at n = 4097, 8192, 16641 and
     65536 against their plain versions, exact, two runs the same bits;
     rows 3 and 4 at [1, 47105, 64] against the plain versions in 1024-row
     chunks; rows 3 and 4 at B*H = 65,537 and row 1 at 21,846 x 3 heads (N
     = 8); the bits of rows 1, 3 and 9-11 at the main shapes and of the
     sorts at n = 1296 and 4096 against the parent's (PARENT_BITS); one
     WassKD-l1 step at 1040 px (B = 8, 4,225 patch rows) and one soft step
     at 3488 px (B = 1, 47,526 tokens) at full width and depth on the fused
     route, finite, with their launches; rows 9-11 at n = 4096 to 65536 and
     rows 3 and 4 at [3, 47526, 64] and [65537, 8, 64] timed beside their
     plain versions, bounds and torch.sort / SDPA.
It prints a JSON line with the kernels' numbers, then, as the last line,
{"ok": true, "device": {...}}. Without CUDA it exits non-zero and prints no
result.
"""

import atexit
import collections
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

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
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32
F32_RATIO = 0.02      # phase 13: an fp32 kernel's error against its plain fp32 version
#                       (TF32 off) at most this share of the bf16 kernel's against
#                       the same result on the same inputs, each error the largest
#                       |difference| over the largest |plain value|. Every fp32 product
#                       is 3xTF32 (hi and lo TF32 parts, about fp32 accuracy): the
#                       attention cores read about 0.001; one TF32 rounding of the
#                       operands reads 0.06-0.25, one bf16 rounding inside a form 0.15
#                       and more ...
F32_FLOOR = 1e-6      # ... or below this share of the largest |plain value|
F32_WORST = {}        # phase 13: the largest fp32/bf16 error ratio by (kernel, quantity)
F32_STEPS = 4         # phase 13c: fp32 soft steps (the ms is the median of steps 1-3)
PEAK_FP32_OPS = 67e12      # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
SORT_MAIN = (B_MAIN, 196, 384)   # one WassKD layer: patch tokens x teacher width
HEAD_DIM = 64
M_MAIN = B_MAIN * N_TOK          # token rows of one batch: 50688
# (batch * heads) of the main path's attention calls, and the MLP widths
ATTN_MAIN = {"teacher": B_MAIN * 6, "student": B_MAIN * 3}
MLP_MAIN = {"teacher": 384, "student": 192}
MLP_WIDTHS = (192, 384, 768, 1024)   # the model zoo's (models/registry.py)
# (D, F/M): the teacher's and the student's hidden shards at a model axis of 8
# (the plan's 32-wide tail chunk; two column passes), and at 2, 4 and 8 to time
MLP_SHARDS = ((192, 96), (384, 192))
MLP_SHARD_WIDTHS = ((384, 768), (384, 384), (384, 192), (192, 384), (192, 192), (192, 96))
UNFUSED_STEPS = 8
# train steps per distillation type, in the order they run
PATHS = (("soft", 8), ("wasskd", 4), ("mgd", 2), ("vitkd", 2))
# The recipes whose objectives PATHS does not drive (exp/*.sh): name,
# distillation options, the epoch of each step (curkd: one step in each of its
# phases). All but hard train the DeiT-Ti without a distillation token (N = 197).
RECIPE_COMMON = dict(student_model="deit_tiny_patch16_224", weight_decay=1e-4)
OBJECTIVE_PATHS = (
    ("wasskd-sinkhorn", dict(distillation_type="wasskd", wasskd_type="sinkhorn", alpha=0.5),
     (0, 0)),
    ("saliency_mgd", dict(distillation_type="saliency_mgd", saliency_method=1,
                          saliency_mask_ratio=0.5, alpha=0.1), (0, 0)),
    ("lrkd", dict(distillation_type="lrkd", lrkd_rank=32, lrkd_alpha=0.1, lrkd_beta=0.1,
                  lrkd_gamma=0.1, alpha=0.1), (0, 0)),
    ("diffkd", dict(distillation_type="diffkd"), (0, 0)),
    ("curkd", dict(distillation_type="curkd", alpha=0.5), (0, 120, 200)),
    ("hard", dict(distillation_type="hard", alpha=0.5,
                  student_model="deit_tiny_distilled_patch16_224"), (0, 0)),
)
OBJ_LOSS_TOL = 1e-4   # a distill loss, card vs CPU on the same fp32 features, relative
OBJ_GRAD_TOL = 1e-3   # its gradients (and saliency scores), of the largest |value|
# The Sinkhorn gradients weight each cost by exp(-C / eps), eps = 0.0025: one
# fp32 rounding of |x|^2 (the card and the CPU sum it in other orders) moves a
# weight by |x|^2 * 6e-8 / eps, 0.24% at |x|^2 = 100.
SINKHORN_GRAD_TOL = 2e-2
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
AUG_CPU_ROWS = 64     # phase 9: the images of each variant held against the CPU
# the entry points that launch the fp32 attention forward
ATTENTION_FWD_F32_ROWS = ("flash_fwd_f32", "fused_block_fwd_f32", "fused_block_bwd_f32",
                          "fused_pair_fwd_f32", "fused_pair_bwd_f32")
# the kernels that the fused block's wrappers launch (gemm_sm90.cuh,
# attention_{fwd,bwd}.cuh, fused_block_{common,reverse}.cuh)
BLOCK_KERNELS = ("linear_kernel", "weight_grad_kernel", "attention_fwd_kernel",
                 "attention_bwd_kernel", "attention_bwd_split_kernel", "attn_delta_kernel",
                 "ln_fwd_kernel",
                 "ln_bwd_kernel", "gfeat_kernel", "reduce_chunks_kernel",
                 "reduce_partials_kernel", "transpose_kernel", "colsum_kernel",
                 # the fp32 forms' own kernels
                 "linear_f32_kernel", "split_weights_tf32_kernel",
                 "attention_fwd_f32_ws_kernel", "weight_grad_f32_kernel",
                 "attention_bwd_pack_f32_kernel", "attention_bwd_f32_kernel",
                 "attention_bwd_reduce_f32_kernel")


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
                                                     "attention_bwd_split_kernel",
                                                     "attention_bwd_delta_kernel",
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


def _bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def _attention_fwd_bound(bh, n):
    """Two N x N x 64 products against q, k, v, o in bf16 and lse."""
    return _bound(2 * 2 * bh * n * n * HEAD_DIM, 4 * bh * n * HEAD_DIM * 2 + bh * n * 4)


def _attention_bwd_bound(bh, n):
    """Five N x N x 64 products against q, k, v, dO, dq, dk, dv (and o) in
    bf16 and lse."""
    return _bound(5 * 2 * bh * n * n * HEAD_DIM, 8 * bh * n * HEAD_DIM * 2 + bh * n * 4)


def _block_bwd_bound(B, n, D, blocks=1):
    """A block backward's (``blocks`` = 2: the pair's) products and bytes: per
    block the recompute up to the GELU (a forward less its fc2) and two
    products per forward product, and for the pair block 1's fc2 for mid;
    x, g_out, dx, the bf16 weights, the fp32 gradients."""
    flops1 = B * (24 * n * D * D + 4 * n * n * D)
    fc2 = 2 * B * n * D * 4 * D
    io, weights = B * n * D * 2, 12 * D * D
    if blocks == 1:
        return _bound(3 * flops1 - fc2, 3 * io + weights * (2 + 4))
    return _bound(2 * (3 * flops1 - fc2) + fc2, 3 * io + 2 * weights * (2 + 4))


def _block_inputs(D, H, B, seed, device, n=N_TOK, fp32=False):
    """A block's weights (LayerNorm params off their ones/zeros init), bf16
    (with ``fp32``: fp32) input and drop-path scales with some 0 and some
    1/keep. The matmul weights
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
    x = r(B, n, D, sc=1.0).to(device)
    x = x if fp32 else x.bfloat16()
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


BLOCK_LENGTHS = (50, N_TOK - 1, N_TOK, 578)
BLOCK_WIDTHS = ((192, 3), (384, 6), (768, 12))


def check_block_forward_shapes(fb, worst, lengths=BLOCK_LENGTHS, widths=BLOCK_WIDTHS,
                               B=B_CHECK):
    """Phase 3a': the block forward against its plain version at B=8 for every
    sequence length N in (50, 197, 198, 578) (ragged against the 64-row query
    tiles, 64-key chunks and 128-row GEMM tiles; 197, odd, is the DeiT
    without a distillation token; 578 is the 384-px finetune),
    width (192, 384, 768) and feature option, with drop-path scales that hold
    zeros; two runs the same bits. Phase 18a runs it at other lengths."""
    import torch

    for n in lengths:
        for D, H in widths:
            for need_feat in (False, True):
                p, x, sa, sm = _block_inputs(D, H, B, D + n + need_feat, "cuda", n=n)
                kw = dict(num_heads=H, scale_attn=sa, scale_mlp=sm)
                out, feat = fb.kernel_block_fwd(x, p, need_features=need_feat, **kw)
                again = fb.kernel_block_fwd(x, p, need_features=need_feat, **kw)
                r_out, r_feat = fb.reference_vit_block(x, p, **kw)
                torch.cuda.synchronize()
                _hold(worst, f"B={B} N={n} feat={need_feat}", "fused_block_fwd", D, x,
                      [("out", out, r_out)] + ([("feat", feat, r_feat)] if need_feat else []))
                if not (torch.equal(out, again[0])
                        and (not need_feat or torch.equal(feat, again[1]))):
                    raise AssertionError(f"fused_block_fwd D={D} N={n}: two runs gave "
                                         f"different bits")


def check_block_backward_shapes(fb, worst, lengths=BLOCK_LENGTHS, widths=BLOCK_WIDTHS,
                                B=B_CHECK):
    """Phase 3c: the block backward against its plain version at B=8 for
    every N in (50, 197, 198, 578) (ragged against the attention backward's 64-row
    tiles and the weight gradients' 64-row k-blocks), width (192, 384, 768),
    with and without a feature cotangent; the pair backward (and its forward)
    at D=192 and 384 for the same N, with no feature cotangent and with both;
    drop-path scales that hold zeros; two runs the same bits. Phase 18a runs
    it at other lengths (B >= 6: _pair_inputs zeroes sample 5)."""
    import torch

    for n in lengths:
        for D, H in widths:
            for need_feat in (False, True):
                p, x, sa, sm = _block_inputs(D, H, B, D + n + need_feat, "cuda", n=n)
                kw = dict(num_heads=H, scale_attn=sa, scale_mlp=sm)
                g = torch.Generator(device="cuda").manual_seed(D + n)
                g_out = torch.randn(x.shape, generator=g, device="cuda").bfloat16()
                g_feat = (torch.randn(x.shape, generator=g, device="cuda").bfloat16()
                          if need_feat else None)
                dx, dws = fb.kernel_block_bwd(x, p, g_out, g_feat, **kw)
                dx2, dws2 = fb.kernel_block_bwd(x, p, g_out, g_feat, **kw)
                r_dx, r_dws = fb.reference_vit_block_bwd(x, p, g_out, g_feat, **kw)
                torch.cuda.synchronize()
                _hold(worst, f"B={B} N={n} feat={need_feat}", "fused_block_bwd", D, x,
                      [("dx", dx, r_dx)] + [("d" + k, dws[k], r_dws[k]) for k in fb.PARAM_NAMES])
                if not (torch.equal(dx, dx2) and all(torch.equal(dws[k], dws2[k])
                                                     for k in fb.PARAM_NAMES)):
                    raise AssertionError(f"fused_block_bwd D={D} N={n}: two runs gave "
                                         f"different bits")
        for D, H in widths[:2]:
            for nf in (False, True):
                _hold_pair(fb, worst, D, H, B, nf, nf, D + n + nf, repeat=True, n=n)


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


def _linear_inputs(name, D, M, seed, fp32=False):
    """One product's operands and the epilogue that forward_chain gives it:
    qkv scales its q columns by 64^-1/2, proj adds the drop-path-scaled bf16
    block input, fc1 applies GELU (and keeps its derivative), fc2 adds the
    fp32 x2; the scales hold zeros. With ``fp32``, a, w and proj's residual
    fp32, as the fp32 form's chain has them."""
    import torch

    mult = {n: (a, b) for n, a, b in LINEAR_PRODUCTS}[name]
    N, K = mult[0] * D, mult[1] * D
    g = torch.Generator().manual_seed(seed)
    lp = (lambda t: t) if fp32 else (lambda t: t.bfloat16())
    a = lp(torch.randn(M, K, generator=g).cuda())
    w = lp((torch.randn(N, K, generator=g) / math.sqrt(K)).cuda())
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
        kw = dict(residual=lp(res) if name == "proj" else res, res_scale=s.cuda(),
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
        if kernel == "fused_block_bwd":
            bound = _block_bwd_bound(B, N, D)
        else:
            bound = _bound(B * (24 * N * D * D + 4 * N * N * D), 2 * B * N * D * 2 + 12 * D * D * 2)
        rows[(kernel, D)] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bound)
        print(f"[time] {kernel} D={D} B={B}: {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"library {library_ms:.3f} ms, bound {rows[(kernel, D)]['bound_ms']:.4f} ms "
              f"({rows[(kernel, D)]['bound_by']}){extra}")
    return rows


def _pair_inputs(D, H, B, seed, device, n=N_TOK, fp32=False):
    """Two blocks' weights, x of n tokens and the four drop-path scales
    (s_attn1, s_mlp1, s_attn2, s_mlp2): _block_inputs twice, block 2's scales
    rolled so its zeros fall on other samples, and sample 5 with all four at
    0; x and the three cotangents bf16 (with ``fp32``: fp32)."""
    import torch

    p1, x, sa1, sm1 = _block_inputs(D, H, B, seed, device, n=n, fp32=fp32)
    p2, _, sa2, sm2 = _block_inputs(D, H, B, seed + 1000, device, n=n)
    scales = [sa1, sm1, sa2.roll(3), sm2.roll(3)]
    for s in scales:
        s[5] = 0.0
    g = torch.Generator(device=device).manual_seed(seed)
    gs = [torch.randn(x.shape, generator=g, device=device).to(x.dtype) for _ in range(3)]
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
            bound = _block_bwd_bound(B, N, D, blocks=2)
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


def time_sort_kernels(so, shape=SORT_MAIN):
    """Phase 4b: the sort kernels at the main-path shape (18c: at ``shape``)
    in bf16 (the value sort in fp32 as well, `fp32_*` keys of its row): kernel, plain and
    library times, and the bound. Library: torch.sort(dim=1,
    stable=True) for the value sort; for sorted_l1 the stable sort of s and
    the sort of t with autograd's index scatter as the backward (its time is
    forward+backward minus forward). Bound: the larger of the bytes each
    kernel must move (inputs, outputs and the int8 residual once each) over
    the memory rate, and the network's compare-exchanges at this n (n / 2 a
    stage, over the ceil(log2 n) (ceil(log2 n) + 1) / 2 stages of a bitonic
    sort; two operations each: the padding's exchanges are not counted) over
    the fp32 rate."""
    import torch

    B, n, d = shape
    numel, esize = B * n * d, 2
    s, t = _sort_inputs(shape, torch.bfloat16, 1)
    _, sign = so.kernel_sorted_l1_fwd(s, t)
    scale = torch.ones((), device="cuda") / numel
    s_grad = s.clone().requires_grad_(True)
    levels = (n - 1).bit_length()
    exchanges = B * d * (n // 2) * levels * (levels + 1) // 2

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
        print(f"[time] {kernel} {shape} {'fp32' if row is fp32 else 'bf16'}: "
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


def _attention_inputs(shape, seed, fp32=False):
    """q, k of std 1.5 (scores of std about 2.2, a softmax far from flat), v
    and the cotangent dO of std 1, bf16 (with ``fp32``: fp32) on the card."""
    import torch

    g = torch.Generator().manual_seed(seed)
    q, k = (1.5 * torch.randn(shape, generator=g) for _ in range(2))
    v, do = (torch.randn(shape, generator=g) for _ in range(2))
    return tuple(t.cuda() if fp32 else t.cuda().bfloat16() for t in (q, k, v, do))


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
    one row, N = 578 for 4 and for 48 (batch, head) pairs and N = 656 (the
    backward's split route above 256 rows), the gradient through the autograd
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
        extra = ""
        if kernel == "flash_fwd":
            ms = _timed(lambda: at.kernel_flash_fwd(q, k, v), 20)
            plain_ms = _timed(lambda: at._plain_fwd(q, k, v), 5)
            with torch.no_grad():
                library_ms = _timed(lambda: F.scaled_dot_product_attention(q4, k4, v4), 20)
            bound = _attention_fwd_bound(bh, N_TOK)
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
            bound = _attention_bwd_bound(bh, N_TOK)
        rows[(kernel, bh)] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bound)
        print(f"[time] {kernel} {who} [{bh},{N_TOK},{HEAD_DIM}]: {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, library {library_ms:.3f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}){extra}")
    return rows


def _mlp_inputs(M, D, seed, F=None):
    """x and the cotangent dy of std 1 in bf16, fp32 weights of std
    1/sqrt(fan-in) in nn.Linear layout and biases of std 0.1, on the card;
    hidden width F (default 4 D)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    F = F or 4 * D
    x, dy = (torch.randn(M, D, generator=g).cuda().bfloat16() for _ in range(2))
    w1 = (torch.randn(F, D, generator=g) / math.sqrt(D)).cuda()
    w2 = (torch.randn(D, F, generator=g) / math.sqrt(F)).cuda()
    b1, b2 = ((0.1 * torch.randn(n, generator=g)).cuda() for n in (F, D))
    return x, w1, b1, w2, b2, dy


def _hold_mlp(fm, worst, M, D, main=False, F=None):
    """Both fused-MLP kernels against their plain versions at one shape
    (hidden width F, default 4 D)."""
    import torch

    x, w1, b1, w2, b2, dy = _mlp_inputs(M, D, M + D + (F or 0), F)
    out, out2 = (fm.kernel_fused_mlp(x, w1, b1, w2, b2) for _ in range(2))
    r_out = fm._plain_fwd(x, w1, b1, w2, b2)
    grads, grads2 = (fm.kernel_fused_mlp_bwd(x, w1, b1, w2, dy) for _ in range(2))
    r_grads = fm._plain_bwd(x, w1, b1, w2, dy)
    torch.cuda.synchronize()
    tag = f"M={M} D={D}" + (f" F={F}" if F else "")
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
    width; then the hidden shards of a model axis of 8 (MLP_SHARDS: the
    one-warpgroup plan with its 32-wide tail chunk at D = 192, F = 96, and in
    two column passes at D = 384, F = 192) at 8 and 32 images' rows and an
    odd M."""
    for D in MLP_WIDTHS:
        for M in (B_CHECK * N_TOK, 1001):
            _hold_mlp(fm, worst, M, D)
    for D in MLP_MAIN.values():
        _hold_mlp(fm, worst, M_MAIN, D, main=True)
    for D, F in MLP_SHARDS:
        for M in (B_CHECK * N_TOK, TP_BATCH * N_TOK, 1001):
            _hold_mlp(fm, worst, M, D, F=F)


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


def time_mlp_shard_widths(fm, smi):
    """The forward kernel at the hidden shards it serves under tensor
    parallelism (MLP_SHARD_WIDTHS: F/M at model axes 2, 4 and 8 of the
    teacher's and the student's F = 4 D) at 32 and 256 images' rows, on fp32
    parameters as the sharded teacher passes them, beside the library call
    (F.linear + F.gelu + F.linear on bf16 copies) and the bound of the
    MLP's own work (the one-warpgroup plan at D = 384 recomputes fc1 in its
    second column pass)."""
    import torch
    import torch.nn.functional as F

    for D, hidden in MLP_SHARD_WIDTHS:
        for M in (TP_BATCH * N_TOK, M_MAIN):
            x, w1, b1, w2, b2, _ = _mlp_inputs(M, D, 7, hidden)
            lib = [t.bfloat16() for t in (x, w1, b1, w2, b2)]
            ms = _timed(lambda: fm.kernel_fused_mlp(x, w1, b1, w2, b2), 10)
            with torch.no_grad():
                library_ms = _timed(
                    lambda: F.linear(F.gelu(F.linear(lib[0], lib[1], lib[2])), lib[3], lib[4]),
                    10)
            bound = _bound(2 * 2 * M * D * hidden,
                           2 * M * D * 2 + 2 * D * hidden * 2 + 4 * (hidden + D))
            print(f"[time] {smi}: fused_mlp_fwd shard M={M} D={D} F={hidden}: {ms:.4f} ms, "
                  f"library {library_ms:.4f} ms, kernel/library {ms / library_ms:.4f}, bound "
                  f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
            del x, w1, b1, w2, b2, lib


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


def _block_launches(steps, form=""):
    return {(f"fused_block_fwd{form}", 384): 12 * steps,
            (f"fused_block_fwd{form}", 192): 12 * steps,
            (f"fused_block_bwd{form}", 192): 12 * steps}


def _paired_launches(steps, form=""):
    return {(f"fused_block_fwd{form}", 384): 12 * steps, (f"fused_pair_fwd{form}", 192): 6 * steps,
            (f"fused_pair_bwd{form}", 192): 6 * steps}


def _unfused_launches(steps, form="", B=B_MAIN):
    return {(f"flash_fwd{form}", 6 * B): 12 * steps, (f"flash_fwd{form}", 3 * B): 12 * steps,
            (f"flash_bwd{form}", 3 * B): 12 * steps,
            (f"fused_mlp_fwd{form}", MLP_MAIN["teacher"]): 12 * steps}


def _reset_launches(mods):
    for mod in mods:
        mod.reset_launches()


class _Laps:
    """lap(name) prints the seconds since the last lap (or since the build
    ended) beside the time since the script started."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def __call__(self, name):
        now = time.perf_counter()
        print(f"[time] {name}: {now - self.last:.1f} s ({now - self.start:.1f} s after the "
              f"build)")
        self.last = now


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
                   teacher_checkpoint=None, options=None, epochs=None, name=None):
    """Phase 6: ``steps`` train steps of one distillation type at full width
    through load_teacher_student (the fused block; with ``paired`` the student
    on block pairs, block_pair=True) or, with ``unfused``, create_model with
    attention_fn / mlp_fn and no block_fn, then TrainState ->
    build_train_step. The launch counts are set to 0 just before the steps
    and read just after, and so is the peak of allocated memory. With
    ``teacher_checkpoint`` the config is the recipe's (exp/soft-deit-tiny.sh:
    TrainConfig's defaults, RandAugment and colour jitter 0.3 among them, and
    the teacher from that file); otherwise aa='', no colour jitter and a
    random teacher. ``options`` (TrainConfig fields) override the config: a
    recipe's student and distillation options; ``epochs`` gives each step's
    epoch (0 without). The launches the steps must make follow the path and
    the config's dtype (float32: the kernels' fp32 forms; a model axis > 1
    in ``mesh_shape``: the unfused route). Returns (launches, step ms, peak
    bytes, what the later phases need)."""
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
        cfg = TrainConfig(**{**dict(teacher_model="deit_small_distilled_patch16_224",
                                    student_model="deit_tiny_distilled_patch16_224",
                                    batch_size=B_MAIN, distillation_type=kd_type,
                                    dataset="cifar-100", input_size=224, dtype="bfloat16",
                                    drop_path_rate=0.1, epochs=300, aug_pixel_bf16=True,
                                    aa="", color_jitter=0.0, allow_random_teacher=True),
                             **(options or {})})
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
    name = name or (f"unfused {kd_type}" if unfused else f"paired {kd_type}" if paired
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
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(mods)
    times, metrics = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        m = step(state, images, labels, gen, epoch=epochs[i] if epochs else 0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = _read_launches(mods)
    peak = torch.cuda.max_memory_allocated()
    print(f"[{name}] launches over {steps} steps: {launches}")
    if unfused:   # after the counts are read: where the step's device time goes
        profile_calls(f"{name} step", lambda: step(state, images, labels, gen), calls=2)
        profile_parts(f"{name} step", lambda: step(state, images, labels, gen), UNFUSED_PARTS)
    elif kd_type == "soft" and not paired:
        profile_parts(f"{name} step", lambda: step(state, images, labels, gen), STEP_PARTS)
    form = "_f32" if cfg.dtype == "float32" else ""
    mesh = cfg.mesh_shape
    if unfused or (mesh and len(mesh) > 1 and int(mesh[1]) > 1):
        expect = _unfused_launches(steps, form)
    else:
        expect = _paired_launches(steps, form) if paired else _block_launches(steps, form)
    if kd_type == "wasskd" and cfg.wasskd_type == "l1":
        expect.update(sorted_l1_fwd=3 * steps, sorted_l1_bwd=3 * steps)
    if launches != expect:
        raise AssertionError(f"{name}: kernel launches {launches}, expected {expect}")
    for i, m in enumerate(metrics):
        print(f"[{name}] step {i}" + (f" (epoch {epochs[i]})" if epochs else "") + ": "
              + " ".join(f"{k}={v:.5g}" for k, v in m.items())
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
          f"{B_MAIN / steady:.1f} images/s; peak allocated {peak / 2**30:.3f} GiB; "
          f"max |param change| {changed}")
    return launches, steady * 1e3, peak, (teacher, student, aux, aug, kd, images, labels)


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
    return write_teacher_of(src, path, epoch=299, args="deit_small_distilled_patch16_384")


def write_teacher_of(model, path, **entries):
    """``model`` saved as timm and DeiT save a checkpoint: every key with
    'module.' inside {"model": ...}, beside the non-tensor ``entries``.
    Returns the state_dict (timm names, CPU tensors)."""
    import torch

    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    torch.save({"model": {"module." + k: v for k, v in state.items()}, **entries}, path)
    return state


def run_recipe_path(mods, path):
    """Phase 10, the soft recipe path: exp/soft-deit-tiny.sh's configuration
    (TrainConfig's defaults: rand-m9-mstd0.5-inc1, mixup 0.8 / cutmix 1.0,
    reprob 0.25, the bf16 pixel stage; weight decay 1e-4, alpha 0.1, tau 3)
    with its teacher imported from a checkpoint written here to ``path``
    (phase 11 reads it again). Checks the import report (both heads skipped,
    every block loaded, nothing unconsumed), that the teacher's blocks equal
    the file's and that its position embedding is the file's 24 x 24 grid
    interpolated to 14 x 14, then runs RECIPE_STEPS train steps through
    run_train_path."""
    import torch

    from deltakd_tpu_torch.models.pos_embed import interpolate_pos_embed

    state = write_teacher_checkpoint(path)
    launches, ms, _, kept = run_train_path(mods, "soft", RECIPE_STEPS,
                                           teacher_checkpoint=path)
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
    and must give the same bits; on the first AUG_CPU_ROWS images and their
    own draws the CPU runs the same draws, and the card
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
        # card against CPU on the first AUG_CPU_ROWS images, their own draws
        # (the CPU's transform of a whole batch took most of the phase)
        xs = x[:AUG_CPU_ROWS]
        ds = ta.draw_train_transform(gen, xs.shape, ac, device="cuda")
        d_cpu = ta.draws_to(ds, "cpu")
        geo_s = ta.geometric_stage(xs, ac, ds)
        geo_cpu = ta.geometric_stage(xs.cpu(), ac, d_cpu)
        # integer pixels: the bicubic resample rounds twice (between its passes
        # and at the end), and a sum that differs in its last bit can flip each
        # rounding by one level
        _pixels_agree(f"{name}: geometric stage, card vs CPU", geo_s, geo_cpu, 1e-3, 2.0)
        tol = 1.6e-2 if ac.pixel_bf16 else 1e-5
        _pixels_agree(f"{name}: pixel stage from the same integers, card vs CPU",
                      ta.pixel_stage(geo_cpu.cuda(), ac, ds), ta.pixel_stage(geo_cpu, ac, d_cpu),
                      tol, GREY_LEVEL, ops=d_cpu.ra or d_cpu.aa)
        whole = (ta.apply_train_transform(xs, ac, ds).float().cpu()
                 - ta.apply_train_transform(xs.cpu(), ac, d_cpu).float()).abs()
        geo = ta.geometric_stage(x, ac, d)
        # 4 calls stay inside _timed's head start, so the events bracket the
        # card's work; the host's time a call is taken beside it
        ms = _timed(lambda: ta.train_transform(gen, x, ac), 4)
        geo_ms = _timed(lambda: ta.geometric_stage(x, ac, d), 4)
        pix_ms = _timed(lambda: ta.pixel_stage(geo, ac, d), 4)
        host_ms = _host_ms(lambda: ta.train_transform(gen, x, ac), 4)
        print(f"[augment] {name}: whole transform card vs CPU ({AUG_CPU_ROWS} images): "
              f"share beyond {tol:g} "
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


def run_mlp_train(mods, fm, fp32=False):
    """fused_mlp_train forward and backward through its public function at the
    student's [256, 198, 192] (no model calls it, in the JAX package either),
    on bf16 x (with ``fp32``: fp32 x and dy, phase 14c): one forward and one
    backward launch of the form of x's dtype, finite gradients of the
    operands' shapes and dtypes."""
    import torch

    D = MLP_MAIN["student"]
    x, w1, b1, w2, b2, dy = _mlp_inputs(M_MAIN, D, 9)
    if fp32:
        x, dy = x.float(), dy.float()
    ops = [t.requires_grad_(True) for t in (x.reshape(B_MAIN, N_TOK, D), w1, b1, w2, b2)]
    _reset_launches(mods)
    out = fm.fused_mlp_train(*ops)
    grads = torch.autograd.grad(out, ops, dy.reshape(out.shape))
    torch.cuda.synchronize()
    launches = _read_launches(mods)
    form = "_f32" if fp32 else ""
    print(f"[fused_mlp_train{form}] launches {launches}")
    if launches != {(f"fused_mlp_fwd{form}", D): 1, (f"fused_mlp_bwd{form}", D): 1}:
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


def _features_against_cpu(what, teacher, student, aug, kd, images):
    """Both models' features on 4 images, card (kernels) vs CPU (plain path):
    exactly the blocks that feature_indices names for the distillation type
    (a missing flag shows as a zero feature, not as an error), each non-zero
    and held against the CPU. Returns {"teacher"/"student": (card features,
    CPU features)}, None where a block wrote none."""
    import torch

    from deltakd_tpu_torch.data.augment import eval_transform
    from deltakd_tpu_torch.kd.losses import feature_indices

    x = eval_transform(images[:4], aug).bfloat16()
    feats = {}
    for role, model in (("teacher", teacher), ("student", student)):
        with torch.no_grad():
            on_card = model(x, train=False).features
            on_cpu = copy.deepcopy(model).cpu()(x.cpu(), train=False).features
        written = [i for i, f in enumerate(on_card) if f is not None]
        expect = sorted(feature_indices(kd.distillation_type, model.cfg.depth))
        if written != expect:
            raise AssertionError(f"{what}: the {role} wrote the features of blocks {written}, "
                                 f"expected {expect}")
        n_tok = model.cfg.num_prefix_tokens + model.cfg.num_patches
        for i in written:
            if not on_card[i].abs().max().item() > 0:
                raise AssertionError(f"{what}: the {role}'s block {i} feature is zero")
            _agree(f"{what}: {role} block {i} features", on_card[i].float().cpu(),
                   on_cpu[i].float(), (4, n_tok, model.cfg.embed_dim))
        feats[role] = (on_card, on_cpu)
    return feats


def check_features_against_cpu(teacher, student, aux, aug, kd, images):
    """Phase 6b: the feature path on 4 images, card (kernels) vs CPU (plain
    path): both models' features of blocks 0-2 (the only ones WassKD makes
    them write) and the WassKD distill loss."""
    import torch

    from deltakd_tpu_torch.kd.losses import wasskd_loss

    feats = _features_against_cpu("wasskd", teacher, student, aug, kd, images)
    with torch.no_grad():
        on_card = wasskd_loss(kd, aux, feats["student"][0], feats["teacher"][0]).float().cpu()
        on_cpu = wasskd_loss(kd, copy.deepcopy(aux).cpu(), feats["student"][1],
                             feats["teacher"][1]).float()
    if not (torch.isfinite(on_card) and on_card > 0):
        raise AssertionError(f"wasskd distill loss on the card is {on_card}")
    _agree("wasskd distill loss", on_card, on_cpu, ())


def _hold_objective(what, loss_fn, feats, aux, grad_tol):
    """Runs ``loss_fn(aux, s_feats, t_feats, device)`` on the card and on
    the CPU from the same fp32 features ``feats`` ({"student": [...],
    "teacher": [...]}, None where a block wrote none) and holds the card's
    loss (OBJ_LOSS_TOL, relative) and its gradient with respect to each
    student feature (``grad_tol`` of the largest |value|; None on both sides
    where the loss does not read the block) against the CPU's."""
    import torch

    out = {}
    for device, aux_d in (("cuda", aux), ("cpu", copy.deepcopy(aux).cpu())):
        s = [None if f is None else f.to(device).detach().requires_grad_(True)
             for f in feats["student"]]
        t = [None if f is None else f.to(device) for f in feats["teacher"]]
        loss = loss_fn(aux_d, s, t, device)
        read = [f for f in s if f is not None]
        grads = torch.autograd.grad(loss, read, allow_unused=True)
        out[device] = (loss.detach().float().cpu(),
                       [None if g is None else g.float().cpu() for g in grads])
    (card, g_card), (cpu, g_cpu) = out["cuda"], out["cpu"]
    rel = abs(card.item() - cpu.item()) / abs(cpu.item())
    ok = math.isfinite(card.item()) and card.item() > 0 and rel <= OBJ_LOSS_TOL
    print(f"[objective] {what} distill loss on the card {card.item():.6g} vs the CPU port "
          f"{cpu.item():.6g}: rel err {rel:.3e} (tol {OBJ_LOSS_TOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the distill loss on the card disagrees with the CPU")
    worst = 0.0
    for a, b in zip(g_card, g_cpu):
        if (a is None) != (b is None):
            raise AssertionError(f"{what}: a feature gradient exists on one side only")
        if a is not None:
            err, mx = _err(a, b)
            worst = max(worst, err / max(mx, 1e-30))
    ok = worst <= grad_tol
    print(f"[objective] {what} d loss / d student features, card vs CPU: max rel err "
          f"{worst:.3e} (tol {grad_tol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the feature gradients on the card disagree with the CPU")


def _check_lrkd_targets(what, targets, t_feats, kd):
    """LRKD's targets on a random teacher's features are ill-conditioned
    vectors but well-defined invariants: per layer T^T T is diagonal with the
    top-k eigenvalues of the fp64 Gram matrix, in descending order, on it."""
    import torch

    for row, i in enumerate((0, 1, -1)):
        a = t_feats[i][:, kd.teacher_prefix:].reshape(-1, t_feats[i].shape[-1]).double().cpu()
        top = torch.linalg.eigvalsh(a.T @ a).flip(0)[:kd.lrkd_rank]
        tt = targets[row].double().cpu()
        tt = tt.T @ tt
        diag_err = (torch.diagonal(tt) - top).abs().max().item() / top[0].item()
        off = (tt - torch.diag(torch.diagonal(tt))).abs().max().item() / top[0].item()
        ok = diag_err <= OBJ_GRAD_TOL and off <= OBJ_GRAD_TOL
        print(f"[objective] {what} layer {row}: T^T T diagonal vs the top-{kd.lrkd_rank} "
              f"eigenvalues (lambda_1 {top[0].item():.4g}, lambda_k {top[-1].item():.4g}) "
              f"max err {diag_err:.3e}, off-diagonal {off:.3e} of lambda_1 (tol "
              f"{OBJ_GRAD_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{what}: LRKD targets break T^T T = diag(top eigenvalues)")


def check_objective_against_cpu(name, teacher, student, aux, aug, kd, images):
    """Phase 6c: one of OBJECTIVE_PATHS on 4 images, card against CPU. Both
    models' features (_features_against_cpu); then, on the card's features
    copied to fp32 (the same values on both sides), the distill loss and its
    feature gradients on the card against the CPU port (_hold_objective), the
    draws pinned on both sides: DiffKD's draws and CurKD's masking noise made
    once, CurKD in each of its phases; Saliency-MGD's scores held to
    OBJ_GRAD_TOL, then the loss on the card's scores on both sides; LRKD's
    targets held to their invariants (_check_lrkd_targets), then the loss on
    the card's targets on both sides; the Sinkhorn divergence also with TF32
    on in the process, which must give the same bits."""
    import torch

    from deltakd_tpu_torch.kd import losses as L
    from deltakd_tpu_torch.kd.masking import saliency_scores

    feats = {role: [None if f is None else f.detach().float() for f in on_card]
             for role, (on_card, _) in _features_against_cpu(
                 name, teacher, student, aug, kd, images).items()}
    t_feats = feats["teacher"]
    L_patch = teacher.cfg.num_patches
    t = kd.distillation_type

    if t == "wasskd":
        _hold_objective(name, lambda a, s, tf, dev: L.wasskd_loss(kd, a, s, tf), feats, aux,
                        SINKHORN_GRAD_TOL)
        check_sinkhorn_tf32(kd, aux, feats)
    elif t == "saliency_mgd":
        on_card = saliency_scores(aux.saliency_attn, t_feats[-1], kd.saliency_method,
                                  kd.teacher_prefix)
        on_cpu = saliency_scores(copy.deepcopy(aux.saliency_attn).cpu(), t_feats[-1].cpu(),
                                 kd.saliency_method, kd.teacher_prefix)
        err, mx = _err(on_card.cpu(), on_cpu)
        ok = err <= OBJ_GRAD_TOL * mx and tuple(on_card.shape) == (4, L_patch)
        print(f"[objective] {name} saliency scores, card vs CPU: max_abs_err {err:.3e} of "
              f"max {mx:.3e} (tol {OBJ_GRAD_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: the saliency scores disagree")
        _hold_objective(name, lambda a, s, tf, dev: L.saliency_mgd_loss(
            kd, a, s, tf, scores=on_card.to(dev)), feats, aux, OBJ_GRAD_TOL)
    elif t == "lrkd":
        targets = L.lrkd_targets(kd, t_feats)
        _check_lrkd_targets(name, targets, t_feats, kd)
        _hold_objective(name, lambda a, s, tf, dev: L.lrkd_loss(
            kd, a, s, tf, targets=targets.to(dev)), feats, aux, OBJ_GRAD_TOL)
    elif t == "diffkd":
        draws = L.DiffKDDraws.draw(torch.Generator().manual_seed(5),
                                   (4, L_patch, teacher.cfg.embed_dim), "cpu")

        def on(dev):
            return L.DiffKDDraws(draws.t_step.to(dev), [v.to(dev) for v in draws.noise],
                                 [v.to(dev) for v in draws.keep])
        _hold_objective(name, lambda a, s, tf, dev: L.diffkd_loss(
            kd, a, s, tf, train=True, draws=on(dev)), feats, aux, OBJ_GRAD_TOL)
    elif t == "curkd":
        noise = torch.rand(4, L_patch, generator=torch.Generator().manual_seed(6))
        for epoch in (0, 120, 200):
            _hold_objective(f"{name} epoch {epoch}", lambda a, s, tf, dev: L.curkd_loss(
                kd, a, s, tf, epoch=epoch, noise=noise.to(dev)), feats, aux, OBJ_GRAD_TOL)
    else:
        raise AssertionError(f"{name}: no card-against-CPU check for {t}")


def check_sinkhorn_tf32(kd, aux, feats):
    """The Sinkhorn divergence's cost products do not take TF32: on the
    aligned features of the three layers, the divergences and their
    gradients have the same bits with TF32 on in the process as with it off,
    where a plain fp32 product of the same features changes."""
    import torch

    from deltakd_tpu_torch.kd.aux import dense
    from deltakd_tpu_torch.kd.sinkhorn import batched_sinkhorn_divergence

    with torch.no_grad():
        x = torch.cat([dense(aux.align_wasskd[i], feats["student"][i][:, kd.student_prefix:])
                       for i in range(3)])
        y = torch.cat([feats["teacher"][i][:, kd.teacher_prefix:] for i in range(3)])

    def run():
        xg = x.detach().requires_grad_(True)
        div = batched_sinkhorn_divergence(xg, y, n_iters=kd.sinkhorn_iters)
        (grad,) = torch.autograd.grad(div.sum(), xg)
        return div.detach(), grad, torch.bmm(x, y.transpose(1, 2))

    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        div, grad, prod = run()
        torch.backends.cuda.matmul.allow_tf32 = True
        div_tf32, grad_tf32, prod_tf32 = run()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    same = torch.equal(div, div_tf32) and torch.equal(grad, grad_tf32)
    moved = not torch.equal(prod, prod_tf32)
    print(f"[objective] sinkhorn divergence {tuple(x.shape)} with TF32 on: the same bits "
          f"{same}; a plain fp32 product of the same features moved under TF32 {moved}")
    if not (same and moved):
        raise AssertionError("the Sinkhorn divergence depends on the TF32 setting")


def _planted_targets_input(M, D, top, seed):
    """[M, D] fp32 on the card, U diag(s) V^T with the first ``top`` singular
    values falling from 40 by 0.95 a step and the rest in [0.1, 1]: the top
    eigenvectors of its Gram matrix are well separated."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.linalg.qr(torch.randn(M, D, device="cuda", generator=g, dtype=torch.float64))[0]
    v = torch.linalg.qr(torch.randn(D, D, device="cuda", generator=g, dtype=torch.float64))[0]
    s = torch.cat([40.0 * 0.95 ** torch.arange(top, device="cuda", dtype=torch.float64),
                   0.1 + 0.9 * torch.rand(D - top, device="cuda", generator=g,
                                          dtype=torch.float64)])
    return ((u * s) @ v.T).float()


def time_objective_solvers():
    """Phase 6d, at the main path's shapes. LRKD: rank_k_targets on a
    planted [50176, 384] spectrum (rank 32), both solvers, card against the
    CPU port; the batched eigh of lrkd_targets ([3, 384, 384]) and the
    subspace solver on the same Gram matrices, each on the host's clock (eigh
    waits for its error check on the host). WassKD-sinkhorn: the potential
    solve alone and the loss forward and backward on [768, 196, 384], on the
    card's clock."""
    import torch

    from deltakd_tpu_torch.kd import losses as L
    from deltakd_tpu_torch.kd import sinkhorn as sk

    M, D, rank = B_MAIN * 196, 384, 32
    a = _planted_targets_input(M, D, 40, 0)
    for solver in ("eigh", "subspace"):
        on_card = L.rank_k_targets(a, rank, solver=solver).cpu()
        on_cpu = L.rank_k_targets(a.cpu(), rank, solver=solver)
        err, mx = _err(on_card, on_cpu)
        ok = err <= OBJ_GRAD_TOL * mx
        print(f"[lrkd] rank_k_targets ({solver}) on a planted [{M}, {D}] spectrum, rank {rank}, "
              f"card vs CPU: max_abs_err {err:.3e} of max {mx:.3e} (tol {OBJ_GRAD_TOL}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"rank_k_targets ({solver}) on the card disagrees with the CPU")
    t2 = torch.stack([_planted_targets_input(M, D, 40, s) for s in (1, 2, 3)])
    gram = torch.bmm(t2.mT, t2)
    eigh_ms = _host_ms(lambda: torch.linalg.eigh(gram), 10)
    sub_ms = _host_ms(lambda: L.topk_eigvecs_subspace(gram, rank), 10)
    tgt_ms = _host_ms(lambda: torch.bmm(t2, L._canon_sign(
        torch.linalg.eigh(torch.bmm(t2.mT, t2))[1].flip(-1)[..., :rank])), 10)
    print(f"[lrkd] [3, {D}, {D}] batched eigh {eigh_ms:.3f} ms, subspace solver (rank {rank}) "
          f"{sub_ms:.3f} ms, the whole of lrkd_targets at M = {M} {tgt_ms:.3f} ms "
          f"(host's clock)")
    del a, t2, gram

    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(3 * B_MAIN, 196, 384, device="cuda", generator=g) * 0.5
    y = torch.randn(3 * B_MAIN, 196, 384, device="cuda", generator=g) * 0.5
    solve = _timed(lambda: sk._solve_scan(x, y, 0.0025, 20, 6), 5, warmup=1)
    xg = x.clone().requires_grad_(True)

    def loss_fwd_bwd():
        sk.batched_sinkhorn_divergence(xg, y).sum().backward()
    whole = _timed(loss_fwd_bwd, 5, warmup=1)
    print(f"[sinkhorn] [{3 * B_MAIN}, 196, 384]: the potential solve {solve:.3f} ms, the "
          f"divergence forward and backward {whole:.3f} ms (card's clock)")


# The runtime (phase 11): run() and the CLIs with the flags of the port's
# copies of the exp/*.sh recipes, on CIFAR-100-format pickles written here
RUNTIME_TRAIN, RUNTIME_TEST = 4096, 1000   # 16 train steps of 256, 4 eval batches
TRANSFER_STEPS = 4
SYNC_WARNING = "synchroniz"   # in torch.cuda's sync debug warnings


def write_cifar100_pickles(root, splits):
    """cifar-100-python/{train,test} as the standard archive holds them: uint8
    rows of 3072 (CHW) and 'fine_labels'; ``splits`` maps each name to its
    (rows, labels)."""
    import pickle

    base = os.path.join(root, "cifar-100-python")
    os.makedirs(base)
    for name, (rows, labels) in splits.items():
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({"data": rows, "fine_labels": [int(v) for v in labels]}, f)


def write_cifar100(root, n_train, n_test, seed=0):
    """CIFAR-100 pickles of random pixels and labels."""
    import numpy as np

    rng = np.random.RandomState(seed)
    write_cifar100_pickles(root, {
        name: (rng.randint(0, 256, (n, 3072), dtype=np.uint8), rng.randint(0, 100, n))
        for name, n in (("train", n_train), ("test", n_test))})


def recipe_argvs(recipe, tmp, **env):
    """The training commands of deltakd_tpu_torch/exp/<recipe>: bash runs the
    recipe with a stub ``python`` first on PATH that records its arguments.
    Returns each command's flags (after ``-m deltakd_tpu_torch.cli.train``)."""
    root = os.path.dirname(os.path.abspath(__file__))
    stub_dir = os.path.join(tmp, "bin")
    os.makedirs(stub_dir, exist_ok=True)
    stub, record = os.path.join(stub_dir, "python"), os.path.join(tmp, "recipe.args")
    with open(stub, "w") as f:
        f.write('#!/bin/bash\nprintf "%s\\0" "$@" >> "$RECORD"\nprintf "\\n\\0" >> "$RECORD"\n')
    os.chmod(stub, 0o755)
    if os.path.exists(record):
        os.remove(record)
    subprocess.run(["bash", os.path.join(root, "deltakd_tpu_torch", "exp", recipe)],
                   env={**os.environ, "PATH": f"{stub_dir}:{os.environ['PATH']}",
                        "RECORD": record, **env}, check=True, cwd=tmp)
    calls, current = [], []
    with open(record, "rb") as f:
        for arg in f.read().split(b"\0")[:-1]:
            if arg == b"\n":
                calls.append(current)
                current = []
            else:
                current.append(arg.decode())
    for argv in calls:
        if argv[:2] != ["-m", "deltakd_tpu_torch.cli.train"]:
            raise AssertionError(f"{recipe} runs {argv[:2]}")
    return [argv[2:] for argv in calls]


def soft_recipe_argv(tmp, env):
    """soft(save, *extra): the flags of soft-deit-tiny.sh with ``env`` and its
    --save-dir and --log-file under ``tmp``, ``extra`` appended."""
    def soft(save, *extra):
        [argv] = recipe_argvs("soft-deit-tiny.sh", tmp, EXTRA_FLAGS=" ".join(
            ["--save-dir", os.path.join(tmp, save), "--log-file",
             os.path.join(tmp, "logs", save), "--log-every", "1000", *extra]), **env)
        return argv

    return soft


class RunProbe:
    """Wraps what run() calls (train_one_epoch, the steps, validate, the
    checkpoint save and load, the train loader's batches, the finetune load)
    to count and time them without a host sync inside an epoch: each train
    step and eval batch gets its kernel launches (read off the host-side
    counts) and each train step a CUDA event recorded after it; one epoch can
    run under torch.cuda's sync debug mode, which counts the syncs inside the
    steps and records where each of the others was."""

    def __init__(self, mods):
        import torch

        from deltakd_tpu_torch.data import pipeline
        from deltakd_tpu_torch.train import loop

        self.mods, self.torch, self.loop, self.pipeline = mods, torch, loop, pipeline
        self.sync_epoch = None
        self.reset()

    def reset(self):
        self.step_launches, self.eval_launches, self.events = [], [], []
        self.loader_wait, self.validate_ms, self.epoch_metrics = [], [], []
        self.val_metrics = []
        self.save, self.load_ms, self.finetune = [], [], None
        self.syncs = None   # (where each sync outside the steps was, syncs in the steps)
        self._warnings, self._in_steps = None, set()

    def _syncs(self):
        return [w for w in self._warnings if SYNC_WARNING in str(w.message)]

    def _launch_delta(self, before):
        after = _read_launches(self.mods)
        return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}

    def __enter__(self):
        torch, loop, probe = self.torch, self.loop, self
        self._saved = {name: getattr(loop, name) for name in (
            "build_train_step", "build_eval_step", "train_one_epoch", "validate",
            "save_checkpoint", "load_checkpoint", "load_student_for_finetune")}
        self._saved_epoch = self.pipeline.Loader.epoch
        real = self._saved

        def build_train_step(**kw):
            inner = real["build_train_step"](**kw)

            def step(state, images, labels, generator, **skw):
                before = _read_launches(probe.mods)
                seen = len(probe._warnings) if probe._warnings is not None else 0
                metrics = inner(state, images, labels, generator, **skw)
                if probe._warnings is not None:
                    probe._in_steps.update(id(w) for w in probe._warnings[seen:])
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                probe.events.append((skw.get("epoch"), event))
                probe.step_launches.append(probe._launch_delta(before))
                return metrics

            return step

        def build_eval_step(**kw):
            inner = real["build_eval_step"](**kw)

            def step(*args):
                before = _read_launches(probe.mods)
                out = inner(*args)
                probe.eval_launches.append(probe._launch_delta(before))
                return out

            return step

        def train_one_epoch(state, train_step, loader, epoch, cfg, **kw):
            if epoch != probe.sync_epoch:
                out = real["train_one_epoch"](state, train_step, loader, epoch, cfg, **kw)
            else:
                # set before the record starts: the first switch in a process
                # warns at the setter's own line
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    with warnings.catch_warnings(record=True) as caught:
                        warnings.simplefilter("always")
                        probe._warnings, probe._in_steps = caught, set()
                        out = real["train_one_epoch"](state, train_step, loader, epoch,
                                                      cfg, **kw)
                        syncs = probe._syncs()
                        probe.syncs = (
                            [f"{os.path.basename(w.filename)}:{w.lineno}" for w in syncs
                             if id(w) not in probe._in_steps],
                            sum(id(w) in probe._in_steps for w in syncs))
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                    probe._warnings = None
            probe.epoch_metrics.append(out)
            return out

        def timed(name, record):
            def wrapper(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real[name](*args, **kw)
                torch.cuda.synchronize()
                record(out, (time.perf_counter() - t0) * 1e3)
                return out
            return wrapper

        def loader_epoch(loader, epoch):
            it = probe._saved_epoch(loader, epoch)
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                    if loader.is_train:
                        probe.loader_wait.append(time.perf_counter() - t0)
                    yield item
            finally:
                it.close()

        def finetune(checkpoint, student, **kw):
            target = {n: p.detach().clone() for n, p in student.named_parameters()}
            lines = []
            log = kw.pop("log")
            merged = real["load_student_for_finetune"](
                checkpoint, student, log=lambda m: (lines.append(m), log(m)), **kw)
            probe.finetune = dict(target=target, merged=merged, lines=lines)
            return merged

        loop.build_train_step = build_train_step
        loop.build_eval_step = build_eval_step
        loop.train_one_epoch = train_one_epoch
        loop.validate = timed("validate", lambda out, ms: (probe.validate_ms.append(ms),
                                                           probe.val_metrics.append(out)))
        loop.save_checkpoint = timed("save_checkpoint", lambda path, ms: probe.save.append(
            (ms, os.path.getsize(os.path.join(path, "state.pt")))))
        loop.load_checkpoint = timed("load_checkpoint",
                                     lambda out, ms: probe.load_ms.append(ms))
        loop.load_student_for_finetune = finetune
        self.pipeline.Loader.epoch = loader_epoch
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.loop, name, fn)
        self.pipeline.Loader.epoch = self._saved_epoch

    def step_ms(self):
        """Per train step after the first of its epoch: the time between the
        events recorded after it and after the step before it."""
        self.torch.cuda.synchronize()
        out = []
        for (e0, a), (e1, b) in zip(self.events, self.events[1:]):
            if e0 == e1:
                out.append(a.elapsed_time(b))
        return out


def _median(values):
    values = sorted(values)
    return values[len(values) // 2]


def _check_launches(what, got, expect, count):
    if len(got) != count or any(g != expect for g in got):
        raise AssertionError(f"{what}: {len(got)} launch counts (expected {count} of "
                             f"{expect}): {got[:3]}")


def _check_loop_syncs(n):
    if n != 1:
        raise AssertionError(f"11a: the loop adds {n} host syncs to an epoch; expected 1, "
                             f"the epoch-end read")


def _same_state(a_dir, b_dir):
    import torch

    a = torch.load(os.path.join(a_dir, "state.pt"), weights_only=True)
    b = torch.load(os.path.join(b_dir, "state.pt"), weights_only=True)
    sa, sb = a["state"], b["state"]
    same = (a["meta"] == b["meta"] and sa["step"] == sb["step"]
            and sa["opt"]["count"] == sb["opt"]["count"]
            and all(torch.equal(x, y) for x, y in (
                (sa["params"], sb["params"]), (sa["opt"]["mu"], sb["opt"]["mu"]),
                (sa["opt"]["nu"], sb["opt"]["nu"]))))
    return same, sa["step"]


def run_runtime_path(mods, tmp, teacher_checkpoint, smi, soft_recipe_ms):
    """Phase 11, the runtime: cli.train.main and cli.eval.main with the flags of
    the port's exp/*.sh copies (their --epochs and --save-dir overridden through
    EXTRA_FLAGS), the teacher from phase 10's checkpoint, the data from CIFAR-100
    pickles (4096 train, 1000 test images). 11a: soft-deit-tiny.sh for 2
    epochs; 11b: resumed to 3, against 3 straight epochs; 11c: the eval CLI on
    11b's checkpoint; 11d: mgd-deit-tiny.sh for 4 steps, then
    mgd-deit-tiny-transfer.sh's flowers run on synthetic data at batch 512."""
    import torch

    from deltakd_tpu_torch.ckpt.checkpoint import student_state_dict
    from deltakd_tpu_torch.cli import eval as eval_cli
    from deltakd_tpu_torch.cli import train as train_cli

    # the recipes pass --wandb; where wandb is installed, keep it off the
    # network (no run, no error reports)
    os.environ.update(WANDB_MODE="disabled", WANDB_ERROR_REPORTING="false")
    data = os.path.join(tmp, "data")
    write_cifar100(data, RUNTIME_TRAIN, RUNTIME_TEST)
    env = dict(DATA_PATH=data, TEACHER_CKPT=teacher_checkpoint)
    steps = RUNTIME_TRAIN // B_MAIN
    eval_batches = -(-RUNTIME_TEST // B_MAIN)
    fused = {("fused_block_fwd", 384): 12, ("fused_block_fwd", 192): 12,
             ("fused_block_bwd", 192): 12}
    eval_fused = {("fused_block_fwd", 192): 12}

    soft = soft_recipe_argv(tmp, env)
    probe = RunProbe(mods)
    # 11a: two epochs; the syncs of the first counted
    probe.sync_epoch = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with probe:
        metrics_a = train_cli.main(soft("soft", "--epochs", "2"))
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    step_ms = probe.step_ms()
    _check_launches("11a train steps", probe.step_launches, fused, 2 * steps)
    _check_launches("11a eval batches", probe.eval_launches, eval_fused, 2 * eval_batches)
    finite = [m for m in probe.epoch_metrics + [metrics_a]
              if not all(math.isfinite(v) for v in m.values())]
    if finite or len(probe.epoch_metrics) != 2:
        raise AssertionError(f"11a: non-finite metrics {finite or probe.epoch_metrics}")
    ckpt = os.path.join(tmp, "soft", "checkpoint")
    with open(os.path.join(ckpt, "meta.json")) as f:
        meta = json.load(f)
    layout = sorted(os.listdir(ckpt))
    if layout != ["meta.json", "state-1", "state-2"] or meta != {
            "epoch": 2, "best_acc": metrics_a["best_val_acc"], "format": "torch-v1",
            "state_dir": "state-2"}:
        raise AssertionError(f"11a: checkpoint layout {layout}, meta {meta}")
    state_11a = os.path.join(tmp, "11a-state-2")   # for phase 12c
    shutil.copytree(os.path.join(ckpt, "state-2"), state_11a)
    outside, in_steps = probe.syncs
    print(f"[runtime] 11a soft-deit-tiny.sh 2 epochs of {steps} steps in {run_s:.1f} s "
          f"(models, banner and validation included): {metrics_a}; train "
          f"{probe.epoch_metrics[-1]}; checkpoint {layout}, meta {meta}")
    print(f"[runtime] 11a host syncs over epoch 0 (log_every 1000 > {steps} steps): "
          f"{in_steps} inside the {steps} steps (build_train_step's own), "
          f"{len(outside)} outside them, the loop's own (at {outside})")
    _check_loop_syncs(len(outside))
    ms = _median(step_ms)
    wait = sum(probe.loader_wait) / len(probe.loader_wait)
    save_ms, save_bytes = probe.save[-1]
    validate_ms = list(probe.validate_ms)
    print(f"[runtime] {smi}: run() train step {ms:.2f} ms (median of {len(step_ms)} "
          f"steps after the first of each epoch, CUDA events), {B_MAIN / ms * 1e3:.1f} "
          f"images/s; phase 10's soft recipe step {soft_recipe_ms:.2f} ms in this run")
    print(f"[runtime] {smi}: loader wait {wait * 1e3:.3f} ms a step (mean of "
          f"{len(probe.loader_wait)}, max {max(probe.loader_wait) * 1e3:.3f}); validate "
          f"{', '.join(f'{v:.1f}' for v in probe.validate_ms)} ms an epoch "
          f"({eval_batches} batches of {B_MAIN}); checkpoint save "
          f"{', '.join(f'{v:.1f}' for v, _ in probe.save)} ms, {save_bytes} bytes; "
          f"peak allocated {peak / 2**30:.3f} GiB")

    # 11b: resumed to a third epoch, against three straight epochs
    probe.sync_epoch = None
    probe.reset()
    with probe:
        straight = train_cli.main(soft("straight", "--epochs", "3"))
        resumed = train_cli.main(soft("soft", "--epochs", "3", "--resume",
                                      "--checkpoint", ckpt))
    same, step = _same_state(os.path.join(tmp, "straight", "checkpoint", "state-3"),
                             os.path.join(ckpt, "state-3"))
    last = {k: v for k, v in straight.items() if k.startswith("val_")}
    print(f"[runtime] 11b resumed to epoch 3: {resumed}; straight: {straight}; "
          f"parameters, Adam moments and {step} steps "
          f"{'the same bits' if same else 'DIFFER'}")
    print(f"[runtime] {smi}: checkpoint load {probe.load_ms[0]:.1f} ms, "
          f"{save_bytes} bytes")
    if not same or {k: resumed[k] for k in last} != last:
        raise AssertionError("11b: the resumed run differs from the straight one")

    # 11c: the eval CLI on 11b's checkpoint
    argv = soft("soft", "--epochs", "3") + ["--checkpoint", ckpt, "--output",
                                            os.path.join(tmp, "eval.json")]
    got = eval_cli.main(argv)
    print(f"[runtime] 11c cli.eval: {got}")
    if (got["test_loss"], got["test_acc1"]) != (resumed["val_loss"], resumed["val_acc1"]):
        raise AssertionError(f"11c: cli.eval {got} differs from run()'s last {resumed}")

    # 11d: mgd for a short epoch, then the transfer recipe's flowers run
    probe.reset()
    with probe:
        [argv] = recipe_argvs("mgd-deit-tiny.sh", tmp, EXTRA_FLAGS=" ".join([
            "--save-dir", os.path.join(tmp, "mgd"), "--log-file",
            os.path.join(tmp, "logs", "mgd"), "--epochs", "1", "--steps-per-epoch",
            str(TRANSFER_STEPS), "--eval-steps", "1"]), **env)
        train_cli.main(argv)
        _check_launches("11d mgd steps", probe.step_launches, fused, TRANSFER_STEPS)
        mgd_ckpt = os.path.join(tmp, "mgd", "checkpoint")
        argvs = recipe_argvs("mgd-deit-tiny-transfer.sh", tmp, CKPT=mgd_ckpt, EXTRA_FLAGS=(
            f"--synthetic-data --epochs 1 --steps-per-epoch {TRANSFER_STEPS} "
            f"--eval-steps 1 --save-dir {os.path.join(tmp, 'transfer')} "
            f"--log-file {os.path.join(tmp, 'logs', 'transfer')}"), **env)
        if argvs[0][argvs[0].index("--dataset") + 1] != "flowers":
            raise AssertionError(f"the transfer recipe's first run: {argvs[0]}")
        probe.step_launches, probe.eval_launches = [], []
        transfer = train_cli.main(argvs[0])
    _check_launches("11d transfer steps (B=512)", probe.step_launches, fused, TRANSFER_STEPS)
    _check_launches("11d transfer eval batch", probe.eval_launches, eval_fused, 1)
    ft = probe.finetune
    source, _ = student_state_dict(mgd_ckpt)
    blocks = [k for k in source if k.startswith("blocks.")]
    differ = [k for k in blocks if not torch.equal(ft["merged"][k].cpu(), source[k])]
    head_fresh = all(torch.equal(ft["merged"][k], ft["target"][k])
                     for k in ("head.weight", "head.bias"))
    dropped = sorted(line.split()[2].rstrip(":") for line in ft["lines"]
                     if "dropping" in line)
    print(f"[runtime] 11d transfer (flowers, synthetic, 102 classes, B=512): {transfer}; "
          f"dropped {dropped}, head re-initialised {head_fresh}; {len(blocks)} block "
          f"tensors, {len(differ)} differ from the checkpoint")
    if dropped != ["head.bias", "head.weight"] or not head_fresh or differ or not blocks:
        raise AssertionError("11d: the finetune load does not match the checkpoint")
    if not all(math.isfinite(v) for v in transfer.values()):
        raise AssertionError(f"11d: non-finite metrics {transfer}")
    return dict(step_ms=ms, loader_wait_ms=wait * 1e3, validate_ms=validate_ms,
                save_ms=save_ms, save_bytes=save_bytes, peak=peak, env=env,
                state_11a=state_11a, soft_argv=soft)


# Data parallelism (phase 12): two processes on the one card over gloo (12a,
# 12b), then a recipe under torchrun with NCCL at world 1 (12c)
DP_WORLD = 2
DP_SOFT_STEPS = 4
DP_OBJECTIVES = ("soft", "lrkd", "diffkd")
# the ranks' all-reduced gradient against the one-process step on the same
# inputs, per parameter tensor of its largest |value|, and the ranks' mean
# loss, relative. The per-sample work is the same; the batch sums run in
# another order: in fp32 in the block kernels and the all-reduce, but the
# gradients of the parameters that PyTorch's own bf16 ops use (the patch
# embedding, the heads, the tokens, the aux heads) are rounded to bf16 per
# rank before they are summed, and LRKD's eigenvectors move with the fp32
# order of the Gram's sum where two eigenvalues lie close. Measured worst
# (one H100): 3.9e-3 soft, 5.8e-3 lrkd and diffkd; a rank's own half-batch
# gradient misses by O(1)
DP_GRAD_TOL = 1e-2
DP_LOSS_TOL = 1e-4


def _dp_config(name):
    from deltakd_tpu_torch.configs.config import TrainConfig

    options = dict(teacher_model="deit_small_distilled_patch16_224",
                   student_model="deit_tiny_distilled_patch16_224", batch_size=B_MAIN,
                   distillation_type="soft", dataset="cifar-100", input_size=224,
                   dtype="bfloat16", drop_path_rate=0.1, epochs=300, aug_pixel_bf16=True,
                   aa="", color_jitter=0.0, allow_random_teacher=True)
    if name != "soft":
        options.update(RECIPE_COMMON, **{n: o for n, o, _ in OBJECTIVE_PATHS}[name])
    return TrainConfig(**options)


def _dp_rows(rank, world):
    b = B_MAIN // world
    return slice(rank * b, (rank + 1) * b)


def _dp_step(mods, name, dp, rows, steps):
    """``steps`` train steps of ``name`` (soft, lrkd or diffkd) at full width on
    ``rows`` of one pinned global batch of B_MAIN, made from a seed on the
    card: post-transform images, soft targets, drop-path scales and DiffKD's
    draws. Returns the first step's metrics and applied flat gradient, the
    parameters after the last, each step's launches and CUDA-event ms, and
    the peak of allocated memory."""
    import torch

    from deltakd_tpu_torch.data.augment import AugmentConfig
    from deltakd_tpu_torch.kd.losses import DiffKDDraws, KDSettings
    from deltakd_tpu_torch.models.factory import load_teacher_student
    from deltakd_tpu_torch.train.optim import make_optimizer
    from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
    from deltakd_tpu_torch.train.step import build_train_step

    cfg = _dp_config(name)
    teacher, student, aux = load_teacher_student(cfg, seed=0, device="cuda")
    tx = make_optimizer(cfg, trainable_parameters(student, aux), 100)
    state = TrainState(student, tx=tx, aux=aux)
    applied = []
    apply = state.apply_gradients
    state.apply_gradients = lambda *, grads, **kw: (
        applied.append(grads.detach().clone()) if not applied else None,
        apply(grads=grads, **kw))
    kd = KDSettings.from_config(cfg, student_prefix=student.cfg.num_prefix_tokens,
                                teacher_prefix=teacher.cfg.num_prefix_tokens)
    step = build_train_step(cfg=cfg, kd=kd, student=student, teacher=teacher, aux=aux,
                            aug=AugmentConfig.from_config(cfg), mixup=None, tx=tx, dp=dp)
    g = torch.Generator(device="cuda").manual_seed(12)
    images = torch.randn(B_MAIN, 224, 224, 3, generator=g, device="cuda").to(torch.bfloat16)
    targets = torch.softmax(3.0 * torch.randn(B_MAIN, 100, generator=g, device="cuda"), -1)
    labels = torch.randint(0, 100, (B_MAIN,), generator=g, device="cuda")
    scales = [None if s is None else tuple(x[rows] for x in s)
              for s in student.draw_drop_scales(B_MAIN, g, "cuda")]
    draws = None
    if name == "diffkd":
        n_patches = (224 // 16) ** 2
        d = DiffKDDraws.draw(g, (B_MAIN, n_patches, teacher.cfg.embed_dim), "cuda")
        draws = DiffKDDraws(d.t_step[rows], [x[rows] for x in d.noise],
                            [x[rows] for x in d.keep])
    gen = torch.Generator(device="cuda").manual_seed(4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches, ms, first = [], [], None
    for _ in range(steps):
        _reset_launches(mods)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        m = step(state, None, labels[rows], gen, images=images[rows], targets=targets[rows],
                 drop_scales=scales, diffkd_draws=draws)
        e1.record()
        torch.cuda.synchronize()
        launches.append(_read_launches(mods))
        ms.append(e0.elapsed_time(e1))
        first = first or {k: float(v) for k, v in m.items()}
    return dict(metrics=first, grads=applied[0].cpu(), params=state.params.cpu(),
                names=[(n, p.numel()) for n, p in state.named_params],
                launches=launches, ms=ms, peak=torch.cuda.max_memory_allocated())


def _dp_mixup(dp, rows):
    """Mixup of this rank's rows in each mode against the one-process mixup of
    the global batch on the same draws (the same bits); the ms of both."""
    import torch

    from deltakd_tpu_torch.data import mixup as tm
    from deltakd_tpu_torch.parallel import LOCAL

    g = torch.Generator(device="cuda").manual_seed(13)
    images = (torch.rand(B_MAIN, 224, 224, 3, generator=g, device="cuda") * 255).to(
        torch.bfloat16)
    labels = torch.randint(0, 100, (B_MAIN,), generator=g, device="cuda")
    out = {}
    for mode in tm.MODES:
        mc = tm.MixupConfig(num_classes=100, mode=mode)
        d = tm.draw_mixup(g, mc, B_MAIN, 224, 224, "cuda")
        mine = tm.mix_batch(images[rows], labels[rows], mc, d, dp)
        ref = tm.mix_batch(images, labels, mc, d, LOCAL)
        same = all(torch.equal(a, b[rows]) for a, b in zip(mine, ref))
        out[mode] = dict(same=same, ms=_host_ms(
            lambda: tm.mix_batch(images[rows], labels[rows], mc, d, dp), 5),
            local_ms=_host_ms(lambda: tm.mix_batch(images[rows], labels[rows], mc, d, LOCAL),
                              5))
    return out


def _dp_collectives(dp, n):
    """Host-clock ms of the step's gradient all-reduce (n fp32 values) and of
    the mixup exchange of one local batch (bf16 images and int labels)."""
    import torch

    grads = torch.ones(n, device="cuda")
    images = torch.zeros(B_MAIN // dp.world, 224, 224, 3, dtype=torch.bfloat16,
                         device="cuda")
    return dict(all_reduce_ms=_host_ms(lambda: dp.all_reduce(grads), 5),
                all_reduce_bytes=4 * n,
                exchange_ms=_host_ms(lambda: dp.swap_with_partner(images), 5),
                exchange_bytes=images.numel() * 2)


def _dp_rank(rank, port, out_dir, run_argvs):
    """One of phase 12's two processes: a gloo group on the one card, 12a, and
    with ``run_argvs`` 12b. Writes its results to out_dir/dp_rank<rank>.pt."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    from deltakd_tpu_torch import parallel
    from deltakd_tpu_torch.ops import attention as at
    from deltakd_tpu_torch.ops import fused_block as fb
    from deltakd_tpu_torch.ops import fused_mlp as fm
    from deltakd_tpu_torch.ops import sort as so
    from deltakd_tpu_torch.train import loop

    mods = (fb, so, at, fm)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=DP_WORLD, rank=rank)
    dp = parallel.current()
    rows = _dp_rows(dp.rank, dp.world)
    t0 = time.perf_counter()
    out = {name: _dp_step(mods, name, dp, rows, DP_SOFT_STEPS if name == "soft" else 1)
           for name in DP_OBJECTIVES}
    torch.cuda.empty_cache()
    out["mixup"] = _dp_mixup(dp, rows)
    out["collectives"] = _dp_collectives(dp, out["soft"]["grads"].numel())
    per_image, batch = loop.epoch_generators(42, 0, torch.device("cuda"), dp)
    out["generators"] = (torch.rand(64, generator=per_image, device="cuda").cpu(),
                         torch.rand(64, generator=batch, device="cuda").cpu())
    out["12a_s"] = time.perf_counter() - t0
    if run_argvs:
        from deltakd_tpu_torch.cli import train as train_cli

        t0 = time.perf_counter()
        out["run"] = {}
        for name, argv in run_argvs:
            probe = RunProbe(mods)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with probe:
                metrics = train_cli.main(argv)
            out["run"][name] = dict(metrics=metrics, steps=probe.step_launches,
                                    evals=probe.eval_launches, saves=len(probe.save),
                                    step_ms=probe.step_ms(),
                                    peak=torch.cuda.max_memory_allocated())
        out["12b_s"] = time.perf_counter() - t0
    torch.save(out, os.path.join(out_dir, f"dp_rank{rank}.pt"))
    dist.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_spawn(out_dir, run_argvs):
    import torch
    import torch.multiprocessing as mp

    mp.start_processes(_dp_rank, args=(_free_port(), out_dir, run_argvs), nprocs=DP_WORLD,
                       start_method="spawn")
    return [torch.load(os.path.join(out_dir, f"dp_rank{r}.pt"), weights_only=False)
            for r in range(DP_WORLD)]


def _dp_check_steps(got, mods):
    """12a's checks: each rank's applied gradient and the ranks' mean loss
    against the one-process step on the whole batch; the same bits on both
    ranks; the parameters after DP_SOFT_STEPS the same bits; 12 + 12 / 12
    block launches a step on each rank."""
    import torch

    from deltakd_tpu_torch.parallel import LOCAL

    fused = {("fused_block_fwd", 384): 12, ("fused_block_fwd", 192): 12,
             ("fused_block_bwd", 192): 12}
    for name in DP_OBJECTIVES:
        ref = _dp_step(mods, name, LOCAL, slice(0, B_MAIN), 1)
        torch.cuda.empty_cache()
        a, b = (g[name] for g in got)
        errs, offset = {}, 0
        for pname, n in ref["names"]:
            want = ref["grads"][offset:offset + n]
            errs[pname] = ((a["grads"][offset:offset + n] - want).abs().max().item()
                           / max(want.abs().max().item(), 1e-30))
            offset += n
        worst = sorted(errs, key=errs.get, reverse=True)[:3]
        err = errs[worst[0]]
        scale = (a["grads"] - ref["grads"]).abs().max().item() / ref["grads"].abs().max().item()
        loss = sum(g[name]["metrics"]["train_loss"] for g in got) / len(got)
        loss_err = abs(loss - ref["metrics"]["train_loss"]) / abs(ref["metrics"]["train_loss"])
        distill = sum(g[name]["metrics"]["distill_loss"] for g in got) / len(got)
        same = torch.equal(a["grads"], b["grads"]) and torch.equal(a["params"], b["params"])
        print(f"[dp] 12a {name}: two ranks of {B_MAIN // DP_WORLD} against one process of "
              f"{B_MAIN}: gradient max |diff| per tensor of its max |g|: "
              + ", ".join(f"{k} {errs[k]:.2e}" for k in worst)
              + f" (worst of {len(errs)}; tolerance {DP_GRAD_TOL:g}); of the whole vector's "
              f"max |g| {scale:.2e}; loss {loss:.7g} vs {ref['metrics']['train_loss']:.7g} "
              f"(relative {loss_err:.2e}, tolerance {DP_LOSS_TOL:g}); distill "
              f"{distill:.6g} vs {ref['metrics']['distill_loss']:.6g}; grad_norm "
              f"{a['metrics']['grad_norm']:.6g} vs {ref['metrics']['grad_norm']:.6g}; ranks' "
              f"gradients and parameters after {len(a['ms'])} step(s) "
              f"{'the same bits' if same else 'DIFFER'}")
        for r, g in enumerate(got):
            _check_launches(f"12a {name} rank {r}", g[name]["launches"], fused,
                            len(g[name]["ms"]))
        if err > DP_GRAD_TOL or loss_err > DP_LOSS_TOL or not same:
            raise AssertionError(f"12a {name}: the ranks' step is not the global batch's")


def _dp_check_mixup_and_generators(got):
    for mode, r in got[0]["mixup"].items():
        print(f"[dp] 12a mixup {mode}: ranks' rows against the global batch's "
              f"{'the same bits' if all(g['mixup'][mode]['same'] for g in got) else 'DIFFER'}"
              f"; {r['ms']:.3f} ms with the exchange, {r['local_ms']:.3f} ms the local "
              f"mix (host clock, rank 0)")
    if not all(g["mixup"][m]["same"] for g in got for m in g["mixup"]):
        raise AssertionError("12a: mixup across ranks is not the global batch's")
    (pa, ba), (pb, bb) = (g["generators"] for g in got)
    shared, equal = bool((pa == pb).any()), bool((ba == bb).all())
    print(f"[dp] 12a generators: per-image draws differ between ranks {not shared}, "
          f"global-batch draws equal {equal}")
    if shared or not equal:
        raise AssertionError("12a: the ranks share per-image draws or differ in the "
                             "global batch's")


def run_data_parallel(mods, smi, tmp=None, data_env=None, state_11a=None, soft_argv=None):
    """Phase 12. 12a: two processes on the one card over gloo, each B = 128 of
    one pinned global batch of 256, soft (DP_SOFT_STEPS steps), lrkd and
    diffkd (one step) at full width, against the one-process step at 256;
    mixup in its three modes across the ranks; the epoch's two generators.
    12b (with ``soft_argv``): run() under the two ranks on phase 11's CIFAR
    pickles: one epoch, resumed to a second, against two straight epochs.
    12c (with ``tmp``): ``bash soft-deit-tiny.sh 1`` (torchrun, NCCL, world
    1) for 2 epochs against phase 11a's plain run."""
    t_start = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    atexit.register(shutil.rmtree, out_dir, True)
    run_argvs = None
    if soft_argv is not None:
        run_argvs = [("one", soft_argv("dp", "--epochs", "1")),
                     ("resumed", soft_argv("dp", "--epochs", "2", "--resume", "--checkpoint",
                                           os.path.join(tmp, "dp", "checkpoint"))),
                     ("straight", soft_argv("dp_straight", "--epochs", "2"))]
    got = _dp_spawn(out_dir, run_argvs)
    print(f"[dp] the two ranks took {got[0]['12a_s']:.1f} s for 12a"
          + (f", {got[0]['12b_s']:.1f} s for 12b" if run_argvs else "")
          + " (rank 0), collectives over gloo on CUDA tensors: all_reduce (the gradient, "
            "LRKD's Gram, DiffKD's weight, the metric and eval sums, the stop flag), "
            "broadcast, all_to_all_single (mixup's exchange), barrier")
    _dp_check_steps(got, mods)
    _dp_check_mixup_and_generators(got)
    for r, g in enumerate(got):
        c = g["collectives"]
        print(f"[dp] {smi}: rank {r}: soft step {_median(g['soft']['ms']):.2f} ms (median of "
              f"{len(g['soft']['ms'])}, CUDA events, two processes sharing the card), lrkd "
              f"{g['lrkd']['ms'][0]:.2f} ms, diffkd {g['diffkd']['ms'][0]:.2f} ms; peak "
              f"allocated {max(g[n]['peak'] for n in DP_OBJECTIVES) / 2**30:.3f} GiB; gradient "
              f"all-reduce {c['all_reduce_ms']:.2f} ms for {c['all_reduce_bytes']} bytes, mixup "
              f"exchange {c['exchange_ms']:.2f} ms for {c['exchange_bytes']} bytes (gloo, host "
              f"clock)")
    if run_argvs:
        fused = {("fused_block_fwd", 384): 12, ("fused_block_fwd", 192): 12,
                 ("fused_block_bwd", 192): 12}
        steps = int(RUNTIME_TRAIN // 256 * 256 / DP_WORLD) // B_MAIN    # the RASampler's
        runs = [g["run"] for g in got]
        for r, run in enumerate(runs):
            _check_launches(f"12b rank {r} one epoch", run["one"]["steps"], fused, steps)
            _check_launches(f"12b rank {r} straight", run["straight"]["steps"], fused,
                            2 * steps)
        saves = [sum(run[n]["saves"] for n in run) for run in runs]
        same_val = all(runs[0][n]["metrics"] == runs[1][n]["metrics"] for n in runs[0])
        same, step = _same_state(os.path.join(tmp, "dp_straight", "checkpoint", "state-2"),
                                 os.path.join(tmp, "dp", "checkpoint", "state-2"))
        print(f"[dp] 12b run() on two ranks: {steps} steps an epoch each (the RASampler), "
              f"val metrics {runs[0]['straight']['metrics']} "
              f"{'equal' if same_val else 'DIFFER'} on both ranks; checkpoint saves by rank "
              f"{saves}; resumed against straight after {step} steps: "
              f"{'the same bits' if same else 'DIFFER'}")
        for r, run in enumerate(runs):
            ms = run["straight"]["step_ms"]
            print(f"[dp] {smi}: 12b rank {r}: run() train step {_median(ms):.2f} ms (median of "
                  f"{len(ms)}, CUDA events, two processes sharing the card); peak allocated "
                  f"{run['straight']['peak'] / 2**30:.3f} GiB")
        if not same_val or saves[1] != 0 or saves[0] != 4 or not same:
            raise AssertionError("12b: run() on two ranks failed its checks")
    if data_env is not None:
        t0 = time.perf_counter()
        root = os.path.dirname(os.path.abspath(__file__))
        extra = ["--save-dir", os.path.join(tmp, "nccl"), "--log-file",
                 os.path.join(tmp, "logs", "nccl"), "--log-every", "1000", "--epochs", "2"]
        proc = subprocess.run(
            ["bash", os.path.join(root, "deltakd_tpu_torch", "exp", "soft-deit-tiny.sh"), "1"],
            env={**os.environ, **data_env, "EXTRA_FLAGS": " ".join(extra),
                 "PYTHONPATH": root}, cwd=root, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:])
            raise AssertionError(f"12c: soft-deit-tiny.sh 1 exited {proc.returncode}")
        same, step = _same_state(state_11a, os.path.join(tmp, "nccl", "checkpoint", "state-2"))
        nccl = [line for line in proc.stdout.splitlines() + proc.stderr.splitlines()
                if "data axis of" in line]
        print(f"[dp] 12c soft-deit-tiny.sh 1 (torchrun --standalone --nproc_per_node 1, NCCL) "
              f"in {time.perf_counter() - t0:.1f} s: {nccl[:1]}; parameters, Adam moments and "
              f"{step} steps against phase 11a's plain run: "
              f"{'the same bits' if same else 'DIFFER'}")
        if not same:
            raise AssertionError("12c: torchrun at world 1 differs from the plain run")
    print(f"[dp] {smi}: phase 12 took {time.perf_counter() - t_start:.1f} s")


# ---------------------------------------------------------------------------
# Phase 15: tensor parallelism (the model mesh axis), ranks sharing the card
# over gloo (15a, 15d, 15e), run() at mesh (1, 2) (15c)
# ---------------------------------------------------------------------------
TP_BATCH = 32         # 15a: the global batch (gloo moves every collective through the host)
TP_STEPS = 3          # 15a: steps at each dtype (the ms is the median of steps 2-3)
# 15a: the two ranks' step against the one-process unfused step on the same
# weights and draws: per parameter tensor, max |gathered TP gradient - one
# process's| over the tensor's max |g|; the loss and grad norm relative; the
# parameters after the step per tensor over their max |value|. In bf16 the
# row-parallel proj and fc2 products round each rank's partial sum to bf16
# before the reduce (the one process rounds the whole sum once), and the
# column-parallel input gradients likewise: about one bf16 ulp (2^-8) of each
# partial in every block's output and input gradient, which the chain of 12
# blocks carries into every weight gradient. In fp32 every product is fp32
# (the kernels 3xTF32) and only the order of the sums differs. Measured (one
# H100): 1.84e-2 bf16 (a LayerNorm gain's), 5.7e-6 fp32 (the dist head's).
TP_GRAD_TOL = {"bfloat16": 5e-2, "float32": 1e-4}
TP_LOSS_TOL = {"bfloat16": 5e-3, "float32": 1e-5}
# 15e (4, 2): the dry run's widths (depth 3, D = 64 / 128, 4 heads, 32 px;
# head dim 16 and 32, which the attention kernel does not take, so the models
# run PyTorch's own ops as the JAX dry run runs its plain modules), fp32: only
# the order of the sums differs from the one process. (8, 1): the dry run's
# fused case at DeiT widths (D = 192 / 384, 3 / 6 heads, head dim 64, depth
# 3), so that the block kernels run, in bf16 under phase 12's bounds, in
# phase 12's regime: 224 px and the main path's global batch (B_MAIN a
# micro-batch, 32 images a rank). Those bounds hold where a rank's gradient
# sums run over many images (phase 12: 128 a rank). At the dry run's 2
# images a rank and micro-batch the per-tensor error grows: each rank rounds
# its partial gradient of the parameters PyTorch's bf16 ops use (tokens,
# patch embedding, heads) to bf16 before the all-reduce, and cuBLAS's
# products, whose order of sums changes with the row count, round the
# blocks' cotangents one bf16 ulp apart; eight such small partials read
# 1.26e-2 (the dist token's) at 224 px and 1.23e-2 (a LayerNorm gain's) at
# 32 px on one H100, above DP_GRAD_TOL, with the loss within 5e-8
TP_DRY_TOL = 1e-4
TP_DRY = (("mgd", False, 1, {}), ("soft", True, 2, {}),
          ("wasskd", False, 1, {"wasskd_type": "sinkhorn", "sinkhorn_iters": 8}))
TP_DRY_MODELS = {"tp_dry_student": dict(embed_dim=64, num_heads=4, distilled=False),
                 "tp_dry_student_distilled": dict(embed_dim=64, num_heads=4, distilled=True),
                 "tp_dry_teacher": dict(embed_dim=128, num_heads=4, distilled=True),
                 "tp_dry_deit_student": dict(embed_dim=192, num_heads=3, distilled=True,
                                             img_size=224),
                 "tp_dry_deit_teacher": dict(embed_dim=384, num_heads=6, distilled=True,
                                             img_size=224)}
TP_WORLD = 8          # 15e's ranks
TP_FUSED_ACCUM = 2
# 15c: run() at (1, 2) against one process at fp32, B = 32, 4 steps, 2 eval batches
TP_RUN_FLAGS = ("--dtype", "float32", "--batch-size", "32", "--steps-per-epoch", "4",
                "--eval-steps", "2", "--mesh-shape", "1", "2")
# val_loss, relative; val_acc1 within one of the 64 images. After 4 steps the
# student (random weights) classifies one of the 64 images or none on either
# side (val_acc1 1.562 and 0 on the H100), so val_loss is the comparison that
# carries 15c; the val_acc1 bound only catches a gross fault
TP_RUN_TOL = 1e-4
TP_RUN_IMAGES = 64


def _tp_launches(dtype, M=2, B=TP_BATCH):
    """A TP step's launches a rank at a model axis of M (2, 4 or 8): DeiT-S's
    6 heads split 6/M a rank where M divides them, else all 6 on each rank
    (the gather route), DeiT-Ti's 3 heads all on each rank; the teacher's MLP
    on its F/M hidden columns (counted by D = 384; F/8 = 192 at M = 8)."""
    form = "_f32" if dtype == "float32" else ""
    out = collections.Counter()
    out[(f"flash_fwd{form}", B * (6 // M if 6 % M == 0 else 6))] += 12
    out[(f"flash_fwd{form}", B * 3)] += 12
    out[(f"flash_bwd{form}", B * 3)] += 12
    out[(f"fused_mlp_fwd{form}", 384)] += 12
    return dict(out)


# 15d, 15e: the student's eval view at a model axis of 4 (8) runs every
# block's MLP kernel on F/4 = 192 (F/8 = 96) hidden columns (one warpgroup's
# plan, hidden chunks of 64; at F/8 one 64-wide chunk and the 32-wide tail)
# and its attention on all 3 heads
TP_EVAL_LAUNCHES = {("flash_fwd", TP_BATCH * 3): 12, ("fused_mlp_fwd", 192): 12}


def _tp_config(dtype, mesh_shape=(1, 2), **extra):
    from deltakd_tpu_torch.configs.config import TrainConfig

    options = dict(teacher_model="deit_small_distilled_patch16_224",
                   student_model="deit_tiny_distilled_patch16_224", batch_size=TP_BATCH,
                   distillation_type="soft", dataset="cifar-100", input_size=224,
                   dtype=dtype, drop_path_rate=0.1, epochs=300, aa="", color_jitter=0.0,
                   allow_random_teacher=True, mesh_shape=mesh_shape)
    return TrainConfig(**dict(options, **extra))


def _full(state, t):
    """``t`` (a flat vector of ``state``'s layout) in the full layout, on the CPU."""
    return (t if state.shards is None else state.shards.gather(t)).cpu()


def _tp_result(state, first, applied, params, launches, ms):
    """What a TP (or one-process) run of a step gives the checks: the metrics
    and the applied gradient of the first step, ``params`` (the parameters
    after it in the full layout), the local parameters after the last step
    and which are shards."""
    import torch

    shapes = ([p.shape for _, p in state.named_params] if state.shards is None
              else state.shards.full_shapes)
    return dict(metrics=first, grads=_full(state, applied[0]), params=params,
                local=state.params.cpu(),
                sharded=None if state.shards is None else state.shards.mask.cpu(),
                names=[(n, math.prod(s)) for (n, _), s in zip(state.named_params, shapes)],
                launches=launches, ms=ms, peak=torch.cuda.max_memory_allocated())


def _tp_step(mods, dtype, mesh, steps, kd_type="soft", evaluate=False):
    """15a: ``steps`` train steps of ``kd_type`` (soft, or wasskd: l1, its
    aux heads replicated) of the full-width models at ``dtype`` on ``mesh``
    (or one process with ``mesh`` None: the unfused path, whole models), on
    one pinned batch made from a seed on the card: images, targets,
    drop-path scales. With ``evaluate`` (15d), then the student's eval view
    (``train.loop.eval_view``, as validate runs it) on the same images: its
    logits and launches as ``eval``."""
    import torch

    from deltakd_tpu_torch.train.loop import eval_view

    from deltakd_tpu_torch.data.augment import AugmentConfig
    from deltakd_tpu_torch.kd.losses import KDSettings
    from deltakd_tpu_torch.models.factory import load_teacher_student
    from deltakd_tpu_torch.train.optim import make_optimizer
    from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
    from deltakd_tpu_torch.train.step import build_train_step

    cfg = _tp_config(dtype, (1, 2) if mesh is None else mesh.shape, distillation_type=kd_type)
    teacher, student, aux = load_teacher_student(cfg, seed=0, device="cuda", mesh=mesh)
    tx = make_optimizer(cfg, trainable_parameters(student, aux), 100)
    state = TrainState(student, tx=tx, aux=aux)
    applied = []
    apply = state.apply_gradients
    state.apply_gradients = lambda *, grads, **kw: (
        applied.append(grads.detach().clone()) if not applied else None,
        apply(grads=grads, **kw))
    kd = KDSettings.from_config(cfg, student_prefix=2, teacher_prefix=2)
    step = build_train_step(cfg=cfg, kd=kd, student=student, teacher=teacher, aux=aux,
                            aug=AugmentConfig.from_config(cfg), mixup=None, tx=tx,
                            dp=None if mesh is None else mesh.data)
    g = torch.Generator(device="cuda").manual_seed(15)
    images = torch.randn(TP_BATCH, 224, 224, 3, generator=g, device="cuda")
    targets = torch.softmax(3.0 * torch.randn(TP_BATCH, 100, generator=g, device="cuda"), -1)
    labels = torch.randint(0, 100, (TP_BATCH,), generator=g, device="cuda")
    scales = student.draw_drop_scales(TP_BATCH, g, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches, ms, first, params = [], [], None, None
    for _ in range(steps):
        _reset_launches(mods)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        m = step(state, None, labels, gen, images=images, targets=targets,
                 drop_scales=scales)
        e1.record()
        torch.cuda.synchronize()
        launches.append(_read_launches(mods))
        ms.append(e0.elapsed_time(e1))
        if first is None:
            first, params = {k: float(v) for k, v in m.items()}, _full(state, state.params)
    out = _tp_result(state, first, applied, params, launches, ms)
    if evaluate:
        _reset_launches(mods)
        with torch.no_grad():
            logits = eval_view(student)(images.to(student.dtype), train=False).logits
        out["eval"] = dict(logits=logits.float().cpu(), launches=_read_launches(mods))
    return out


def _register_dry_models():
    from deltakd_tpu_torch.models import registry
    from deltakd_tpu_torch.models.vit import ViTConfig

    for name, kw in TP_DRY_MODELS.items():
        registry.MODEL_REGISTRY[name] = ViTConfig(**dict(dict(img_size=32, depth=3), **kw))


def _tp_dry_step(kd_type, distilled, accum, extra, mesh, mods=None):
    """15e: one step of the JAX dry run's case on ``mesh`` (TP_WORLD ranks),
    each data rank on its rows of the global batch (2 images a rank and
    micro-batch; fused: B_MAIN a micro-batch), or the one process on all of
    it (``mesh`` None); images,
    targets, drop-path scales and masking noise pinned from a seed. At (4, 2)
    the dry run's models with PyTorch's own ops at fp32, then the masked eval
    step on the data rank's rows of uint8 images, the last 3 of the batch
    invalid, summed over the data ranks (as ``eval``); with ``mods``, the
    fused case at (8, 1): DeiT widths at 224 px, the block kernels in bf16,
    the launches of the step."""
    import torch

    from deltakd_tpu_torch.configs.config import TrainConfig
    from deltakd_tpu_torch.data.augment import AugmentConfig
    from deltakd_tpu_torch.kd.losses import KDSettings
    from deltakd_tpu_torch.models.factory import load_teacher_student
    from deltakd_tpu_torch.train.loop import eval_view
    from deltakd_tpu_torch.train.optim import make_optimizer
    from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
    from deltakd_tpu_torch.train.step import build_eval_step, build_train_step

    fused = mods is not None
    batch = (B_MAIN if fused else 2 * TP_WORLD) * accum
    img = 224 if fused else 32
    prefix = "tp_dry_deit_" if fused else "tp_dry_"
    cfg = TrainConfig(teacher_model=prefix + "teacher",
                      student_model=prefix + "student" + ("" if fused or not distilled
                                                          else "_distilled"),
                      input_size=img, batch_size=batch, epochs=5, warmup_epochs=1,
                      dtype="bfloat16" if fused else "float32",
                      drop_path_rate=0.0 if accum > 1 else 0.1,
                      distillation_type=kd_type, grad_accum_steps=accum, dataset="cifar-100",
                      allow_random_teacher=True, aa="", color_jitter=0.0,
                      mesh_shape=(TP_WORLD, 1) if fused else (TP_WORLD // 2, 2), **extra)
    kw = {} if fused else {"attention_fn": None}
    teacher, student, aux = load_teacher_student(cfg, seed=0, device="cuda", mesh=mesh, **kw)
    tx = make_optimizer(cfg, trainable_parameters(student, aux), 4)
    state = TrainState(student, tx=tx, aux=aux)
    applied = []
    apply = state.apply_gradients
    state.apply_gradients = lambda *, grads, **kw: (applied.append(grads.detach().clone()),
                                                    apply(grads=grads, **kw))
    dp = None if mesh is None else mesh.data
    step = build_train_step(
        cfg=cfg, kd=KDSettings.from_config(cfg, student_prefix=student.cfg.num_prefix_tokens,
                                           teacher_prefix=2),
        student=student, teacher=teacher, aux=aux, aug=AugmentConfig.from_config(cfg),
        mixup=None, tx=tx, dp=dp)
    g = torch.Generator(device="cuda").manual_seed(16)
    images = torch.randn(batch, img, img, 3, generator=g, device="cuda")
    targets = torch.softmax(3.0 * torch.randn(batch, 100, generator=g, device="cuda"), -1)
    labels = torch.randint(0, 100, (batch,), generator=g, device="cuda")
    noise = torch.rand(batch, 4, generator=g, device="cuda")
    scales = student.draw_drop_scales(batch, g, "cuda")
    u8 = torch.randint(0, 256, (batch, 32, 32, 3), generator=g, device="cuda",
                       dtype=torch.uint8)
    D = 1 if mesh is None else mesh.data.world
    d = 0 if mesh is None else mesh.data.rank
    mb = batch // accum // D
    rows = torch.cat([torch.arange(i * batch // accum + d * mb, i * batch // accum + (d + 1) * mb)
                      for i in range(accum)]).cuda()
    pinned = dict(targets=targets[rows])   # drop-path and noise pinned without accumulation
    if accum == 1:
        pinned.update(drop_scales=[None if s is None else tuple(x[rows] for x in s)
                                   for s in scales],
                      mask_noise=noise[rows] if kd_type == "mgd" else None)
    if fused:
        _reset_launches(mods)
    m = step(state, None, labels[rows], torch.Generator(device="cuda").manual_seed(4),
             images=images[rows], **pinned)
    torch.cuda.synchronize()
    out = _tp_result(state, {k: float(v) for k, v in m.items()}, applied,
                     _full(state, state.params), [_read_launches(mods)] if fused else [], [])
    if not fused:
        b = batch // D
        mine = slice(d * b, (d + 1) * b)
        sums = build_eval_step(student=eval_view(student), aug=AugmentConfig.from_config(cfg))(
            u8[mine], labels[mine], (torch.arange(batch, device="cuda") < batch - 3)[mine])
        names = sorted(sums)
        total = torch.stack([sums[k].float() for k in names])
        if mesh is not None:
            mesh.data.all_reduce(total)
        out["eval"] = dict(zip(names, total.tolist()))
    return out


def _tp_collectives(mesh):
    """Host-clock ms and bytes of the model group's collectives at 15a's
    shapes: the row-parallel reduce of the teacher's [B, N, 384] fp32 partial,
    the student's [B, N, 192], and the gather of the student's qkv columns
    [B, N, 288] in bf16 (the gather route)."""
    import torch

    tp = mesh.model
    out = {}
    for name, shape, dtype in (("reduce teacher", (TP_BATCH, N_TOK, 384), torch.float32),
                               ("reduce student", (TP_BATCH, N_TOK, 192), torch.float32),
                               ("gather qkv", (TP_BATCH, N_TOK, 288), torch.bfloat16)):
        t = torch.ones(shape, dtype=dtype, device="cuda")
        fn = (lambda t=t: tp.all_reduce(t)) if name.startswith("reduce") else (
            lambda t=t: tp.all_gather(t))
        out[name] = (_host_ms(fn, 5), t.numel() * t.element_size())
    return out


class _SaveWrites:
    """Records run()'s checkpoint saves as (epoch, whether this rank wrote)."""

    def __init__(self):
        from deltakd_tpu_torch.train import loop

        self.loop, self.saves = loop, []

    def __enter__(self):
        real = self._real = self.loop.save_checkpoint

        def save_checkpoint(*args, **kw):
            self.saves.append((kw["epoch"], kw.get("write", True)))
            return real(*args, **kw)

        self.loop.save_checkpoint = save_checkpoint
        return self

    def __exit__(self, *exc):
        self.loop.save_checkpoint = self._real


def _tp_round_trip(argv, src, dst, mesh):
    """Loads checkpoint ``src`` into the state of ``argv``'s config on
    ``mesh`` (each rank cuts its shards) and saves it to ``dst`` at once
    (gathered again; rank 0 writes)."""
    from deltakd_tpu_torch.ckpt.checkpoint import load_checkpoint, save_checkpoint
    from deltakd_tpu_torch.configs.config import parse_args
    from deltakd_tpu_torch.models.factory import load_teacher_student
    from deltakd_tpu_torch.train.optim import make_optimizer
    from deltakd_tpu_torch.train.state import TrainState, trainable_parameters

    cfg = parse_args(argv)
    _, student, aux = load_teacher_student(cfg, seed=cfg.seed, device="cuda", mesh=mesh)
    tx = make_optimizer(cfg, trainable_parameters(student, aux), 4)
    state = TrainState(student, tx=tx, aux=aux, ema_decay=cfg.ema_decay)
    state, epoch, best = load_checkpoint(src, state)
    save_checkpoint(dst, state, epoch=epoch, best_acc=best, is_best=False,
                    write=mesh is None or mesh.is_main)


def _tp_rank(rank, world, port, out_dir, tasks):
    """One of phase 15's processes: a gloo group of ``world`` on the one card
    and the mesh of ``tasks["mesh"]``; 15a, 15c, 15d or 15e as ``tasks``
    says. Writes its results to out_dir/tp_rank<rank>.pt."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    from deltakd_tpu_torch import parallel
    from deltakd_tpu_torch.ops import attention as at
    from deltakd_tpu_torch.ops import fused_block as fb
    from deltakd_tpu_torch.ops import fused_mlp as fm
    from deltakd_tpu_torch.ops import sort as so

    mods = (fb, so, at, fm)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    mesh = parallel.make_mesh(tasks["mesh"], parallel.current())
    out = {"mesh": (mesh.data.rank, mesh.model.rank)}
    t0 = time.perf_counter()
    if "15a" in tasks:
        for dtype in ("bfloat16", "float32"):
            out[dtype] = _tp_step(mods, dtype, mesh, TP_STEPS)
            torch.cuda.empty_cache()
        out["wasskd"] = _tp_step(mods, "bfloat16", mesh, 1, "wasskd")
        out["collectives"] = _tp_collectives(mesh)
        out["15a_s"] = time.perf_counter() - t0
    if "15e" in tasks:   # eight ranks at (4, 2), then (8, 1), then (1, 8)
        _register_dry_models()
        for kd_type, distilled, accum, extra in TP_DRY:
            out[kd_type] = _tp_dry_step(kd_type, distilled, accum, extra, mesh)
        out["fused"] = _tp_dry_step("soft", True, TP_FUSED_ACCUM, {},
                                    parallel.make_mesh((TP_WORLD, 1), parallel.current()), mods)
        out["15e_dry_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["15e"] = _tp_step(mods, "bfloat16",
                              parallel.make_mesh((1, TP_WORLD), parallel.current()), 1,
                              evaluate=True)
        out["15e_s"] = time.perf_counter() - t0
    if "15d" in tasks:   # four ranks as one data row at a model axis of 4
        t0 = time.perf_counter()
        out["15d"] = _tp_step(mods, "bfloat16", parallel.make_mesh((1, 4), parallel.current()),
                              1, evaluate=True)
        out["15d_s"] = time.perf_counter() - t0
    if "15c" in tasks:
        from deltakd_tpu_torch.cli import train as train_cli

        t0 = time.perf_counter()
        c = tasks["15c"]
        with _SaveWrites() as rec:
            out["run"] = train_cli.main(c["tp"])
            out["resumed"] = train_cli.main(c["resume"])
        out["saves"] = rec.saves
        _tp_round_trip(c["tp"], c["one_ckpt"], c["round_trip"], mesh)
        out["15c_s"] = time.perf_counter() - t0
    torch.save(out, os.path.join(out_dir, f"tp_rank{rank}.pt"))
    dist.destroy_process_group()


def _tp_spawn(world, out_dir, tasks):
    import torch
    import torch.multiprocessing as mp

    mp.start_processes(_tp_rank, args=(world, _free_port(), out_dir, tasks), nprocs=world,
                       start_method="spawn")
    return [torch.load(os.path.join(out_dir, f"tp_rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _tp_errors(got, ref):
    """Per parameter tensor: max |got - ref| of the gathered gradient over the
    tensor's max |g|, and of the parameters after the first step over the
    largest |parameter| (a zero-initialised bias is +-lr after AdamW's first
    step, its sign the gradient's, which flips where a gradient is near 0)."""
    errs = {"grad": {}, "param": {}}
    largest = ref["params"].abs().max().item()
    offset = 0
    for pname, n in ref["names"]:
        part = slice(offset, offset + n)
        want = ref["grads"][part]
        errs["grad"][pname] = ((got["grads"][part] - want).abs().max().item()
                               / max(want.abs().max().item(), 1e-30))
        errs["param"][pname] = (got["params"][part] - ref["params"][part]).abs().max().item(
            ) / largest
        offset += n
    return errs


def _tp_hold(what, got, ref, grad_tol, loss_tol, ranks_of_row):
    """Holds each rank's gathered gradient and parameters and the data ranks'
    mean loss against the one process; the replicated tensors the same bits
    on the model ranks of each data row, the gathered gradients and
    parameters the same bits on every rank. Returns the worst gradient error."""
    import torch

    worst = 0.0
    for r, g in enumerate(got):
        errs = _tp_errors(g, ref)
        top = sorted(errs["grad"], key=errs["grad"].get, reverse=True)[:3]
        worst = max(worst, errs["grad"][top[0]], max(errs["param"].values()))
        if r == 0:
            print(f"[tp] {what}: gathered gradient max |diff| per tensor of its max |g|: "
                  + ", ".join(f"{k} {errs['grad'][k]:.2e}" for k in top)
                  + f" (worst of {len(errs['grad'])}; limit {grad_tol:g}); parameters after "
                  f"the first step, per tensor of the largest |p|: "
                  f"{max(errs['param'].values()):.2e}")
    loss = sum(g["metrics"]["train_loss"] for g in got) / len(got)
    loss_err = abs(loss - ref["metrics"]["train_loss"]) / abs(ref["metrics"]["train_loss"])
    norm_err = abs(got[0]["metrics"]["grad_norm"] - ref["metrics"]["grad_norm"]) / abs(
        ref["metrics"]["grad_norm"])
    def replicated(g):   # every tensor without a model axis
        return g["local"] if g["sharded"] is None else g["local"][~g["sharded"]]

    same = all(torch.equal(replicated(g), replicated(got[row[0]]))
               for row in ranks_of_row for g in (got[r] for r in row))
    same = same and all(torch.equal(g["grads"], got[0]["grads"])
                        and torch.equal(g["params"], got[0]["params"]) for g in got)
    print(f"[tp] {what}: loss {loss:.7g} vs {ref['metrics']['train_loss']:.7g} (relative "
          f"{loss_err:.2e}, limit {loss_tol:g}); grad_norm {got[0]['metrics']['grad_norm']:.7g} "
          f"vs {ref['metrics']['grad_norm']:.7g} (relative {norm_err:.2e}); replicated "
          f"tensors on a data row's model ranks and the gathered state on every rank "
          f"{'the same bits' if same else 'DIFFER'}")
    if worst > grad_tol or loss_err > loss_tol or norm_err > grad_tol or not same:
        raise AssertionError(f"{what}: the TP step is not the one-process step")
    return worst


def _tp_close(what, got, want):
    """run()'s val_loss within TP_RUN_TOL and val_acc1 within one image (both
    sides classify one image or none after 15c's 4 steps: val_loss carries
    the comparison)."""
    loss_err = abs(got["val_loss"] - want["val_loss"]) / abs(want["val_loss"])
    acc_err = abs(got["val_acc1"] - want["val_acc1"])
    ok = loss_err <= TP_RUN_TOL and acc_err <= 100.0 / TP_RUN_IMAGES + 1e-9
    print(f"[tp] {what}: val_loss {got['val_loss']:.7g} vs {want['val_loss']:.7g} (relative "
          f"{loss_err:.2e}, limit {TP_RUN_TOL:g}), val_acc1 {got['val_acc1']:.4g} vs "
          f"{want['val_acc1']:.4g} (limit one of {TP_RUN_IMAGES} images) "
          f"{'ok' if ok else 'FAIL'}")
    return ok


def _tp_hold_eval(what, got, ref, count):
    """15e's masked eval sums (each rank's: the data ranks' sum) against the
    one process's: the count exact (``count``, the batch less 3), the loss
    sum within TP_DRY_TOL, the top-1 and top-5 counts within one image (a
    near-tie of two logits may flip under another order of the sums)."""
    loss_err = max(abs(g["loss_sum"] - ref["loss_sum"]) for g in got) / abs(ref["loss_sum"])
    top = max(abs(g[k] - ref[k]) for g in got for k in ("correct1", "correct5"))
    ok = (all(g["count"] == count for g in got) and ref["count"] == count
          and loss_err <= TP_DRY_TOL and top <= 1)
    print(f"[tp] {what} masked eval: count {got[0]['count']:.0f} (batch less 3), loss_sum "
          f"{got[0]['loss_sum']:.7g} vs {ref['loss_sum']:.7g} (relative {loss_err:.2e}, limit "
          f"{TP_DRY_TOL:g}), correct1 {got[0]['correct1']:.0f} vs {ref['correct1']:.0f}, "
          f"correct5 {got[0]['correct5']:.0f} vs {ref['correct5']:.0f} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the masked eval is not the one process's")


def run_eight_ranks(mods, smi, out_dir, ref_full):
    """15e: eight processes sharing the card over gloo, as the JAX package's
    eight-device meshes: at (4, 2) the dry run's cases and their masked eval,
    at (8, 1) its fused case at DeiT widths in bf16, at (1, 8) the full-width
    bf16 soft step (against ``ref_full``, 15a's one-process unfused step) and
    the student's eval view. Returns the worst gradient error of each bf16
    comparison."""
    t0 = time.perf_counter()
    got = _tp_spawn(TP_WORLD, out_dir, {"mesh": (TP_WORLD // 2, 2), "15e": True})
    spawn_s = time.perf_counter() - t0
    _register_dry_models()
    rows_42 = [(r, r + 1) for r in range(0, TP_WORLD, 2)]
    for kd_type, distilled, accum, extra in TP_DRY:
        ref = _tp_dry_step(kd_type, distilled, accum, extra, None)
        what = f"15e {kd_type} (accum {accum}{', ' + str(extra) if extra else ''}), mesh (4, 2)"
        _tp_hold(what, [g[kd_type] for g in got], ref, TP_DRY_TOL, TP_DRY_TOL, rows_42)
        _tp_hold_eval(what, [g[kd_type]["eval"] for g in got], ref["eval"],
                      2 * TP_WORLD * accum - 3)
    worst = {}
    ref = _tp_dry_step("soft", True, TP_FUSED_ACCUM, {}, None, mods)
    ranks = [g["fused"] for g in got]
    worst["bfloat16 fused (8, 1)"] = _tp_hold(
        f"15e bfloat16 fused soft step (accum {TP_FUSED_ACCUM}, DeiT widths, depth 3, 224 px, "
        f"B={B_MAIN} a micro-batch), mesh ({TP_WORLD}, 1)", ranks, ref, DP_GRAD_TOL, DP_LOSS_TOL,
        [(r,) for r in range(TP_WORLD)])
    n = 3 * TP_FUSED_ACCUM
    want = {("fused_block_fwd", 384): n, ("fused_block_fwd", 192): n, ("fused_block_bwd", 192): n}
    _check_launches("15e one-process fused step", ref["launches"], want, 1)
    for r, g in enumerate(ranks):
        _check_launches(f"15e fused rank {r}", g["launches"], want, 1)
    print(f"[tp] 15e fused: launches a step and rank {ranks[0]['launches'][0]}")
    ranks = [g["15e"] for g in got]
    worst["bfloat16 (1, 8)"] = _tp_hold(
        f"15e bfloat16 soft step, mesh (1, {TP_WORLD}), B={TP_BATCH}", ranks, ref_full,
        TP_GRAD_TOL["bfloat16"], TP_LOSS_TOL["bfloat16"], [tuple(range(TP_WORLD))])
    for r, g in enumerate(ranks):
        _check_launches(f"15e rank {r}", g["launches"], _tp_launches("bfloat16", TP_WORLD), 1)
        _check_launches(f"15e rank {r} eval view", [g["eval"]["launches"]],
                        TP_EVAL_LAUNCHES, 1)
        _agree(f"15e rank {r} eval-view logits at mesh (1, {TP_WORLD})", g["eval"]["logits"],
               ref_full["eval"]["logits"], (TP_BATCH, 100), other="the one-process eval view")
    print(f"[tp] {smi}: 15e: the eight ranks took {spawn_s:.1f} s with their start (rank 0: "
          f"(4, 2) and (8, 1) {got[0]['15e_dry_s']:.1f} s, (1, 8) {got[0]['15e_s']:.1f} s); "
          f"(1, 8) TP step {ranks[0]['ms'][0]:.2f} ms a rank (its first, CUDA events; eight "
          f"processes sharing the card, every collective through the host over gloo: not a "
          f"TP speed); launches a step and rank {ranks[0]['launches'][0]}; the eval view's "
          f"{ranks[0]['eval']['launches']}; NCCL across eight cards not run (one card)")
    return worst


def run_tensor_parallel(mods, smi, soft_argv=None, tmp=None):
    """Phase 15. 15a: two processes on the one card over gloo at mesh (1, 2),
    DeiT-S-distilled teacher (6 heads, 3 a rank) and DeiT-Ti-distilled student
    (3 heads: the gather route), 224 px, global B = TP_BATCH, soft KD, bf16 then
    fp32, against the one-process unfused step; the launches a step and rank;
    the model group's collectives timed. 15d: four processes at (1, 4), the
    bf16 step and the student's eval view. 15e: eight processes: at (4, 2)
    the JAX dry run's cases at its widths (mgd, soft with grad_accum_steps=2,
    wasskd-sinkhorn), each with its masked eval, against one process on the
    global batch; at (8, 1) its fused case at DeiT widths in bf16; at (1, 8)
    the full-width bf16 step and the eval view. 15c (with
    ``soft_argv``): run() at (1, 2) against one process on phase 11's pickles
    at fp32, B = 32, for one epoch; rank 0 alone writes; a one-process
    checkpoint resumed at (1, 2) for a second epoch against the one process's
    own resume; each side's checkpoint loaded and saved again on the other
    side the same bits."""
    import torch

    t_start = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    atexit.register(shutil.rmtree, out_dir, True)
    tasks = {"mesh": (1, 2), "15a": True}
    if soft_argv is not None:
        from deltakd_tpu_torch.cli import train as train_cli

        one = soft_argv("tp_one", "--epochs", "1", *TP_RUN_FLAGS)
        one_ckpt = os.path.join(tmp, "tp_one", "checkpoint")
        one_run = train_cli.main(one)
        shutil.copytree(os.path.join(tmp, "tp_one"), os.path.join(tmp, "tp_one_copy"))
        tasks["15c"] = dict(
            tp=soft_argv("tp_two", "--epochs", "1", *TP_RUN_FLAGS),
            resume=soft_argv("tp_one_copy", "--epochs", "2", "--resume", "--checkpoint",
                             os.path.join(tmp, "tp_one_copy", "checkpoint"), *TP_RUN_FLAGS),
            one_ckpt=one_ckpt, round_trip=os.path.join(tmp, "tp_round_trip"))
    got = got_a = _tp_spawn(2, out_dir, tasks)
    print(f"[tp] 15a: the two ranks took {got[0]['15a_s']:.1f} s"
          + (f", 15c {got[0]['15c_s']:.1f} s" if "15c" in tasks else "")
          + " (rank 0)")
    worst, refs = {}, {}
    for dtype in ("bfloat16", "float32"):
        ref = refs[dtype] = _tp_step(mods, dtype, None, 1, evaluate=dtype == "bfloat16")
        torch.cuda.empty_cache()
        ranks = [g[dtype] for g in got]
        worst[dtype] = _tp_hold(f"15a {dtype} soft step, mesh (1, 2), B={TP_BATCH}", ranks,
                                ref, TP_GRAD_TOL[dtype], TP_LOSS_TOL[dtype], [(0, 1)])
        for r, g in enumerate(ranks):
            _check_launches(f"15a {dtype} rank {r}", g["launches"], _tp_launches(dtype),
                            TP_STEPS)
        print(f"[tp] {smi}: 15a {dtype}: TP step {_median(ranks[0]['ms'][1:]):.2f} ms a rank "
              f"(median of steps 2-{TP_STEPS}, CUDA events; two processes sharing the card, "
              f"every model-group collective through the host over gloo: not a TP speed); "
              f"one-process unfused step {ref['ms'][0]:.2f} ms (first step); launches a step "
              f"and rank {ranks[0]['launches'][0]}; peak allocated "
              f"{ranks[0]['peak'] / 2**30:.3f} GiB a rank")
    ref = _tp_step(mods, "bfloat16", None, 1, "wasskd")
    torch.cuda.empty_cache()
    ranks = [g["wasskd"] for g in got]
    worst["wasskd"] = _tp_hold(f"15a bfloat16 wasskd-l1 step, mesh (1, 2), B={TP_BATCH}",
                               ranks, ref, TP_GRAD_TOL["bfloat16"], TP_LOSS_TOL["bfloat16"],
                               [(0, 1)])
    for r, g in enumerate(ranks):   # rows 10 and 11 on the replicated features
        _check_launches(f"15a wasskd rank {r}", g["launches"], dict(
            _tp_launches("bfloat16"), sorted_l1_fwd=3, sorted_l1_bwd=3), 1)
    print(f"[tp] 15a wasskd-l1: launches a step and rank {ranks[0]['launches'][0]}")
    c = got[0]["collectives"]
    print(f"[tp] {smi}: 15a model-group collectives (gloo through the host on one card, "
          f"host clock, rank 0): " + "; ".join(
              f"{k} {ms:.2f} ms for {nbytes} bytes" for k, (ms, nbytes) in c.items()))

    # 15d: four ranks at (1, 4), the full-width bf16 soft step and the
    # student's eval view
    got = _tp_spawn(4, out_dir, {"mesh": (1, 4), "15d": True})
    ranks = [g["15d"] for g in got]
    worst["bfloat16 (1, 4)"] = _tp_hold(
        f"15d bfloat16 soft step, mesh (1, 4), B={TP_BATCH}", ranks, refs["bfloat16"],
        TP_GRAD_TOL["bfloat16"], TP_LOSS_TOL["bfloat16"], [(0, 1, 2, 3)])
    for r, g in enumerate(ranks):
        _check_launches(f"15d rank {r}", g["launches"], _tp_launches("bfloat16", 4), 1)
        _check_launches(f"15d rank {r} eval view", [g["eval"]["launches"]],
                        TP_EVAL_LAUNCHES, 1)
        _agree(f"15d rank {r} eval-view logits at mesh (1, 4)", g["eval"]["logits"],
               refs["bfloat16"]["eval"]["logits"], (TP_BATCH, 100),
               other="the one-process eval view")
    print(f"[tp] {smi}: 15d: the four ranks took {got[0]['15d_s']:.1f} s (rank 0); TP step "
          f"{ranks[0]['ms'][0]:.2f} ms a rank (its first, CUDA events; four processes sharing "
          f"the card over gloo: not a TP speed); launches a step and rank "
          f"{ranks[0]['launches'][0]}; the eval view's {ranks[0]['eval']['launches']}")
    worst.update(run_eight_ranks(mods, smi, out_dir, refs["bfloat16"]))

    if "15c" in tasks:
        c = tasks["15c"]
        ranks = got_a
        straight = ranks[0]["run"]
        ok = _tp_close("15c one epoch at (1, 2) against one process", straight, one_run)
        one_resumed = train_cli.main(soft_argv("tp_one", "--epochs", "2", "--resume",
                                               "--checkpoint", one_ckpt, *TP_RUN_FLAGS))
        ok &= _tp_close("15c the one-process checkpoint resumed at (1, 2) against its "
                        "one-process resume", ranks[0]["resumed"], one_resumed)
        saves = [g["saves"] for g in ranks]
        same_tp, _ = _same_state(os.path.join(c["round_trip"], "state-1"),
                                 os.path.join(one_ckpt, "state-1"))
        _tp_round_trip(one, os.path.join(tmp, "tp_two", "checkpoint"),
                       os.path.join(tmp, "tp_two_round_trip"), None)
        same_one, step = _same_state(os.path.join(tmp, "tp_two_round_trip", "state-1"),
                                     os.path.join(tmp, "tp_two", "checkpoint", "state-1"))
        print(f"[tp] 15c saves (epoch, wrote) by rank {saves}; the one-process checkpoint "
              f"cut at (1, 2) and gathered again {'the same bits' if same_tp else 'DIFFERS'};"
              f" the (1, 2) checkpoint loaded in one process and saved again "
              f"{'the same bits' if same_one else 'DIFFERS'} ({step} steps)")
        if not (ok and same_tp and same_one and saves[0] == [(1, True), (2, True)]
                and saves[1] == [(1, False), (2, False)]):
            raise AssertionError("15c: run() at (1, 2) failed its checks")
    print(f"[tp] {smi}: phase 15 took {time.perf_counter() - t_start:.1f} s")
    return worst


# Planted faults (``--faults``): each is an edit of one kernel source, or of
# the data-parallel step, in a copy of the package; the copy's checks of it
# (``--forward-checks``, ``--backward-checks``, ``--mlp-checks``,
# ``--attention-checks``, ``--sort-checks`` or ``--dp-checks``) must then
# fail (exit 1).
# ---------------------------------------------------------------------------
# Phase 13: the fp32 route
# ---------------------------------------------------------------------------

def _hold_f32(worst, key, tag, checks, same_bits, x=None):
    """Phase 13: fails unless each (name, fp32 kernel output, bf16 kernel
    output, fp32 plain output) has its fp32 error at most F32_RATIO of the
    bf16 error, or below F32_FLOOR, each error the largest |difference| over
    the largest |plain value| (`out` as out - x, with x the fp32 input), and
    a second run of the fp32 kernel gave the same bits. Keeps the largest
    abs error of the fp32 kernel in worst[key] and the largest ratio in
    F32_WORST."""
    name0 = key if isinstance(key, str) else key[0]
    for name, a32, a16, ref in checks:
        if name == "out":
            name, (a32, a16, ref) = "out - x", (t.float() - x.float() for t in (a32, a16, ref))
        e32, mx = _err(a32, ref)
        e16, _ = _err(a16, ref)
        r32, r16 = e32 / mx, e16 / mx
        ratio = r32 / max(r16, 1e-30)
        ok = r32 <= F32_RATIO * r16 or r32 <= F32_FLOOR
        print(f"[fp32] {name0} {tag} {name}: fp32 err {r32:.3e}, bf16 err {r16:.3e} of max "
              f"|plain| {mx:.3e} (fp32/bf16 {ratio:.4f}, limit {F32_RATIO}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name0} {tag} {name}: the fp32 form is not within "
                                 f"{F32_RATIO} of the bf16 form's error")
        worst[key] = max(worst.get(key, 0.0), e32)
        if r32 > F32_FLOOR:
            F32_WORST[(name0, name)] = max(F32_WORST.get((name0, name), (0.0, "")), (ratio, tag))
    if not same_bits:
        raise AssertionError(f"{name0} {tag}: two runs gave different bits")


def _with_tf32(fn):
    """fn() with TF32 allowed in PyTorch's products and convolutions (a
    library call's time at fp32), then off again, as the plain versions
    need it."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def _hold_block_f32(fb, worst, D, H, B, n, need_feat, seed, main=False, backward=True):
    """The fp32 block forward (and backward) against its plain fp32 version,
    beside the bf16 kernels on the same inputs rounded to bf16."""
    import torch

    p, x, sa, sm = _block_inputs(D, H, B, seed, "cuda", n=n, fp32=True)
    x16 = x.bfloat16()
    kw = dict(num_heads=H, scale_attn=sa, scale_mlp=sm)
    tag = f"B={B} N={n} feat={need_feat}"
    out, feat = fb.kernel_block_fwd(x, p, need_features=need_feat, **kw)
    again = fb.kernel_block_fwd(x, p, need_features=need_feat, **kw)
    out16, feat16 = fb.kernel_block_fwd(x16, p, need_features=True, **kw)
    r_out, r_feat = fb.reference_vit_block(x, p, **kw)
    torch.cuda.synchronize()
    _hold_f32(worst, ("fused_block_fwd_f32", D) if main else "fused_block_fwd_f32", tag,
              [("out", out, out16, r_out)] + ([("feat", feat, feat16, r_feat)] if need_feat
                                              else []),
              torch.equal(out, again[0]) and (not need_feat or torch.equal(feat, again[1])), x)
    if not backward:
        return
    g = torch.Generator(device="cuda").manual_seed(seed)
    g_out = torch.randn(x.shape, generator=g, device="cuda")
    g_feat = torch.randn(x.shape, generator=g, device="cuda") if need_feat else None
    dx, dws = fb.kernel_block_bwd(x, p, g_out, g_feat, **kw)
    dx2, dws2 = fb.kernel_block_bwd(x, p, g_out, g_feat, **kw)
    dx16, dws16 = fb.kernel_block_bwd(x16, p, g_out, g_feat, **kw)
    r_dx, r_dws = fb.reference_vit_block_bwd(x, p, g_out, g_feat, **kw)
    torch.cuda.synchronize()
    _hold_f32(worst, ("fused_block_bwd_f32", D) if main else "fused_block_bwd_f32", tag,
              [("dx", dx, dx16, r_dx)] + [("d" + k, dws[k], dws16[k], r_dws[k])
                                          for k in fb.PARAM_NAMES],
              torch.equal(dx, dx2) and all(torch.equal(dws[k], dws2[k]) for k in fb.PARAM_NAMES))


def check_fp32_blocks(fb, worst, seeds=1):
    """Phase 13a: the fp32 block kernels at B=8: D = 192 and 384, N = 198 and
    197, with and without the feature output; each case on ``seeds`` input
    draws."""
    for s in range(seeds):
        for D, H in ((192, 3), (384, 6)):
            for n in (N_TOK, N_TOK - 1):
                for need_feat in (False, True):
                    _hold_block_f32(fb, worst, D, H, B_CHECK, n, need_feat,
                                    13 * D + n + need_feat + 1000 * s)


def _hold_mlp_f32(fm, worst, M, D, seed, main=False):
    """The fp32 MLP forward against its plain fp32 version at [M, D] (fp32 x
    of std 1, weights of std 1/sqrt(fan-in)), beside the bf16 kernel on the
    same inputs (x rounded to bf16, the fp32 parameters as the model passes
    them)."""
    import torch

    x, w1, b1, w2, b2, _ = _mlp_inputs(M, D, seed)
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(M, D, generator=g).cuda()
    out = fm.kernel_fused_mlp(x, w1, b1, w2, b2)
    again = fm.kernel_fused_mlp(x, w1, b1, w2, b2)
    out16 = fm.kernel_fused_mlp(x.bfloat16(), w1, b1, w2, b2)
    ref = fm._plain_fwd(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    _hold_f32(worst, ("fused_mlp_fwd_f32", D) if main else "fused_mlp_fwd_f32",
              f"M={M} D={D}", [("o", out, out16, ref)], torch.equal(out, again))


def check_fp32_linear(fb, worst, timed=False):
    """Phase 13a, `[gemm fp32 linear]`: the fp32 linear product alone
    (fb.kernel_linear on fp32 a and w: dk_linear_sm90_f32, the weight split
    once into TF32 parts, A split in registers) on the forward's four
    products with the epilogues forward_chain gives them (qkv's column
    scale, proj's residual, fc1's bias, GELU and gelu', fc2's fp32 residual)
    and the backward's four input gradients (on W^T; fc2's times gelu', with
    its 128-row column sums), at D = 192 and 384, M = 1001 (ragged against
    the 128-row tile) and M = 50688, against the plain fp32 version (TF32
    off) under phase 13's criterion beside the bf16 kernel on the same
    inputs rounded to bf16; two runs the same bits. Each weight's split alone
    (fb.kernel_tf32_split: the forward's, and the backward's transposed
    split of W^T) equals fb.tf32_split bit for bit. With ``timed``, each
    product at M = 50688 in TFLOP/s of fp32 work beside one torch.matmul
    with TF32 allowed and one with TF32 off. Returns {(kind, name, D): (ms,
    TF32 matmul ms, fp32 matmul ms)}."""
    import torch

    def hold_split(w, transposed):
        hi, lo = fb.kernel_tf32_split(w, transposed)
        r_hi, r_lo, _ = fb.tf32_split(w.t() if transposed else w)
        torch.cuda.synchronize()
        ok = torch.equal(hi, r_hi) and torch.equal(lo, r_lo)
        print(f"[gemm fp32 linear] split of {'W^T' if transposed else 'W'} {tuple(w.shape)}: "
              f"hi and lo {'equal' if ok else 'differ from'} tf32_split's bits "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the fp32 weight split of {tuple(w.shape)} (transposed "
                                 f"{transposed}) is not tf32_split's")

    def hold(tag, a, w, bias, kw, col_part=False):
        M, N = a.shape[0], w.shape[0]
        parts = [torch.empty((M + 127) // 128, N, device="cuda") for _ in range(3)] \
            if col_part else [None] * 3
        got = fb.kernel_linear(a, w, bias, col_part=parts[0], **kw)
        again = fb.kernel_linear(a, w, bias, col_part=parts[1], **kw)
        got16 = fb.kernel_linear(a.bfloat16(), w.bfloat16(), bias, col_part=parts[2], **kw)
        ref = fb.plain_linear(a, w, bias, dtype=torch.float32, **kw)
        torch.cuda.synchronize()
        checks = [(name, g, g16, r) for name, g, g16, r in
                  zip(("out32", "out_lp", "pre", "gelu'"), got, got16, ref) if g is not None]
        same = all(torch.equal(g, g2) for g, g2 in zip(got, again) if g is not None)
        if col_part:
            rows = torch.zeros(parts[0].shape[0] * 128, N, device="cuda")
            rows[:M] = ref[0]
            checks.append(("col_part", parts[0], parts[2], rows.view(-1, 128, N).sum(1)))
            same = same and torch.equal(parts[0], parts[1])
        _hold_f32(worst, "linear_sm90_f32", tag, checks, same)

    times = {}

    def time_one(key, a, w, bias, kw):
        (M, K), N = a.shape, w.shape[0]
        flops = 2 * M * N * K
        ms = _timed(lambda: fb.kernel_linear(a, w, bias, **kw), 20)
        tf32_ms = _with_tf32(lambda: _timed(lambda: torch.matmul(a, w.t()), 20))
        f32_ms = _timed(lambda: torch.matmul(a, w.t()), 20)
        times[key] = (ms, tf32_ms, f32_ms)
        print(f"[gemm fp32 linear] {key[0]} {key[1]} D={key[2]} [{M}x{K}]x[{K}x{N}] writing "
              f"{'+'.join(kw['outputs'])}: {ms:.4f} ms {flops / ms / 1e9:.1f} TFLOP/s of fp32 "
              f"work; torch.matmul TF32 allowed {tf32_ms:.4f} ms {flops / tf32_ms / 1e9:.1f}, "
              f"TF32 off {f32_ms:.4f} ms {flops / f32_ms / 1e9:.1f}")

    for D in (192, 384):
        for name, _, _ in LINEAR_PRODUCTS:
            for M in (1001, M_MAIN):
                a, w, bias, kw = _linear_inputs(name, D, M, D + M + 1, fp32=True)
                if M == M_MAIN:
                    hold_split(w, False)
                hold(f"{name} D={D} M={M}", a, w, bias, kw)
            if timed:
                time_one(("linear", name, D), a, w, bias,
                         dict(kw, outputs=LINEAR_MAIN_OUTPUTS[name]))
        for name, o_mult, i_mult in BACKWARD_PRODUCTS:
            O, I = o_mult * D, i_mult * D
            for M in (1001, M_MAIN):
                g = torch.Generator(device="cuda").manual_seed(D + M + O + 2)
                G = torch.randn(M, O, generator=g, device="cuda")
                W = torch.randn(O, I, generator=g, device="cuda") / math.sqrt(O)
                mul = (1.2 * torch.rand(M, I, generator=g, device="cuda") - 0.1
                       if name == "fc2" else None)
                if M == M_MAIN:
                    hold_split(W, True)
                hold(f"dgrad {name} D={D} M={M}", G, W.t().contiguous(), None,
                     dict(mul=mul), col_part=mul is not None)
            if timed:
                time_one(("dgrad", name, D), G, W.t().contiguous(), None,
                         dict(mul=mul, outputs=DGRAD_OUTPUTS[name]))
    return times


def check_fp32_weight_grads(fb, worst, timed=False):
    """Phase 13a: the fp32 weight gradient alone (fb.kernel_weight_grad on
    fp32 G and X, dk_weight_grad_sm90_f32) at the backward's four products,
    D = 192 and 384, M = 1001 (ragged against the 128-row tile and the
    32-row k-blocks) and M = 50688, against the plain fp32 product (TF32
    off), beside the bf16 kernel on G and X rounded to bf16; two runs the
    same bits. With ``timed``, each at M = 50688 beside the bf16 kernel and
    one torch.matmul with TF32 allowed. Returns {(name, D): (fp32 ms, bf16
    ms, TF32 matmul ms)}."""
    import torch

    rows = {}
    for D in (192, 384):
        for name, o_mult, i_mult in BACKWARD_PRODUCTS:
            O, I = o_mult * D, i_mult * D
            for M in (1001, M_MAIN):
                g = torch.Generator(device="cuda").manual_seed(D + M + O + 1)
                G = torch.randn(M, O, generator=g, device="cuda")
                X = torch.randn(M, I, generator=g, device="cuda")
                dw, again = fb.kernel_weight_grad(G, X), fb.kernel_weight_grad(G, X)
                dw16 = fb.kernel_weight_grad(G.bfloat16(), X.bfloat16())
                ref = fb.plain_weight_grad(G, X, torch.float32)
                torch.cuda.synchronize()
                _hold_f32(worst, "weight_grad_sm90_f32", f"{name} D={D} M={M}",
                          [("dW", dw, dw16, ref)], torch.equal(dw, again))
            if timed:
                G16, X16 = G.bfloat16(), X.bfloat16()
                rows[(name, D)] = (_timed(lambda: fb.kernel_weight_grad(G, X), 20),
                                   _timed(lambda: fb.kernel_weight_grad(G16, X16), 20),
                                   _with_tf32(lambda: _timed(lambda: torch.matmul(G.t(), X), 20)))
                print(f"[gemm fp32] wgrad {name} D={D} [{O}x{M}]x[{M}x{I}]: "
                      f"{rows[(name, D)][0]:.4f} ms; bf16 kernel {rows[(name, D)][1]:.4f} ms; "
                      f"torch.matmul (TF32 allowed) {rows[(name, D)][2]:.4f} ms")
    return rows


# Workspace bytes of the fp32 backwards at the main shapes ([256, 198, 192];
# the MLP's [50688, 192]) in the design whose weight gradients transposed G
# and X through the workspace (G^T and X^T of the widest one, 311,427,072
# bytes at these shapes), from that design's carve, and of its widest
# weight gradient's row-range partials.
F32_BWD_WORKSPACE_BEFORE = {"fused_block_bwd_f32": 1_492_733_952,
                            "fused_pair_bwd_f32": 2_233_387_008,
                            "fused_mlp_bwd_f32": 789_811_200}
F32_WGRAD_PARTIAL_BEFORE = 8_847_360


def print_fp32_backward_workspace(fb, fm, at):
    """The fp32 block, pair and MLP backwards' workspace at the main shapes
    beside F32_BWD_WORKSPACE_BEFORE: fails unless each is below it and the
    difference is the transposed G and X it no longer carves, less the
    larger row-range partials of the shorter fp32 ranges, less the weights
    split into TF32 hi and lo (each stash's four split weights, the lo half
    of each transposed weight; the MLP's transposes and its recompute's W1)
    and, for the block and the pair, less what the attention backward's
    workspace adds to the slice it shares with dhpre."""
    D, H, N, B = 192, 3, N_TOK, B_MAIN
    F, M = 4 * D, B * N

    def r256(n):
        return (n + 255) // 256 * 256

    gt_xt = 2 * r256(F * ((M + 3) // 4 * 4) * 4)
    attn = at._library().dk_flash_bwd_f32_workspace(B, H, N)
    grown = max(r256(attn), r256(M * F * 4)) - r256(M * F * 4)
    lib = fb._library("fused_block_bwd")
    partial = r256(max(lib.dk_weight_grad_sm90_f32_workspace(M, o * D, i * D)
                       for _, o, i in BACKWARD_PRODUCTS))
    now = {name: fb.workspace_bytes(name, (B, N, D), H, F)
           for name in ("fused_block_bwd_f32", "fused_pair_bwd_f32")}
    now["fused_mlp_bwd_f32"] = fm.workspace_bytes(M, D, F, "fused_mlp_bwd_f32")
    wn = (3 * D * D, D * D, F * D, D * F)
    stash_split = sum(r256(2 * n * 4) for n in wn)
    lo_halves = sum(r256(2 * n * 4) - r256(n * 4) for n in wn)
    split = {"fused_block_bwd_f32": stash_split + lo_halves,
             "fused_pair_bwd_f32": 2 * stash_split + lo_halves,
             "fused_mlp_bwd_f32": 2 * (r256(2 * F * D * 4) - r256(F * D * 4)) + r256(2 * F * D * 4)}
    for name, before in F32_BWD_WORKSPACE_BEFORE.items():
        added = partial - F32_WGRAD_PARTIAL_BEFORE + (0 if "mlp" in name else grown)
        want = before - gt_xt + added + split[name]
        print(f"[workspace fp32] {name}: {now[name]} bytes, before {before}, "
              f"{before - now[name]} less; G^T and X^T ({gt_xt}) gone, the weight-gradient "
              f"partials {partial} (before {F32_WGRAD_PARTIAL_BEFORE}), the split weights "
              f"{split[name]}"
              + ("" if "mlp" in name else f", the attention backward's workspace {attn} in "
                 f"dhpre's slice ({grown} more)"))
        if now[name] != want or now[name] >= before:
            raise AssertionError(f"{name}: the workspace is {now[name]} bytes, not {want}, or "
                                 f"not below {before}")


def check_fp32_mlp(fm, worst, seeds=1):
    """Phase 13a: the fp32 MLP forward at every width of the model zoo at 8
    images' rows and an odd M, each on ``seeds`` input draws."""
    for s in range(seeds):
        for D in MLP_WIDTHS:
            for M in (B_CHECK * N_TOK, 1001):
                _hold_mlp_f32(fm, worst, M, D, M + D + 1000 * s)


def print_fp32_ratios():
    """The largest fp32/bf16 error ratio of each (kernel, quantity) over the
    phase's checks, with the case that read it, beside its limit."""
    for (kernel, name), (ratio, tag) in sorted(F32_WORST.items()):
        print(f"[fp32 worst] {kernel} {name}: fp32/bf16 {ratio:.4f} ({tag}), limit {F32_RATIO}, "
              f"{ratio / F32_RATIO:.2f} of it")


def _hold_attention_f32(at, worst, shape, main=False, exact=False, backward=True):
    """Both fp32 attention kernels against their plain fp32 versions at one
    shape, beside the bf16 kernels on the same inputs rounded to bf16. With
    ``exact`` the inputs are bf16 values, so that rounding them adds nothing
    to either form's error and what is left is the kernels' own roundings
    (P, dS and the outputs in the bf16 form): a bf16 rounding inside the
    fp32 form then shows (lse, an exact fp32 sum on both sides, is left
    out). Without ``backward`` the forward alone (at N = 1 dq and dk are
    zero by their math, rounding noise on both sides)."""
    import torch

    q, k, v, do = _attention_inputs(shape, shape[0] + shape[1] + 1, fp32=True)
    if exact:
        q, k, v, do = (t.bfloat16().float() for t in (q, k, v, do))
    q16, k16, v16, do16 = (t.bfloat16() for t in (q, k, v, do))
    o, lse = at.kernel_flash_fwd(q, k, v)
    o2, lse2 = at.kernel_flash_fwd(q, k, v)
    o16, lse16 = at.kernel_flash_fwd(q16, k16, v16)
    r_o, r_lse = at._plain_fwd(q, k, v)
    torch.cuda.synchronize()
    tag = f"{tuple(shape)}" + (" bf16-exact inputs" if exact else "")
    _hold_f32(worst, ("flash_fwd_f32", shape[0]) if main else "flash_fwd_f32", tag,
              [("o", o, o16, r_o)] + ([] if exact else [("lse", lse, lse16, r_lse)]),
              torch.equal(o, o2) and torch.equal(lse, lse2))
    if not backward:
        return
    grads = at.kernel_flash_bwd(q, k, v, o, lse, do)
    grads2 = at.kernel_flash_bwd(q, k, v, o, lse, do)
    grads16 = at.kernel_flash_bwd(q16, k16, v16, o16, lse16, do16)
    r_grads = at._plain_bwd(q, k, v, r_o, r_lse, do)
    torch.cuda.synchronize()
    _hold_f32(worst, ("flash_bwd_f32", shape[0]) if main else "flash_bwd_f32", tag,
              [(n, *t) for n, t in zip(("dq", "dk", "dv"), zip(grads, grads16, r_grads))],
              all(torch.equal(a, b) for a, b in zip(grads, grads2)))


def _hold_attention_views_f32(at, worst, B, H, N):
    """flash_attention's fp32 gradient through its autograd Function on
    strided views of a packed fp32 [B, N, 3, H, 64] qkv against autograd
    through the plain reference_attention at fp32, beside the bf16 route on
    the same views rounded to bf16: one launch of each fp32 kernel."""
    import torch

    g = torch.Generator().manual_seed(N + H + 1)
    qkv = (1.5 * torch.randn(B, N, 3, H, HEAD_DIM, generator=g)).cuda()
    do = torch.randn(B, H, N, HEAD_DIM, generator=g).cuda()

    def grad(fn, packed):
        leaf = packed.clone().requires_grad_(True)
        views = [leaf[:, :, i].transpose(1, 2) for i in range(3)]
        return torch.autograd.grad(fn(*views), [leaf], do.to(packed.dtype))[0]

    at.reset_launches()
    g1 = grad(at.flash_attention, qkv)
    launches = dict(at.LAUNCHES)
    g2 = grad(at.flash_attention, qkv)
    g16 = grad(at.flash_attention, qkv.bfloat16())
    ref = grad(at.reference_attention, qkv)
    torch.cuda.synchronize()
    if launches != {("flash_fwd_f32", B * H): 1, ("flash_bwd_f32", B * H): 1}:
        raise AssertionError(f"fp32 attention on views [{B},{N},3,{H},64]: launches {launches}")
    _hold_f32(worst, "flash_bwd_f32", f"views [{B},{N},3,{H},{HEAD_DIM}]",
              [("dqkv", g1, g16, ref)], torch.equal(g1, g2))


def check_fp32_attention(at, worst):
    """Phase 13b: the fp32 attention kernels at [24, 198, 64], N = 50, 65, 578
    (also for one head) and 656 (the longest they take), the warp-specialised
    forward's edges (N = 8 and 9: one chunk cut to one and two 8-key groups;
    64: one whole chunk; 128 and 129: one 128-row CTA a head, then a second
    with one row on one consumer; 200: a tail of one whole group; 198 at one
    head; N = 1 for the forward alone), at [24, 198, 64] on bf16-exact
    inputs, and through the autograd Function on strided views of a packed
    qkv."""
    for shape in ((B_CHECK * 3, N_TOK, HEAD_DIM), (4, 50, HEAD_DIM), (4, 65, HEAD_DIM),
                  (4, 578, HEAD_DIM), (1, 578, HEAD_DIM), (4, 656, HEAD_DIM),
                  (4, 8, HEAD_DIM), (4, 9, HEAD_DIM), (4, 64, HEAD_DIM), (4, 128, HEAD_DIM),
                  (4, 129, HEAD_DIM), (4, 200, HEAD_DIM), (1, N_TOK, HEAD_DIM)):
        _hold_attention_f32(at, worst, shape)
    _hold_attention_f32(at, worst, (4, 1, HEAD_DIM), backward=False)
    _hold_attention_f32(at, worst, (B_CHECK * 3, N_TOK, HEAD_DIM), exact=True)
    _hold_attention_views_f32(at, worst, 2, 3, N_TOK)


def time_fp32_kernels(fb, at, fm, worst, smi):
    """Phases 13a-b at the main-path shapes, then 13d: each fp32 form held
    there, then its ms, its plain version's (fp32, TF32 off) and one library
    call's with TF32 allowed (the block from PyTorch calls; SDPA; F.linear,
    F.gelu, F.linear), beside the bound: TF32 operations over 495 TFLOP/s or
    4-byte elements over the memory rate, whichever is larger."""
    import torch
    import torch.nn.functional as F

    rows = {}
    _hold_block_f32(fb, worst, 384, 6, B_MAIN, N_TOK, True, 7, main=True, backward=False)
    _hold_block_f32(fb, worst, 192, 3, B_MAIN, N_TOK, True, 7, main=True)
    for bh in ATTN_MAIN.values():
        _hold_attention_f32(at, worst, (bh, N_TOK, HEAD_DIM), main=True)
    _hold_mlp_f32(fm, worst, M_MAIN, MLP_MAIN["teacher"], 5, main=True)

    B, N = B_MAIN, N_TOK
    for kernel, D, H in (("fused_block_fwd_f32", 384, 6), ("fused_block_fwd_f32", 192, 3),
                         ("fused_block_bwd_f32", 192, 3)):
        p, x, sa, sm = _block_inputs(D, H, B, 7, "cuda", fp32=True)
        kw = dict(num_heads=H, scale_attn=sa, scale_mlp=sm)
        g_out = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(D),
                            device="cuda")
        lib_w = [t.detach().requires_grad_(kernel == "fused_block_bwd_f32")
                 for t in fb.block_params(p)]
        x_lib = x.detach().requires_grad_(kernel == "fused_block_bwd_f32")
        flops = B * (24 * N * D * D + 4 * N * N * D)
        weight_bytes = 12 * D * D * 4
        if kernel == "fused_block_fwd_f32":
            ms = _timed(lambda: fb.kernel_block_fwd(x, p, need_features=False, **kw), 10)
            plain_ms = _timed(lambda: fb.reference_vit_block(x, p, **kw), 3)

            def lib_fwd():
                with torch.no_grad():
                    _library_block(x_lib, lib_w, H, 1e-6, sa, sm)

            library_ms = _with_tf32(lambda: _timed(lib_fwd, 20))
            nbytes = 2 * B * N * D * 4 + weight_bytes
        else:
            ms = _timed(lambda: fb.kernel_block_bwd(x, p, g_out, None, **kw), 10)
            plain_ms = _timed(lambda: fb.reference_vit_block_bwd(x, p, g_out, None, **kw), 3)

            def lib_fwd_graph():
                _library_block(x_lib, lib_w, H, 1e-6, sa, sm)

            def lib_fwd_bwd():
                _library_block(x_lib, lib_w, H, 1e-6, sa, sm).backward(g_out)

            library_ms = _with_tf32(lambda: _timed(lib_fwd_bwd, 20) - _timed(lib_fwd_graph, 20))
            flops = 3 * flops - 2 * B * N * D * 4 * D
            nbytes = 3 * B * N * D * 4 + weight_bytes + 12 * D * D * 4
        rows[(kernel, D)] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                 **_bound(flops, nbytes, PEAK_TF32_FLOPS))
    for kernel, who in (("flash_fwd_f32", "teacher"), ("flash_fwd_f32", "student"),
                        ("flash_bwd_f32", "student")):
        bh = ATTN_MAIN[who]
        q, k, v, do = _attention_inputs((bh, N, HEAD_DIM), 3, fp32=True)
        o, lse = at.kernel_flash_fwd(q, k, v)
        q4, k4, v4, do4 = (t.reshape(B, -1, N, HEAD_DIM) for t in (q, k, v, do))
        tensor_bytes, product = bh * N * HEAD_DIM * 4, 2 * bh * N * N * HEAD_DIM
        if kernel == "flash_fwd_f32":
            ms = _timed(lambda: at.kernel_flash_fwd(q, k, v), 20)
            plain_ms = _timed(lambda: at._plain_fwd(q, k, v), 5)

            def lib_attn():
                with torch.no_grad():
                    F.scaled_dot_product_attention(q4, k4, v4)

            library_ms = _with_tf32(lambda: _timed(lib_attn, 20))
            bound = _bound(2 * product, 4 * tensor_bytes + bh * N * 4, PEAK_TF32_FLOPS)
        else:
            ms = _timed(lambda: at.kernel_flash_bwd(q, k, v, o, lse, do), 20)
            plain_ms = _timed(lambda: at._plain_bwd(q, k, v, o, lse, do), 5)
            leaves = [t.detach().requires_grad_(True) for t in (q4, k4, v4)]

            def lib_fwd():
                return F.scaled_dot_product_attention(*leaves)

            def lib_fwd_bwd():
                torch.autograd.grad(lib_fwd(), leaves, do4)

            library_ms = _with_tf32(lambda: _timed(lib_fwd_bwd, 20) - _timed(lib_fwd, 20))
            bound = _bound(5 * product, 8 * tensor_bytes + bh * N * 4, PEAK_TF32_FLOPS)
        rows[(kernel, bh)] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bound)
    D = MLP_MAIN["teacher"]
    x, w1, b1, w2, b2, _ = _mlp_inputs(M_MAIN, D, 5)
    x = x.float()

    def lib_mlp():
        with torch.no_grad():
            F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2)

    rows[("fused_mlp_fwd_f32", D)] = dict(
        ms=_timed(lambda: fm.kernel_fused_mlp(x, w1, b1, w2, b2), 10),
        plain_ms=_timed(lambda: fm._plain_fwd(x, w1, b1, w2, b2), 3),
        library_ms=_with_tf32(lambda: _timed(lib_mlp, 20)),
        **_bound(4 * M_MAIN * D * 4 * D, (2 * M_MAIN * D + 8 * D * D + 5 * D) * 4,
                 PEAK_TF32_FLOPS))
    for (kernel, n), row in rows.items():
        what = f"D={n}" if kernel.startswith("fused") else f"[{n},{N},{HEAD_DIM}]"
        print(f"[time fp32] {kernel} {what} B={B}: {row['ms']:.3f} ms, plain "
              f"{row['plain_ms']:.3f} ms, library (TF32 allowed) {row['library_ms']:.3f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); {smi}")
    return rows


def check_fp32_against_cpu(teacher, student, aug, images, tau=3.0):
    """Phase 13c: both fp32 models' logits and the soft-KD loss on 4 images,
    the card against the CPU port at fp32 on the same weights; the bf16 card
    path on the same weights (the models' compute dtype set to bf16) must be
    further from the CPU than the fp32 card path in each."""
    import torch

    from deltakd_tpu_torch.data.augment import eval_transform
    from deltakd_tpu_torch.kd.losses import soft_kd_loss

    x = eval_transform(images[:4], aug).float()

    def run(t, s, xx):
        with torch.no_grad():
            t_out, s_out = t(xx, train=False), s(xx, train=False)
            loss = soft_kd_loss(s_out.logits_dist, t_out.logits, tau)
        return {"teacher logits": t_out.logits.float().cpu(),
                "student logits": s_out.logits.float().cpu(), "soft loss": loss.float().cpu()}

    on_cpu = run(copy.deepcopy(teacher).cpu(), copy.deepcopy(student).cpu(), x.cpu())
    on_card = run(teacher, student, x)
    t16, s16 = copy.copy(teacher), copy.copy(student)
    t16.dtype = s16.dtype = torch.bfloat16
    on_card16 = run(t16, s16, x)
    for what, ref in on_cpu.items():
        e32, mx = _err(on_card[what], ref)
        e16, _ = _err(on_card16[what], ref)
        ok = e32 < e16 and e32 <= LOGIT_TOL * max(mx, 1e-3)
        print(f"[fp32 reference] {what}: fp32 card vs CPU fp32 max_abs_err {e32:.3e}, bf16 card "
              f"{e16:.3e}, max |ref| {mx:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"fp32 {what}: the card's fp32 path is not closer to the CPU "
                                 f"than its bf16 path")


def run_fp32_route(mods, soft_bf16_ms, smi):
    """Phase 13c: the fp32 soft-KD step at full width through
    load_teacher_student (dtype float32), its eval batch and its agreement
    with the CPU port, then one unfused fp32 step (a model axis of 2).
    Returns the launches by path and the fused step's ms."""
    import torch

    by_path = {}
    opts = dict(dtype="float32")
    by_path["fp32 soft"], ms, peak, kept = run_train_path(
        mods, "soft", F32_STEPS, name="fp32 soft", options=opts)
    teacher, student, _, aug, _, images, labels = kept
    by_path["fp32 eval"] = run_eval(mods, student, aug, images, labels,
                                    {("fused_block_fwd_f32", 192): 12}, name="fp32 eval")
    check_fp32_against_cpu(teacher, student, aug, images)
    del teacher, student, kept
    torch.cuda.empty_cache()
    by_path["fp32 unfused soft"], unfused_ms, unfused_peak, kept = run_train_path(
        mods, "soft", 2, name="fp32 unfused soft", options=dict(opts, mesh_shape=(1, 2)))
    del kept
    torch.cuda.empty_cache()
    print(f"[fp32] soft step {ms:.2f} ms ({B_MAIN / ms * 1e3:.1f} images/s), peak allocated "
          f"{peak / 2**30:.3f} GiB, beside phase 6's bf16 soft step {soft_bf16_ms:.2f} ms; "
          f"unfused fp32 step {unfused_ms:.2f} ms, peak {unfused_peak / 2**30:.3f} GiB; {smi}")
    return by_path, ms


# ---------------------------------------------------------------------------
# Phase 14: the fp32 forms of rows 6-8, the optimizers, token dropout
# ---------------------------------------------------------------------------

PAIR_SINGLES_TOL = 1e-5   # 14a: the fp32 pair against two fp32 single blocks chained,
#                           of the largest |single value| (fp32 sums, other orders)
OPT_TOL = 1e-6            # 14d, card against CPU after OPT_STEPS updates: the global
#                           norm, relative, and the moments and the trace, of their
#                           largest |value|
OPT_ULPS = 6              # ... each parameter, in fp32 ulps of |start| + its path (the
#                           sum of its |changes|, which bounds every value it took): one
#                           rounding into it an update; an update 1e-5 off reads 84
#                           ulps on the parameters that start at 0, the biases
OPT_STEPS = 6             # the LR scale is set to OPT_SCALE before update OPT_STEPS // 2
OPT_SCALE = 0.5
OPT_CASES = tuple((opt, sched) for opt in ("adamw", "sgd", "adam")
                  for sched in ("cosine", "step", "plateau"))
DROP_RATE = 0.1           # 14e: token dropout of the student


def _hold_pair_f32(fb, worst, D, H, B, nf1, nf2, seed, main=False, n=N_TOK):
    """Phase 14a: the fp32 pair forward and backward against their plain fp32
    versions on one input (fp32 x and cotangents), beside the bf16 pair
    kernels on the same inputs rounded to bf16 (_hold_f32); sample 5 with all
    four scales at 0 must come back as x, a feature output follows its flag,
    and a second run gives the same bits. Returns (inputs, fp32 forward
    outputs, fp32 backward outputs)."""
    import torch

    p1, p2, x, scales, (g_out, g_f1, g_f2) = inputs = _pair_inputs(D, H, B, seed, "cuda",
                                                                   n=n, fp32=True)
    g_f1, g_f2 = (g_f1 if nf1 else None), (g_f2 if nf2 else None)
    x16 = x.bfloat16()
    kw = dict(num_heads=H, scales=scales)
    fkw = dict(need_features1=nf1, need_features2=nf2, **kw)
    fwd, fwd2 = (fb.kernel_block_pair_fwd(x, p1, p2, **fkw) for _ in range(2))
    fwd16 = fb.kernel_block_pair_fwd(x16, p1, p2, **fkw)
    r_fwd = fb.reference_vit_block_pair(x, p1, p2, **kw)
    bwd, bwd2 = (fb.kernel_block_pair_bwd(x, p1, p2, g_out, g_f1, g_f2, **kw) for _ in range(2))
    bwd16 = fb.kernel_block_pair_bwd(x16, p1, p2, g_out, g_f1, g_f2, **kw)
    r_bwd = fb.reference_vit_block_pair_bwd(x, p1, p2, g_out, g_f1, g_f2, **kw)
    torch.cuda.synchronize()
    tag = f"B={B} D={D}{'' if n == N_TOK else f' N={n}'} feat=({nf1}, {nf2})"
    for flag, feat in ((nf1, fwd[1]), (nf2, fwd[2])):
        if (feat is not None) != flag or (feat is not None and feat.dtype != torch.float32):
            raise AssertionError(f"fused_pair_fwd_f32 {tag}: a feature output does not "
                                 f"follow its flag or is not fp32")
    if fwd[0].dtype != torch.float32 or bwd[0].dtype != torch.float32:
        raise AssertionError(f"fused_pair_f32 {tag}: out or dx is not fp32")
    if not torch.equal(fwd[0][5], x[5]):
        raise AssertionError(f"fused_pair_fwd_f32 {tag}: all four scales 0 did not return x")
    _hold_f32(worst, ("fused_pair_fwd_f32", D) if main else "fused_pair_fwd_f32", tag,
              [("out", fwd[0], fwd16[0], r_fwd[0])]
              + [(name, fwd[i], fwd16[i], r_fwd[i]) for i, name in ((1, "feat1"), (2, "feat2"))
                 if fwd[i] is not None],
              all(torch.equal(a, b) for a, b in zip(fwd, fwd2) if a is not None), x)
    (dx, dw1, dw2), (dx16, dw1_16, dw2_16), (r_dx, r_dw1, r_dw2) = bwd, bwd16, r_bwd
    _hold_f32(worst, ("fused_pair_bwd_f32", D) if main else "fused_pair_bwd_f32", tag,
              [("dx", dx, dx16, r_dx)]
              + [(f"d{n}[{blk}]", dw[n], dw16[n], r_dw[n])
                 for blk, dw, dw16, r_dw in ((1, dw1, dw1_16, r_dw1), (2, dw2, dw2_16, r_dw2))
                 for n in fb.PARAM_NAMES],
              torch.equal(dx, bwd2[0]) and all(torch.equal(a[n], b[n]) for a, b in (
                  (dw1, bwd2[1]), (dw2, bwd2[2])) for n in fb.PARAM_NAMES))
    return inputs, fwd, bwd


def check_fp32_pairs(fb, worst, seeds=1):
    """Phase 14a: the fp32 pair kernels at B=8 for D = 192 and 384 and the four
    feature variants, each on ``seeds`` input draws."""
    for s in range(seeds):
        for D, H in ((192, 3), (384, 6)):
            for nf1, nf2 in PAIR_FLAGS:
                _hold_pair_f32(fb, worst, D, H, B_CHECK, nf1, nf2, D + 2 * nf1 + nf2 + 1000 * s)


def _hold_mlp_bwd_f32(fm, worst, M, D, seed, main=False):
    """Phase 14a: the fp32 MLP backward against its plain fp32 version at
    [M, D] (fp32 x and dy of std 1, weights of std 1/sqrt(fan-in)), beside
    the bf16 kernel on the same inputs rounded to bf16."""
    import torch

    _, w1, b1, w2, _, _ = _mlp_inputs(M, D, seed)
    g = torch.Generator().manual_seed(seed + 1)
    x, dy = (torch.randn(M, D, generator=g).cuda() for _ in range(2))
    grads, again = (fm.kernel_fused_mlp_bwd(x, w1, b1, w2, dy) for _ in range(2))
    grads16 = fm.kernel_fused_mlp_bwd(x.bfloat16(), w1, b1, w2, dy.bfloat16())
    ref = fm._plain_bwd(x, w1, b1, w2, dy)
    torch.cuda.synchronize()
    if grads[0].dtype != torch.float32:
        raise AssertionError(f"fused_mlp_bwd_f32 M={M} D={D}: dx is not fp32")
    _hold_f32(worst, ("fused_mlp_bwd_f32", D) if main else "fused_mlp_bwd_f32",
              f"M={M} D={D}", [(n, *t) for n, t in zip(("dx", "dW1", "db1", "dW2", "db2"),
                                                       zip(grads, grads16, ref))],
              all(torch.equal(a, b) for a, b in zip(grads, again)))


def check_fp32_mlp_backward(fm, worst, seeds=1):
    """Phase 14a: the fp32 MLP backward at every width of the model zoo at 8
    images' rows and an odd M (the cases of phase 13a's forward), each on
    ``seeds`` input draws."""
    for s in range(seeds):
        for D in MLP_WIDTHS:
            for M in (B_CHECK * N_TOK, 1001):
                _hold_mlp_bwd_f32(fm, worst, M, D, M + D + 7 + 1000 * s)


def time_fp32_rows_6_8(fb, fm, worst, smi):
    """Phase 14a at the main-path shapes, then the rows' times. The pair at
    [256, 198, 192] with no feature (what the paired fp32 step launches) and
    with both features, against two fp32 single blocks chained (within
    PAIR_SINGLES_TOL: at fp32 nothing is rounded between the blocks of
    either); the MLP backward at the student's [50688, 192]. Then each
    row's ms, its plain version's (fp32, TF32 off), one library call's with
    TF32 allowed (two library blocks chained; the MLP as F.linear, F.gelu,
    F.linear through autograd, forward+backward minus forward) and the bound
    (TF32 operations over 495 TFLOP/s, or 4-byte inputs, outputs, weights and
    fp32 gradients over the memory rate)."""
    import torch
    import torch.nn.functional as F

    D, H, B, N = 192, 3, B_MAIN, N_TOK
    _hold_pair_f32(fb, worst, D, H, B, False, False, 12, main=True)
    (p1, p2, x, scales, (g_out, g_f1, g_f2)), fwd, (dx, dw1, _) = _hold_pair_f32(
        fb, worst, D, H, B, True, True, 11, main=True)
    kw1 = dict(num_heads=H, scale_attn=scales[0], scale_mlp=scales[1])
    kw2 = dict(num_heads=H, scale_attn=scales[2], scale_mlp=scales[3])
    mid, f1 = fb.kernel_block_fwd(x, p1, need_features=True, **kw1)
    out, f2 = fb.kernel_block_fwd(mid, p2, need_features=True, **kw2)
    dmid, _ = fb.kernel_block_bwd(mid, p2, g_out, g_f2, **kw2)
    s_dx, s_dw1 = fb.kernel_block_bwd(x, p1, dmid, g_f1, **kw1)
    torch.cuda.synchronize()
    for name, a, b in (("out - x", fwd[0] - x, out - x), ("feat1", fwd[1], f1),
                       ("feat2", fwd[2], f2), ("dx", dx, s_dx),
                       ("dmlp.fc1.weight[1]", dw1["mlp.fc1.weight"], s_dw1["mlp.fc1.weight"])):
        abs_err, mx = _err(a, b)
        ok = abs_err <= PAIR_SINGLES_TOL * mx
        print(f"[fp32 pair vs two fp32 single kernels] {name}: max_abs_diff {abs_err:.3e}, "
              f"max |single| {mx:.3e} (rel {abs_err / mx:.3e}, limit {PAIR_SINGLES_TOL}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the fp32 pair and two fp32 single kernels differ in {name}")
    _hold_mlp_bwd_f32(fm, worst, M_MAIN, MLP_MAIN["student"], 5, main=True)

    kw = dict(num_heads=H, scales=scales)
    lib_w = [[t.detach().requires_grad_(True) for t in fb.block_params(p)] for p in (p1, p2)]
    x_lib = x.detach().requires_grad_(True)

    def lib_fwd():
        m = _library_block(x_lib, lib_w[0], H, 1e-6, scales[0], scales[1])
        return _library_block(m, lib_w[1], H, 1e-6, scales[2], scales[3])

    def lib_fwd_no_grad():
        with torch.no_grad():
            lib_fwd()

    flops1 = B * (24 * N * D * D + 4 * N * N * D)
    fc2 = 2 * B * N * D * 4 * D
    io, weights = B * N * D * 4, 2 * 12 * D * D * 4
    rows = {}
    pair_fwd = lambda: fb.kernel_block_pair_fwd(  # noqa: E731
        x, p1, p2, need_features1=False, need_features2=False, **kw)
    pair_bwd = lambda: fb.kernel_block_pair_bwd(x, p1, p2, g_out, **kw)  # noqa: E731
    rows[("fused_pair_fwd_f32", D)] = dict(
        ms=_timed(pair_fwd, 10),
        plain_ms=_timed(lambda: fb.reference_vit_block_pair(x, p1, p2, **kw), 3),
        library_ms=_with_tf32(lambda: _timed(lib_fwd_no_grad, 20)),
        **_bound(2 * flops1, 2 * io + weights, PEAK_TF32_FLOPS))
    rows[("fused_pair_bwd_f32", D)] = dict(
        ms=_timed(pair_bwd, 10),
        plain_ms=_timed(lambda: fb.reference_vit_block_pair_bwd(x, p1, p2, g_out, **kw), 3),
        library_ms=_with_tf32(lambda: _timed(lambda: lib_fwd().backward(g_out), 20)
                           - _timed(lib_fwd, 20)),
        # per block the recompute up to the GELU and two products per forward
        # product, and block 1's fc2 for mid; x, g_out, dx, the weights and
        # their fp32 gradients
        **_bound(2 * (3 * flops1 - fc2) + fc2, 3 * io + 2 * weights, PEAK_TF32_FLOPS))

    D = MLP_MAIN["student"]
    _, w1, b1, w2, b2, _ = _mlp_inputs(M_MAIN, D, 5)
    g = torch.Generator().manual_seed(6)
    xm, dy = (torch.randn(M_MAIN, D, generator=g).cuda() for _ in range(2))
    lib = [t.detach().requires_grad_(True) for t in (xm, w1, b1, w2, b2)]

    def lib_mlp():
        return F.linear(F.gelu(F.linear(lib[0], lib[1], lib[2])), lib[3], lib[4])

    product, mlp_weights = 2 * M_MAIN * D * 4 * D, 2 * D * 4 * D * 4
    rows[("fused_mlp_bwd_f32", D)] = dict(
        ms=_timed(lambda: fm.kernel_fused_mlp_bwd(xm, w1, b1, w2, dy), 10),
        plain_ms=_timed(lambda: fm._plain_bwd(xm, w1, b1, w2, dy), 3),
        library_ms=_with_tf32(lambda: _timed(lambda: torch.autograd.grad(lib_mlp(), lib, dy), 20)
                           - _timed(lib_mlp, 20)),
        **_bound(5 * product, 3 * M_MAIN * D * 4 + 2 * mlp_weights + 9 * D * 4,
                 PEAK_TF32_FLOPS))
    work = {name: fb.workspace_bytes(name, (B, N, 192), H, 4 * 192)
            for name in ("fused_pair_fwd_f32", "fused_pair_bwd_f32", "fused_pair_bwd")}
    work["fused_mlp_bwd_f32"] = fm.workspace_bytes(M_MAIN, D, 4 * D, "fused_mlp_bwd_f32")
    work["fused_mlp_bwd"] = fm.workspace_bytes(M_MAIN, D, 4 * D)
    for (kernel, n), row in rows.items():
        what = f"M={M_MAIN} D={n}" if "mlp" in kernel else f"D={n} B={B}"
        print(f"[time fp32] {kernel} {what}: {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} "
              f"ms, library (TF32 allowed) {row['library_ms']:.3f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); {smi}")
    print("[workspace fp32] bytes at the main shapes: "
          + ", ".join(f"{k} {v}" for k, v in work.items()))
    return rows


def run_fp32_pair_route(mods, smi):
    """Phase 14b: the paired fp32 soft step at full width through
    load_teacher_student(dtype float32, block_pair=True): 12 fp32 block
    forwards (the teacher), 6 fp32 pair forwards and 6 fp32 pair backwards
    a step, no bf16 and no single-block launch at D=192; the eval batch on
    the single-block view; both models' logits and the soft loss against the
    CPU port at fp32. Returns the launches by path and the step's ms."""
    import torch

    by_path = {}
    by_path["fp32 paired soft"], ms, peak, kept = run_train_path(
        mods, "soft", F32_STEPS, paired=True, name="fp32 paired soft",
        options=dict(dtype="float32"))
    teacher, student, _, aug, _, images, labels = kept
    by_path["fp32 paired eval"] = run_eval(
        mods, student.view(block_pair_fn=None, collect_features=False), aug, images, labels,
        {("fused_block_fwd_f32", 192): 12}, name="fp32 paired eval")
    check_fp32_against_cpu(teacher, student, aug, images)
    del teacher, student, kept
    torch.cuda.empty_cache()
    print(f"[fp32 paired] soft step {ms:.2f} ms ({B_MAIN / ms * 1e3:.1f} images/s), peak "
          f"allocated {peak / 2**30:.3f} GiB; {smi}")
    return by_path, ms


def check_optimizers(smi):
    """Phase 14d: each optimizer and schedule of train/optim.py (OPT_CASES,
    with clipping, an LR scale set to OPT_SCALE half-way through: the
    plateau's, or LR noise's for cosine and step) on the card against the
    same on the CPU, over the flat vector of DeiT-Ti-distilled's parameters
    and OPT_STEPS seeded gradients: the global norm and the buffers within
    OPT_TOL, each parameter within OPT_ULPS ulps. Then from the same state
    one update at scale 1 and one at 0.25, each of parameters set to 0 (so
    that the change is the update itself, not its difference with parameters
    of larger magnitude): the second must be 0.25 times the first (the scale
    multiplies the whole update). Returns each update's ms on the card."""
    import copy as copy_mod

    import torch

    from deltakd_tpu_torch.configs.config import TrainConfig
    from deltakd_tpu_torch.models.factory import create_model
    from deltakd_tpu_torch.train import optim
    from deltakd_tpu_torch.train.state import trainable_parameters

    model = create_model("deit_tiny_distilled_patch16_224", num_classes=100, seed=3,
                         device="cpu")
    named = {"cpu": trainable_parameters(model)}
    named["cuda"] = [(n, p.detach().cuda()) for n, p in named["cpu"]]
    flat0 = torch.cat([p.detach().reshape(-1) for _, p in named["cpu"]])
    g = torch.Generator().manual_seed(14)
    grads = [torch.randn(flat0.numel(), generator=g) * 0.05 for _ in range(OPT_STEPS + 1)]
    norms = [optim.global_norm(grads[0].to(dev)).item() for dev in ("cuda", "cpu")]
    fp32_norm = torch.linalg.vector_norm(grads[0]).item()
    norm_err = abs(norms[0] - norms[1]) / norms[1]
    print(f"[optimizer] global norm of the first gradient (fp64 sum): card {norms[0]!r}, CPU "
          f"{norms[1]!r} (rel {norm_err:.3e}, limit {OPT_TOL}); the CPU's fp32 norm "
          f"{fp32_norm!r} (rel {abs(fp32_norm - norms[1]) / norms[1]:.3e})")
    if not norm_err <= OPT_TOL:
        raise AssertionError("the global norm differs between the card and the CPU")
    eps = torch.finfo(torch.float32).eps
    times = {}
    for opt, sched in OPT_CASES:
        cfg = TrainConfig(opt=opt, sched=sched, lr=5e-4, warmup_lr=1e-6, warmup_epochs=1,
                          epochs=3, decay_epochs=1, decay_rate=0.5, weight_decay=0.05,
                          clip_grad=5.0, lr_noise=None if sched == "plateau" else (0.0,),
                          aa="", color_jitter=0.0)
        runs = {}
        for dev in ("cpu", "cuda"):
            tx = optim.make_optimizer(cfg, named[dev], 2)
            params = flat0.to(dev).clone()
            path = torch.zeros_like(params)
            state = tx.init(params)
            for i in range(OPT_STEPS):
                if i == OPT_STEPS // 2:
                    optim.set_lr_scale(state, OPT_SCALE)
                before = params.clone()
                tx.update(grads[i].to(dev), state, params)
                path += (params - before).abs()
            runs[dev] = (tx, state, params, path)
        tx, state, params, _ = runs["cuda"]
        _, state_cpu, params_cpu, path = runs["cpu"]
        diff = (params.cpu() - params_cpu).abs()
        ulps = (diff / (eps * (flat0.abs() + path))).nan_to_num(0.0).max().item()
        moved = (params_cpu - flat0).abs().max().item()
        errs = [(diff.max().item(), moved)] + [
            _err(getattr(state, b).cpu(), getattr(state_cpu, b)) for b in state.BUFFERS]
        ok = (ulps <= OPT_ULPS and all(e <= OPT_TOL * mx for e, mx in errs[1:])
              and state.count == state_cpu.count == OPT_STEPS
              and state.scale == state_cpu.scale == OPT_SCALE and moved > 0)
        # one more update from the same state at scale 1 and at 0.25
        deltas = []
        for scale in (1.0, 0.25):
            st, p = copy_mod.deepcopy(state), torch.zeros_like(params)
            optim.set_lr_scale(st, scale)
            tx.update(grads[-1].cuda(), st, p)
            deltas.append(p)
        scale_err = (deltas[1] - 0.25 * deltas[0]).abs().max().item()
        scale_max = deltas[0].abs().max().item()
        scale_ok = scale_max > 0 and scale_err <= 1e-6 * scale_max
        grad = grads[-1].cuda()
        st, p = copy_mod.deepcopy(state), params.clone()
        times[f"{opt} {sched}"] = _timed(lambda: tx.update(grad, st, p), 20)
        print(f"[optimizer] {opt} {sched} ({state.kind}): card vs CPU after {OPT_STEPS} "
              f"updates, params {ulps:.2f} ulps (limit {OPT_ULPS}; max |diff| {errs[0][0]:.3e}"
              f", {errs[0][0] / moved:.3e} of the largest change {moved:.3e}), buffers "
              f"{', '.join(f'{e:.3e} of {mx:.3e}' for e, mx in errs[1:])} (limit "
              f"{OPT_TOL} of the largest); scale 0.25 moves {scale_err:.3e} off 0.25 x the "
              f"scale-1 update (max {scale_max:.3e}); update "
              f"{times[f'{opt} {sched}']:.3f} ms over {flat0.numel()} parameters "
              f"{'ok' if ok and scale_ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{opt} {sched}: the card's updates differ from the CPU's")
        if not scale_ok:
            raise AssertionError(f"{opt} {sched}: the LR scale does not multiply the update")
    print(f"[optimizer] update ms at {flat0.numel()} parameters: "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()) + f"; {smi}")
    return times


def _saved_opt(ckpt, epoch):
    import torch

    return torch.load(os.path.join(ckpt, f"state-{epoch}", "state.pt"),
                      weights_only=True)["state"]["opt"]


def run_optimizer_runtime(runtime, tmp, smi):
    """Phase 14d, through run(): soft-deit-tiny.sh's flags on phase 11's
    pickles with --sched plateau (patience 0, no cooldown, decay 0.5) and
    --lr-noise 0.3 (epochs 1-2 of 3), 4 steps an epoch: the scale in effect
    in each epoch must be the plateau scale after the epoch before times the
    epoch's noise, and the scale saved after each epoch the plateau's alone,
    PlateauController's on the val_acc1 that run() logged. Then 2 epochs
    resumed to a third against the 3 straight ones: parameters and Adam
    moments the same bits, the resumed third epoch at the straight one's
    scale. Then one epoch each of --opt sgd --sched step and --opt adam."""
    from deltakd_tpu_torch.configs.config import parse_args
    from deltakd_tpu_torch.cli import train as train_cli
    from deltakd_tpu_torch.train import loop, optim

    soft = runtime["soft_argv"]
    short = ["--steps-per-epoch", "4", "--eval-steps", "2"]
    plateau = ["--sched", "plateau", "--lr-noise", "0.3", "--patience-epochs", "0",
               "--cooldown-epochs", "0", "--decay-rate", "0.5", *short]
    record = {"installed": [], "saved": [], "val_acc1": []}
    real = {n: getattr(loop, n) for n in ("train_one_epoch", "validate", "save_checkpoint")}

    def train_one_epoch(state, *a, **kw):
        record["installed"].append(optim.get_lr_scale(state.opt_state))
        return real["train_one_epoch"](state, *a, **kw)

    def validate(*a, **kw):
        out = real["validate"](*a, **kw)
        record["val_acc1"].append(out["val_acc1"])
        return out

    def save_checkpoint(path, state, **kw):
        record["saved"].append(optim.get_lr_scale(state.opt_state))
        return real["save_checkpoint"](path, state, **kw)

    def run(argv):
        for v in record.values():
            v.clear()
        loop.train_one_epoch, loop.validate = train_one_epoch, validate
        loop.save_checkpoint = save_checkpoint
        try:
            t0 = time.perf_counter()
            metrics = train_cli.main(argv)
            seconds = time.perf_counter() - t0
        finally:
            for n, fn in real.items():
                setattr(loop, n, fn)
        return metrics, {k: list(v) for k, v in record.items()}, seconds

    argv = soft("plateau", "--epochs", "3", *plateau)
    cfg = parse_args(argv)
    straight, rec, seconds = run(argv)
    controller = optim.PlateauController(
        decay_rate=cfg.decay_rate, patience=cfg.patience_epochs, cooldown=cfg.cooldown_epochs,
        min_lr=cfg.min_lr, base_lr=cfg.lr)
    want_saved = [controller.epoch_end(a) for a in rec["val_acc1"]]
    before = [1.0] + want_saved[:-1]
    want_installed = [b * optim.lr_noise_multiplier(cfg, e) for e, b in enumerate(before)]
    print(f"[optimizer run()] plateau + lr noise, 3 epochs in {seconds:.1f} s: val_acc1 "
          f"{rec['val_acc1']}; scale in effect {rec['installed']} (want {want_installed}); "
          f"saved {rec['saved']} (want {want_saved}); {straight}")
    if rec["installed"] != want_installed or rec["saved"] != want_saved:
        raise AssertionError("run(): the LR scales do not follow the plateau and the noise")
    if not all(math.isfinite(v) for v in straight.values()):
        raise AssertionError(f"run() with --sched plateau: non-finite metrics {straight}")
    ckpt = os.path.join(tmp, "plateau", "checkpoint")
    if _saved_opt(ckpt, 3)["scale"] != want_saved[2]:
        raise AssertionError("run(): the checkpoint's scale is not the plateau's")

    run(soft("plateau-resumed", "--epochs", "2", *plateau))
    resumed_ckpt = os.path.join(tmp, "plateau-resumed", "checkpoint")
    _, rec_resumed, _ = run(soft("plateau-resumed", "--epochs", "3", "--resume",
                                 "--checkpoint", resumed_ckpt, *plateau))
    same, _ = _same_state(os.path.join(ckpt, "state-3"), os.path.join(resumed_ckpt, "state-3"))
    print(f"[optimizer run()] resumed at epoch 2: scale in effect {rec_resumed['installed']} "
          f"(straight {rec['installed'][2:]}); parameters and moments "
          f"{'the same bits' if same else 'DIFFER'}")
    if not same or rec_resumed["installed"] != rec["installed"][2:]:
        raise AssertionError("run(): the resumed plateau run differs from the straight one")

    for name, flags, kind in (("sgd-step", ["--opt", "sgd", "--sched", "step"], "sgd"),
                              ("adam", ["--opt", "adam"], "adam")):
        metrics, _, seconds = run(soft(name, "--epochs", "1", *flags, *short))
        saved = _saved_opt(os.path.join(tmp, name, "checkpoint"), 1)
        print(f"[optimizer run()] {' '.join(flags)}: 1 epoch in {seconds:.1f} s, {metrics}; "
              f"checkpoint optimizer {saved['kind']}, {saved['count']} updates")
        if saved["kind"] != kind or saved["count"] != 4 or not all(
                math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"run() with {flags}: {metrics}, saved {saved['kind']}")


def run_token_dropout(mods, smi):
    """Phase 14e: a student with token dropout (drop_rate DROP_RATE) at full
    width: its dropout on the tokens alone (the kept share within 6 standard
    deviations of 1 - p, the kept values x / (1 - p) exactly, the others 0);
    two soft-KD steps with finite metrics and changed parameters; and its
    eval logits the same bits as those of the same weights without dropout."""
    import dataclasses

    import torch

    from deltakd_tpu_torch.models import registry

    name = "deit_tiny_distilled_dropout_patch16_224"
    registry.MODEL_REGISTRY[name] = dataclasses.replace(
        registry.MODEL_REGISTRY["deit_tiny_distilled_patch16_224"], drop_rate=DROP_RATE)
    try:
        launches, ms, _, kept = run_train_path(
            mods, "soft", 2, name="token dropout soft", options=dict(student_model=name))
    finally:
        del registry.MODEL_REGISTRY[name]
    _, student, _, aug, _, images, _ = kept
    x = torch.randn(B_MAIN, N_TOK, 192, generator=torch.Generator(device="cuda").manual_seed(5),
                    device="cuda").bfloat16()
    out = student.token_dropout(x, torch.Generator(device="cuda").manual_seed(6))
    kept_mask = out != 0
    n, p_keep = x.numel(), 1.0 - DROP_RATE
    share = kept_mask.float().mean().item()
    sigma = math.sqrt(p_keep * (1 - p_keep) / n)
    exact = torch.equal(out[kept_mask], (x / p_keep)[kept_mask])
    from deltakd_tpu_torch.data.augment import eval_transform

    xe = eval_transform(images[:16], aug).to(student.dtype)
    plain = copy.copy(student)
    plain.cfg = dataclasses.replace(student.cfg, drop_rate=0.0)
    with torch.no_grad():
        same_eval = torch.equal(student(xe, train=False).logits, plain(xe, train=False).logits)
    print(f"[token dropout] kept share {share:.6f} of {n} (1 - p = {p_keep}, 6 sigma "
          f"{6 * sigma:.2e}); kept values x / (1 - p) exactly: {exact}; eval logits equal "
          f"without dropout: {same_eval}; step {ms:.2f} ms, launches {launches}; {smi}")
    if abs(share - p_keep) > 6 * sigma or not exact or not same_eval:
        raise AssertionError("token dropout: the mask, its scale or eval is wrong")
    del student, kept
    return launches


# Phase 16, learning: the port trains a task to high accuracy on every kernel
# route, through distillation, and through run() on the recipe. The task is
# tests/test_learning.py's: 4 classes (horizontal stripes, vertical stripes,
# checkerboard, solid) of grey 30 / 230 with uniform noise, invariant to
# crops and flips, so that a pipeline that learns it is not learning a
# shortcut. A gradient that is biased but inside a kernel check's tolerance
# compounds over steps; these checks see the outcome.
LEARN_SIZE, LEARN_STRIPE = 224, 16     # 16a, 16b: 224 px, 16 px stripes (the JAX TPU test's)
LEARN_TRAIN, LEARN_TEST = 256, 128     # two training batches in turn; one held-out batch
LEARN_B = 128
LEARN_STEPS = 100
LEARN_BAR = 85.0          # % train top-1 at the last step and held-out top-1 (chance 25%)
# The LR: the JAX TPU test's 2e-3, reached by a linear warmup over 20 steps,
# then the cosine over the rest of a run. With no warmup, DeiT-Tiny stays on
# the task's first plateau past step 100 for some seeds, at a constant or a
# falling LR (scripts/learning_schedules.py)
LEARN_LR, LEARN_WARMUP = 2e-3, 20
# The JAX TPU test's own LR, a constant 2e-3 from the first step: 16a also
# runs the fused bf16 route (the JAX test's) under it, at seeds where it
# passes. Under it some seeds stay below the bar at step 100 on every route,
# the block's plain versions and the model's plain PyTorch ops too
# (scripts/learning_schedules.py --routes fused,fused-plain,plain), while
# the kernels' gradient stays as close to fp32 as the plain version's
# (scripts/gradient_fidelity.py); so the other runs take the warmup.
LEARN_CONSTANT = dict(sched="step", decay_rate=1.0, warmup_epochs=0)
LEARN_CONSTANT_SEEDS = (0, 3, 5)
TEACHER_STEPS = 160       # 16b's teacher (the JAX package's measurement's length)
LEARN_ROUTES = (("fused", "bfloat16"), ("pairs", "bfloat16"), ("unfused", "bfloat16"),
                ("fused", "float32"), ("pairs", "float32"), ("unfused", "float32"))
# 16c: CIFAR-100 pickles at 32 px: 16a's 224 px images reduced by means over
# 7 x 7 pixels, which the recipe's transform scales back to 224 px, so that
# 16b's teacher sees its own task
RUN_SIZE = 32
RUN_TRAIN, RUN_TEST = 1024, 256
RUN_EPOCHS = 12           # the recipe's 5 warmup epochs, then 7 on its cosine
RUN_BAR = 50.0            # % val top-1 of the last epoch (chance 25%)
# 16b's students: (name, TrainConfig fields, model, the heads whose held-out
# top-1 is held to LEARN_BAR, steps a schedule epoch). The distillation head
# learns from the soft term alone, which DeiT's loss divides by B x classes:
# at the recipe's alpha 0.1 and tau 3 it trails the class head by tens of
# steps, so it is held at DeiT's own soft-distillation weights and only read
# at the recipe's. The recipe's weights are also read under run()'s own
# schedule in 16c (soft-deit-tiny.sh's --lr 5e-4 and --weight-decay 1e-4,
# 5 warmup epochs from 1e-6, the cosine over RUN_EPOCHS epochs of 16c's
# steps), with no augmentation, its class head held: what 16c's
# distillation head could reach at 16c's LR.
DISTILL_STUDENTS = (
    ("soft", dict(distillation_type="soft", alpha=0.5, tau=1.0),
     "deit_tiny_distilled_patch16_224", ("class", "dist"), 1),
    ("soft at the recipe's alpha and tau", dict(distillation_type="soft", alpha=0.1, tau=3.0),
     "deit_tiny_distilled_patch16_224", ("class",), 1),
    ("soft at the recipe's alpha and tau under run()'s schedule",
     dict(distillation_type="soft", alpha=0.1, tau=3.0, lr=5e-4, weight_decay=1e-4,
          warmup_epochs=5, epochs=RUN_EPOCHS),
     "deit_tiny_distilled_patch16_224", ("class",), RUN_TRAIN // LEARN_B),
    ("wasskd", dict(distillation_type="wasskd", wasskd_type="l1"), "deit_tiny_patch16_224",
     ("class",), 1))


def texture_images(n, size, stripe, seed):
    """``n`` images of the texture task, uint8 [n, size, size, 3], and their
    labels in 0-3 (int64), made from ``seed`` with numpy as
    tests/test_learning.py makes them."""
    import numpy as np

    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 4, (n,)).astype(np.int64)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    pats = [(yy // stripe) % 2, (xx // stripe) % 2, ((yy // stripe) + (xx // stripe)) % 2,
            np.ones_like(yy)]
    imgs = np.zeros((n, size, size, 3), np.uint8)
    for i in range(n):
        p = pats[labels[i]] * 200 + 30
        imgs[i] = np.clip(np.stack([p] * 3, -1) + rng.randint(-20, 20, (size, size, 3)), 0, 255)
    return imgs, labels


def learn_data(device="cuda"):
    """16a's and 16b's data on ``device``: the two training batches and the
    held-out batch, each (uint8 images, labels)."""
    import torch

    train, train_labels = texture_images(LEARN_TRAIN, LEARN_SIZE, LEARN_STRIPE, 0)
    test, test_labels = texture_images(LEARN_TEST, LEARN_SIZE, LEARN_STRIPE, 1)
    on = lambda a: torch.from_numpy(a).to(device)   # noqa: E731
    batches = [(on(train[i:i + LEARN_B]), on(train_labels[i:i + LEARN_B]))
               for i in range(0, LEARN_TRAIN, LEARN_B)]
    return batches, (on(test), on(test_labels))


def _learn_config(dtype, steps, **extra):
    """tests/test_learning.py's TPU test: no KD, lr 2e-3, no drop-path, aa,
    mixup, erasing or smoothing (colour jitter at its default, as there),
    but the LR on LEARN_WARMUP steps of warmup and the cosine for a run of
    ``steps``, one schedule epoch a step (make_optimizer(cfg, ..., 1))."""
    from deltakd_tpu_torch.configs.config import TrainConfig

    return TrainConfig(**{**dict(batch_size=LEARN_B, distillation_type="none",
                                 dataset="cifar-100", input_size=LEARN_SIZE, dtype=dtype,
                                 drop_path_rate=0.0, epochs=steps, warmup_epochs=LEARN_WARMUP,
                                 lr=LEARN_LR, sched="cosine", mixup=0.0, cutmix=0.0,
                                 reprob=0.0, aa="", smoothing=0.0),
                          **extra})


class _PlainCalls:
    """Counts, while entered, the calls of the kernels' plain versions (each
    ``_plain_*`` function of the ops modules), so that a phase can show that
    none ran where the kernels should have."""

    def __init__(self, mods):
        self.mods = mods
        self.calls = collections.Counter()

    def __enter__(self):
        self.saved = []
        for mod in self.mods:
            for name in [n for n in vars(mod) if n.startswith("_plain_")]:
                fn = getattr(mod, name)
                self.saved.append((mod, name, fn))
                setattr(mod, name, self._counted(f"{mod.__name__.split('.')[-1]}.{name}", fn))
        return self

    def _counted(self, key, fn):
        def wrapper(*args, **kw):
            self.calls[key] += 1
            return fn(*args, **kw)
        return wrapper

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _no_fallback(what, launches, expect, plain):
    if launches != expect or plain:
        raise AssertionError(f"{what}: kernel launches {launches}, expected {expect}; "
                             f"plain versions run {dict(plain)}")


def _learn_steps(mods, what, step, state, batches, steps, per_step, gen):
    """``steps`` train steps over ``batches`` in turn, the launches counted
    from 0 around them: ``per_step`` times ``steps``, and no plain version.
    Returns the metrics of every step (floats) and the median step ms (host
    clock to a synchronize, steps after the first)."""
    import torch

    on_card = batches[0][0].device.type == "cuda"
    _reset_launches(mods)
    metrics, times = [], []
    with _PlainCalls(mods) as plain:
        for i in range(steps):
            images, labels = batches[i % len(batches)]
            t0 = time.perf_counter()
            metrics.append(step(state, images, labels, gen))
            if on_card:
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    _no_fallback(what, _read_launches(mods), {k: n * steps for k, n in per_step.items()},
                 plain.calls)
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    for i, m in enumerate(metrics):
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"{what}: non-finite metrics at step {i + 1}: {m}")
    return metrics, _median(times[1:]) * 1e3


def _heldout(mods, what, model, aug, test, per_batch):
    """Held-out top-1 (%) of ``model`` through build_eval_step on the
    held-out batch, its launches ``per_batch`` and no plain version; and the
    distillation head's top-1 where the model has one."""
    import torch

    from deltakd_tpu_torch.data.augment import eval_transform
    from deltakd_tpu_torch.train.step import build_eval_step, topk_correct

    images, labels = test
    eval_step = build_eval_step(student=model, aug=aug)
    _reset_launches(mods)
    with _PlainCalls(mods) as plain:
        sums = eval_step(images, labels, images.shape[0])
    _no_fallback(f"{what} eval", _read_launches(mods), per_batch, plain.calls)
    acc = float(sums["correct1"]) / float(sums["count"]) * 100
    dist = None
    if model.cfg.distilled:
        with torch.no_grad():
            out = model(eval_transform(images, aug).to(model.dtype), train=False)
        dist = float(topk_correct(out.logits_dist, labels, 1).float().mean()) * 100
    return acc, dist


def _first_above(metrics, bar):
    """The first step (from 1) whose train top-1 is above ``bar``, or None."""
    return next((i + 1 for i, m in enumerate(metrics) if m["train_acc1"] > bar), None)


def _losses(metrics, every=10):
    return " ".join(f"{i + 1}:{metrics[i]['train_loss']:.4f}"
                    for i in range(every - 1, len(metrics), every))


def learn_route(mods, route, dtype, data, seed=0, smi="", weights=None, **fields):
    """16a, one route: a DeiT-Tiny (full width and depth, 4 classes) from
    fresh weights (the seed's, or the state dict ``weights``) trained
    LEARN_STEPS steps on the texture task, then its held-out top-1.
    ``route`` 'fused' (rows 1, 2), 'pairs' (rows 7, 8; eval on single
    blocks, row 1) or 'unfused' (rows 3, 4 through flash_attention; eval
    adds fused_mlp, row 5), at ``dtype``'s form of the kernels, or 'plain'
    (the model's own PyTorch ops, no kernel: a reference for
    scripts/learning_schedules.py). ``fields`` are TrainConfig fields over
    _learn_config's. Returns the readings, ``ok`` whether the last step's
    train top-1 and the held-out top-1 are above LEARN_BAR; raises at once
    on a launch count, a plain version or a non-finite metric."""
    import torch

    from deltakd_tpu_torch.data.augment import AugmentConfig
    from deltakd_tpu_torch.kd.losses import KDSettings
    from deltakd_tpu_torch.models.factory import create_model
    from deltakd_tpu_torch.train.optim import make_optimizer
    from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
    from deltakd_tpu_torch.train.step import build_train_step

    fb, _, at, fm = mods
    batches, test = data
    device = test[0].device
    form = "_f32" if dtype == "float32" else ""
    bh = LEARN_B * 3                      # DeiT-Tiny's 3 heads
    blocks, eval_view, per_step, per_eval = {
        "fused": (dict(block_fn=fb.fused_vit_block), {},
                  {(f"fused_block_fwd{form}", 192): 12, (f"fused_block_bwd{form}", 192): 12},
                  {(f"fused_block_fwd{form}", 192): 12}),
        "pairs": (dict(block_fn=fb.fused_vit_block, block_pair_fn=fb.fused_vit_block_pair),
                  dict(block_pair_fn=None),
                  {(f"fused_pair_fwd{form}", 192): 6, (f"fused_pair_bwd{form}", 192): 6},
                  {(f"fused_block_fwd{form}", 192): 12}),
        "unfused": (dict(block_fn=None, attention_fn=at.flash_attention),
                    dict(mlp_fn=fm.fused_mlp),
                    {(f"flash_fwd{form}", bh): 12, (f"flash_bwd{form}", bh): 12},
                    {(f"flash_fwd{form}", bh): 12, (f"fused_mlp_fwd{form}", 192): 12}),
        "plain": (dict(block_fn=None), {}, {}, {}),
    }[route]
    name = f"{route} {'fp32' if form else 'bf16'}" + "".join(f", {k}={v}"
                                                            for k, v in fields.items())
    cfg = _learn_config(dtype, LEARN_STEPS, **fields)
    student = create_model("deit_tiny_patch16_224", num_classes=4, img_size=LEARN_SIZE,
                           dtype=torch.float32 if form else torch.bfloat16,
                           collect_features=False, seed=1 + seed, device=device, **blocks)
    if weights is not None:
        student.load_state_dict(weights)
    aug = AugmentConfig.from_config(cfg)
    tx = make_optimizer(cfg, trainable_parameters(student), 1)
    state = TrainState(student, tx=tx)
    step = build_train_step(cfg=cfg, kd=KDSettings.from_config(cfg), student=student,
                            teacher=None, aug=aug, mixup=None, tx=tx)
    gen = torch.Generator(device=device).manual_seed(3 + seed)
    metrics, ms = _learn_steps(mods, f"16a {name}", step, state, batches, LEARN_STEPS,
                               per_step, gen)
    held, _ = _heldout(mods, f"16a {name}", student.view(collect_features=False, **eval_view),
                       aug, test, per_eval)
    out = dict(train=metrics[-1]["train_acc1"], heldout=held, ms=ms,
               first=_first_above(metrics, LEARN_BAR), loss=metrics[-1]["train_loss"],
               last10=sum(m["train_acc1"] for m in metrics[-10:]) / 10, seed=seed)
    out["ok"] = out["train"] > LEARN_BAR and held > LEARN_BAR
    print(f"[learning] 16a {name} seed {seed}: loss by step {_losses(metrics)}")
    print(f"[learning] 16a {name} seed {seed} ({smi}): {'ok' if out['ok'] else 'FAIL'}: "
          f"train top-1 {out['train']:.1f}% at step {LEARN_STEPS} (first above "
          f"{LEARN_BAR:.0f}% at step {out['first']}), held-out top-1 {held:.1f}% (bar "
          f"{LEARN_BAR:.0f}% for both); median step {ms:.2f} ms at B={LEARN_B}; "
          f"{sum(per_step.values())} kernel launches a step, no plain version")
    return out


def learn_distillation(mods, data, seed=0, smi=""):
    """16b: a DeiT-S-distilled teacher (100 classes, labels 0-3) trained on the
    fused bf16 route for TEACHER_STEPS steps (its held-out top-1 must pass
    LEARN_BAR), then the DeiT-Tiny students of DISTILL_STUDENTS on the
    fused path from it, each for its schedule's steps: soft KD (the main
    path: row 1 at D = 384 and 192, row 2) and wasskd-l1 (rows 10 and 11 as
    well). The held-out top-1 of each head that a student's entry names
    must pass LEARN_BAR. Returns the readings and the trained teacher."""
    import torch

    from deltakd_tpu_torch.data.augment import AugmentConfig
    from deltakd_tpu_torch.kd.aux import AuxHeads
    from deltakd_tpu_torch.kd.losses import FEATURE_TYPES, KDSettings, feature_indices
    from deltakd_tpu_torch.models.factory import create_model
    from deltakd_tpu_torch.train.optim import make_optimizer
    from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
    from deltakd_tpu_torch.train.step import build_train_step

    fb = mods[0]
    batches, test = data
    device = test[0].device
    cfg = _learn_config("bfloat16", TEACHER_STEPS)
    aug = AugmentConfig.from_config(cfg)
    teacher = create_model("deit_small_distilled_patch16_224", num_classes=100,
                           img_size=LEARN_SIZE, block_fn=fb.fused_vit_block,
                           collect_features=False, seed=11 + seed, device=device)
    tx = make_optimizer(cfg, trainable_parameters(teacher), 1)
    state = TrainState(teacher, tx=tx)
    step = build_train_step(cfg=cfg, kd=KDSettings.from_config(cfg), student=teacher,
                            teacher=None, aug=aug, mixup=None, tx=tx)
    gen = torch.Generator(device=device).manual_seed(13 + seed)
    fwd = {("fused_block_fwd", 192): 12}
    metrics, ms = _learn_steps(mods, "16b teacher", step, state, batches, TEACHER_STEPS,
                               {("fused_block_fwd", 384): 12, ("fused_block_bwd", 384): 12},
                               gen)
    held, dist = _heldout(mods, "16b teacher", teacher.view(collect_features=False), aug,
                          test, {("fused_block_fwd", 384): 12})
    out = {"teacher": dict(train=metrics[-1]["train_acc1"], heldout=held, dist=dist, ms=ms,
                           first=_first_above(metrics, LEARN_BAR), ok=held > LEARN_BAR)}
    print(f"[learning] 16b teacher deit_small_distilled seed {seed}: loss by step "
          f"{_losses(metrics)}")
    print(f"[learning] 16b teacher seed {seed} ({smi}): held-out top-1 {held:.1f}% after "
          f"{TEACHER_STEPS} steps (its distillation head, which no loss trains, "
          f"{dist:.1f}%; train top-1 {out['teacher']['train']:.1f}%, first above "
          f"{LEARN_BAR:.0f}% at step {out['teacher']['first']}); median step {ms:.2f} ms")
    if held <= LEARN_BAR:
        raise AssertionError(f"16b: the teacher's held-out top-1 {held:.1f}% after "
                             f"{TEACHER_STEPS} steps (bar {LEARN_BAR}%)")
    teacher.requires_grad_(False)

    for name, options, student_name, held_heads, per_epoch in DISTILL_STUDENTS:
        kd_type = options["distillation_type"]
        cfg = _learn_config("bfloat16", LEARN_STEPS, **options)
        steps = cfg.epochs * per_epoch
        feats = feature_indices(kd_type, 12)
        student = create_model(student_name, num_classes=100, img_size=LEARN_SIZE,
                               block_fn=fb.fused_vit_block, collect_features=feats,
                               seed=21 + seed, device=device)
        aux = None
        if kd_type in FEATURE_TYPES:
            aux = AuxHeads(kd_type, 192, 384, torch.Generator().manual_seed(31 + seed)).to(device)
        tx = make_optimizer(cfg, trainable_parameters(student, aux), per_epoch)
        state = TrainState(student, tx=tx, aux=aux)
        kd = KDSettings.from_config(cfg, student_prefix=student.cfg.num_prefix_tokens,
                                    teacher_prefix=teacher.cfg.num_prefix_tokens)
        step = build_train_step(cfg=cfg, kd=kd, student=student,
                                teacher=teacher.view(collect_features=feats), aux=aux, aug=aug,
                                mixup=None, tx=tx)
        per_step = {("fused_block_fwd", 384): 12, ("fused_block_fwd", 192): 12,
                    ("fused_block_bwd", 192): 12}
        if kd_type == "wasskd":
            per_step.update(sorted_l1_fwd=3, sorted_l1_bwd=3)
        gen = torch.Generator(device=device).manual_seed(23 + seed)
        metrics, ms = _learn_steps(mods, f"16b {name}", step, state, batches, steps,
                                   per_step, gen)
        held, dist = _heldout(mods, f"16b {name}", student.view(collect_features=False), aug,
                              test, fwd)
        out[name] = dict(train=metrics[-1]["train_acc1"], heldout=held, dist=dist, ms=ms,
                         first=_first_above(metrics, LEARN_BAR),
                         ok=(("class" not in held_heads or held > LEARN_BAR)
                             and ("dist" not in held_heads or dist > LEARN_BAR)))
        print(f"[learning] 16b {name} {student_name} seed {seed}: loss by step "
              f"{_losses(metrics)}; distill loss by step "
              + " ".join(f"{i + 1}:{metrics[i]['distill_loss']:.5g}"
                         for i in range(9, steps, 10)))
        print(f"[learning] 16b {name} seed {seed} ({smi}): "
              f"{'ok' if out[name]['ok'] else 'FAIL'}: held-out top-1 {held:.1f}%"
              + ("" if "class" in held_heads else " (not held to the bar)")
              + (f", distillation head {dist:.1f}%" if dist is not None else "")
              + ("" if dist is None or "dist" in held_heads else " (not held to the bar)")
              + f"; train top-1 {out[name]['train']:.1f}% at step {steps} (first "
              f"above {LEARN_BAR:.0f}% at step {out[name]['first']}); median step "
              f"{ms:.2f} ms")
        del student, aux, state
    return out, teacher


def learn_recipe(mods, teacher, tmp, smi="", seed=0):
    """16c: run() through cli.train.main with soft-deit-tiny.sh's flags (RA,
    mixup and cutmix, erasing, alpha 0.1, tau 3) at B = LEARN_B for
    RUN_EPOCHS epochs on CIFAR-100 pickles of the texture task (32 px, as
    RUN_SIZE says), distilling from 16b's teacher written as phase 10
    writes a checkpoint (``write_teacher_of``). Its import must
    keep both 100-class heads. The train loss must fall from the first
    epoch to the last and the last epoch's val top-1 be at least RUN_BAR."""
    import numpy as np
    import torch

    from deltakd_tpu_torch.ckpt.checkpoint import student_state_dict
    from deltakd_tpu_torch.cli import train as train_cli
    from deltakd_tpu_torch.configs.config import TrainConfig
    from deltakd_tpu_torch.data.augment import AugmentConfig
    from deltakd_tpu_torch.models.factory import create_model
    from deltakd_tpu_torch.models.import_timm import load_state_dict, timm_to_torch

    path = os.path.join(tmp, "texture_teacher.pth")
    state = write_teacher_of(teacher, path, epoch=TEACHER_STEPS,
                             args="deit_small_distilled_patch16_224")
    check = create_model("deit_small_distilled_patch16_224", num_classes=100,
                         img_size=LEARN_SIZE, seed=0, device="cpu")
    report = timm_to_torch(load_state_dict(path), check)
    sd = check.state_dict()
    heads = ["head.weight", "head.bias", "head_dist.weight", "head_dist.bias"]
    same = all(torch.equal(sd[k], state[k]) for k in state)
    print(f"[learning] 16c teacher import: skipped {report['skipped']}, unconsumed "
          f"{report['unconsumed']}; heads {heads} kept; every tensor the file's: {same}")
    if report["skipped"] or report["unconsumed"] or not same:
        raise AssertionError("16c: the teacher checkpoint does not import whole")
    data = os.path.join(tmp, f"texture-cifar-{seed}")
    splits = {}
    f = LEARN_SIZE // RUN_SIZE
    for split, n, s in (("train", RUN_TRAIN, 2 + 2 * seed), ("test", RUN_TEST, 3 + 2 * seed)):
        imgs, labels = texture_images(n, LEARN_SIZE, LEARN_STRIPE, s)
        small = np.round(imgs.reshape(n, RUN_SIZE, f, RUN_SIZE, f, 3).mean((2, 4),
                                                                        dtype=np.float32))
        splits[split] = (small.astype(np.uint8), labels)
    write_cifar100_pickles(data, {k: (v.transpose(0, 3, 1, 2).reshape(len(v), -1), y)
                                  for k, (v, y) in splits.items()})
    soft = soft_recipe_argv(tmp, dict(DATA_PATH=data, TEACHER_CKPT=path))
    probe = RunProbe(mods)
    t0 = time.perf_counter()
    with probe, _PlainCalls(mods) as plain:
        final = train_cli.main(soft(f"texture-{seed}", "--epochs", str(RUN_EPOCHS),
                                    "--batch-size", str(LEARN_B), "--seed", str(42 + seed)))
    run_s = time.perf_counter() - t0
    steps = RUN_TRAIN // LEARN_B
    _check_launches("16c train steps", probe.step_launches,
                    {("fused_block_fwd", 384): 12, ("fused_block_fwd", 192): 12,
                     ("fused_block_bwd", 192): 12}, RUN_EPOCHS * steps)
    _check_launches("16c eval batches", probe.eval_launches, {("fused_block_fwd", 192): 12},
                    RUN_EPOCHS * -(-RUN_TEST // LEARN_B))
    _no_fallback("16c run()", {}, {}, plain.calls)   # its launches are held above
    losses = [m["train_loss"] for m in probe.epoch_metrics]
    distill = [m["distill_loss"] for m in probe.epoch_metrics]
    vals = [m["val_acc1"] for m in probe.val_metrics]
    # the teacher and the trained student's distillation head on the val images
    device = teacher.head.weight.device
    test = tuple(torch.from_numpy(a).to(device) for a in splits["test"])
    aug = AugmentConfig.from_config(TrainConfig(dataset="cifar-100", input_size=LEARN_SIZE))
    teacher_val, _ = _heldout(mods, "16c teacher", teacher.view(collect_features=False), aug,
                              test, {("fused_block_fwd", 384): 12})
    student = create_model("deit_tiny_distilled_patch16_224", num_classes=100,
                           img_size=LEARN_SIZE, collect_features=False, device=device)
    student.load_state_dict(student_state_dict(
        os.path.join(tmp, f"texture-{seed}", "checkpoint"))[0])
    _, dist_val = _heldout(mods, "16c student", student, aug, test,
                           {("fused_block_fwd", 192): 12})
    out = dict(losses=losses, vals=vals, val=final["val_acc1"], s=run_s,
               ms=_median(probe.step_ms()), teacher=teacher_val, dist=dist_val)
    out["ok"] = (len(losses) == RUN_EPOCHS and losses[-1] < losses[0]
                 and final["val_acc1"] >= RUN_BAR and np.isfinite(final["val_loss"]))
    print(f"[learning] 16c soft-deit-tiny.sh seed {seed} ({smi}): "
          f"{'ok' if out['ok'] else 'FAIL'}: {RUN_EPOCHS} epochs of "
          f"{steps} steps at B={LEARN_B} in {run_s:.1f} s; train loss by epoch "
          + ", ".join(f"{v:.4f}" for v in losses) + "; its distill loss by epoch "
          + ", ".join(f"{v:.5g}" for v in distill) + "; val top-1 by epoch "
          + ", ".join(f"{v:.1f}" for v in vals) + f" (bar {RUN_BAR:.0f}% at the last, and "
          f"the loss falling); the last student's distillation head {dist_val:.1f}%, the "
          f"teacher {teacher_val:.1f}% on the val images; run() train step {out['ms']:.2f} ms")
    return out


def _spread(values):
    done = [v for v in values if v is not None]
    if not done:
        return "none"
    return f"{min(done):.1f}-{max(done):.1f}" if len(done) > 1 else f"{done[0]:.1f}"


def run_learning(mods, smi, tmp, seeds=1):
    """Phase 16: 16a every route, 16b distillation and 16c run() on 16b's
    teacher, at ``seeds`` seeds each (their spread printed). Every reading
    is taken before the phase fails on one below its bar (a launch count,
    a plain version or a non-finite metric fails it at once). Returns the
    readings and the phase's seconds."""
    t0 = time.perf_counter()
    data = learn_data()
    got = collections.defaultdict(list)
    for seed in LEARN_CONSTANT_SEEDS:
        got["16a fused bfloat16 at a constant 2e-3"].append(
            learn_route(mods, "fused", "bfloat16", data, seed, smi, **LEARN_CONSTANT))
    for seed in range(seeds):
        for route, dtype in LEARN_ROUTES:
            got[f"16a {route} {dtype}"].append(learn_route(mods, route, dtype, data, seed, smi))
        distill, teacher = learn_distillation(mods, data, seed, smi)
        for k, v in distill.items():
            got[f"16b {k}"].append(v)
        got["16c"].append(learn_recipe(mods, teacher, tmp, smi, seed))
        del teacher
    if seeds > 1:
        for k, runs in got.items():
            if k == "16c":
                print(f"[learning] 16c over {seeds} seeds: last val top-1 "
                      f"{_spread([r['val'] for r in runs])}%, train loss first -> last epoch "
                      + ", ".join(f"{r['losses'][0]:.3f} -> {r['losses'][-1]:.3f}" for r in runs))
                continue
            print(f"[learning] {k} over {len(runs)} seeds: held-out top-1 "
                  f"{_spread([r['heldout'] for r in runs])}%, train top-1 "
                  f"{_spread([r['train'] for r in runs])}%, first above {LEARN_BAR:.0f}% at "
                  f"steps {_spread([r['first'] for r in runs])}"
                  + (f", distillation head {_spread([r['dist'] for r in runs])}%"
                     if runs[0].get("dist") is not None else ""))
    seconds = time.perf_counter() - t0
    print(f"[learning] phase 16 took {seconds:.1f} s ({smi})")
    failed = [f"{k} seed {r.get('seed', seed)}" for k, runs in got.items()
              for seed, r in enumerate(runs) if not r["ok"]]
    if failed:
        raise AssertionError(f"phase 16: below the bar: {', '.join(failed)}")
    return dict(readings=got, seconds=seconds)


# Phase 17: the JAX package's last two outcome checks, ported
# (scripts/soak_run.py, scripts/equivalence_run.py), driven through the
# port's run() on the fused bf16 route. Each script counts the launches of
# every train step and eval batch of its run() calls against the route's
# (scripts/run_probe.py) and fails on a plain version; here the counts are
# also read around each whole run for the kernels' line.
SOAK_EPOCHS = 24          # benchmarks/soak_run.py's: 12, then --resume to 24
# 17b's bar: % ours' final val top-1 at --quick (chance 12.5%: 16 of the 128
# val images). --quick trains 24 steps, most in the warmup; the first calls
# read 21.09, 36.72, 17.97, 15.62, 40.62% at seeds 0-4 (PERF.md), and the
# bf16 route repeats its digits at a seed
EQUIVALENCE_BAR = 14.0


def _outcome_scripts():
    """scripts/soak_run.py and scripts/equivalence_run.py as modules."""
    scripts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import equivalence_run
    import soak_run

    return soak_run, equivalence_run


def run_soak(mods, smi, tmp):
    """17a: the soak in full (SOAK_EPOCHS epochs of soft KD at 224 px, EMA
    0.996, a checkpoint each epoch, resumed at half way) on the fused bf16
    route; every gate of its analyze must pass. Returns the launches of
    the whole run and its readings."""
    soak_run, _ = _outcome_scripts()
    _reset_launches(mods)
    t0 = time.perf_counter()
    with _PlainCalls(mods) as plain:
        ok, r = soak_run.soak(SOAK_EPOCHS, "cuda", base=os.path.join(tmp, "soak"))
    seconds = time.perf_counter() - t0
    launches = _read_launches(mods)
    _no_fallback("17a soak", {}, {}, plain.calls)   # each step's launches: the script's
    print(f"[outcome] 17a soak ({smi}): {'ok' if ok else 'FAIL'}: {SOAK_EPOCHS} epochs "
          f"(resumed at {SOAK_EPOCHS // 2}) in {seconds:.1f} s; train loss "
          f"{r['losses'][0]:.3f} -> {r['losses'][-1]:.3f}; val top-1 by epoch "
          + ", ".join(f"{a:.1f}" for a in r["accs"]) + "; epoch s "
          + ", ".join(f"{t:.1f}" for t in r["times"]) + f" (early median {r['early']:.1f}, "
          f"late {r['late']:.1f}); loader wait ms a step by epoch "
          + ", ".join(f"{w:.3f}" for w in r["loader_wait_ms"]) + "; step ms by epoch "
          + ", ".join(f"{t:.1f}" for t in r["step_ms"]) + f"; launches {launches}, by phase "
          f"{r['launches']}")
    if not ok:
        raise AssertionError("17a: a gate of the soak failed (SOAK FAIL above)")
    shutil.rmtree(r["base"], ignore_errors=True)
    return launches, dict(r, seconds=seconds)


def run_equivalence(mods, smi, tmp, seeds=1):
    """17b: scripts/equivalence_run.py --quick --objective soft --dtype
    bfloat16 with both stacks at ``seeds`` seeds: the torch stack's
    teacher, its student and ours (run() on the fused bf16 route). Every
    seed's ours final val top-1 must reach EQUIVALENCE_BAR; the band verdict
    is printed. Returns the launches of ours' runs and the readings."""
    _, eq = _outcome_scripts()
    argv = ["--quick", "--objective", "soft", "--dtype", "bfloat16", "--seeds",
            *map(str, range(seeds)), "--workdir", os.path.join(tmp, "equivalence"),
            "--out", os.path.join(tmp, "EQUIVALENCE_quick.md")]
    _reset_launches(mods)
    t0 = time.perf_counter()
    with _PlainCalls(mods) as plain:
        out = eq.compare(argv)
    seconds = time.perf_counter() - t0
    launches = _read_launches(mods)
    _no_fallback("17b equivalence", {}, {}, plain.calls)
    rows = [out["results"][("soft", s)] for s in range(seeds)]
    delta, band, verdict = out["verdicts"]["soft"]
    print(f"[outcome] 17b equivalence --quick soft bf16 ({smi}) in {seconds:.1f} s: teacher "
          f"{out['teacher_acc']:.2f}%; by seed torch / ours final val top-1 "
          + ", ".join(f"{r['torch']['final_acc']:.2f} / {r['ours']['final_acc']:.2f}"
                      for r in rows) + f"; delta {delta:.2f}, {verdict} band {band:.2f}; "
          f"bar {EQUIVALENCE_BAR:.0f}% for ours; launches {launches}")
    low = [s for s, r in enumerate(rows) if r["ours"]["final_acc"] < EQUIVALENCE_BAR]
    if low:
        raise AssertionError(f"17b: ours' final val top-1 below {EQUIVALENCE_BAR}% at "
                             f"seeds {low}")
    return launches, dict(out, seconds=seconds)


def run_outcome_checks(mods, smi, tmp, seeds=1):
    """Phase 17: 17a then 17b. Returns the launches by path and the seconds."""
    import torch

    t0 = time.perf_counter()
    by_path = {}
    by_path["17a soak"], soak = run_soak(mods, smi, tmp)
    torch.cuda.empty_cache()
    by_path["17b equivalence"], equivalence = run_equivalence(mods, smi, tmp, seeds)
    seconds = time.perf_counter() - t0
    print(f"[outcome] phase 17 took {seconds:.1f} s (17a {soak['seconds']:.1f} s, 17b "
          f"{equivalence['seconds']:.1f} s)")
    return by_path, seconds


# ---------------------------------------------------------------------------
# Phase 18: long sequences (448 px and up)
# ---------------------------------------------------------------------------

# 18a's lengths: one row past the 11 tiles of dQ that the attention
# backward's short route holds in shared memory; 448 px (784 patches + 2);
# 512 px (1024 + 2); 576 px (1296 + 2)
LONG_ATTENTION_N = (705, 786, 1026, 1298)
LONG_BLOCK_N = (786, 1026)
# the token sort past one warp's 1024 keys: a row past it, WassKD-l1's patch
# rows at 576 px, and the longest the kernels take (1024 px)
LONG_SORT_N = (1025, 1296, 4096)
LONG_SORT_D = ((2, 100), (2, 384), (1, 3))   # (B, d): scalar loads; 16-byte loads; d < C
LONG_BLOCK_B = 6      # _pair_inputs sets all four scales of sample 5 to 0
LONG_STEP_PX, LONG_STEP_B = 448, 32       # 18b: the soft step on each route
LONG_WASSKD_PX, LONG_WASSKD_B = 576, 16   # 18b: the WassKD-l1 step
LONG_TIME_B = 32      # 18c: rows 2-4, 8 at the student's width and heads
LONG_SORT_SHAPE = (LONG_WASSKD_B, 1296, 384)   # 18c: one WassKD-l1 layer at 576 px
# 18a: the bf16 attention backward's split route forced where the short route
# runs, (B*H, N): its dq, dk and dv must be the short route's bits
SPLIT_BITS_SHAPES = ((4, 198), (96, 198), (4, 704), (96, 704))
# 18c: both routes forced at 4 to 11 query tiles (224 to 416 px, and 704), B*H = 96
# and 768
SPLIT_SWITCH_N, SPLIT_SWITCH_BH = (198, 258, 326, 402, 486, 531, 578, 678, 704), (96, 768)
# the kernels of the split route (attention_bwd.cuh), by the entry points that
# launch them above 256 rows
SPLIT_ROUTE_KERNELS = {
    "flash_bwd": ["attention_bwd_delta_kernel", "attention_bwd_split_kernel"],
    "fused_block_bwd": ["attention_bwd_split_kernel", "attention_bwd_colsum_kernel"]}
SPLIT_ROUTE_KERNELS["fused_pair_bwd"] = SPLIT_ROUTE_KERNELS["fused_block_bwd"]
# the rows whose JSON entry carries 18c's readings
LONG_ROWS = (("flash_fwd", 3 * B_MAIN), ("flash_bwd", 3 * B_MAIN), ("fused_block_bwd", 192),
             ("fused_pair_bwd", 192), "bitonic_sort", "sorted_l1_fwd", "sorted_l1_bwd")


def check_long_sequences(fb, at, so, worst):
    """Phase 18a: each kernel of the long routes against its plain version on
    the card, two runs the same bits: rows 3 and 4 (bf16 and fp32, also
    through the autograd Function on strided views of a packed qkv) at N =
    705, 786, 1026, 1298; rows 1, 2, 7, 8 (bf16 and fp32, with and without
    the feature output and cotangent) at D = 192 and 384, N = 786 and 1026;
    rows 9-11 at n = 1025, 1296, 4096 (the value sort in bf16, fp16, fp32 and
    int32, sorted_l1 in bf16 and fp32) at d = 100, 384 and 3."""
    import torch

    t0 = time.perf_counter()
    check_split_route_bits(at, worst)
    for n in LONG_ATTENTION_N:
        _hold_attention(at, worst, (4, n, HEAD_DIM))
        _hold_attention_views(at, worst, 1, 2, n)
        _hold_attention_f32(at, worst, (4, n, HEAD_DIM))
        _hold_attention_views_f32(at, worst, 1, 2, n)
    t1 = time.perf_counter()
    widths = BLOCK_WIDTHS[:2]
    check_block_forward_shapes(fb, worst, LONG_BLOCK_N, widths, LONG_BLOCK_B)
    check_block_backward_shapes(fb, worst, LONG_BLOCK_N, widths, LONG_BLOCK_B)
    for n in LONG_BLOCK_N:
        for D, H in widths:
            for nf in (False, True):
                seed = 18 * D + n + nf
                _hold_block_f32(fb, worst, D, H, LONG_BLOCK_B, n, nf, seed)
                _hold_pair_f32(fb, worst, D, H, LONG_BLOCK_B, nf, nf, seed, n=n)
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    for n in LONG_SORT_N:
        for B, d in LONG_SORT_D:
            for dtype in (torch.bfloat16, torch.float16, torch.float32, torch.int32):
                _hold_value_sort(so, worst, (B, n, d), dtype)
            for dtype in (torch.bfloat16, torch.float32):
                _hold_sort(so, worst, (B, n, d), dtype)
    print(f"[long] 18a: attention {t1 - t0:.1f} s, blocks and pairs {t2 - t1:.1f} s, sorts "
          f"{time.perf_counter() - t2:.1f} s")


def check_split_route_bits(at, worst):
    """Phase 18a: the bf16 attention backward's two routes forced
    (kernel_flash_bwd(route=...), which no model path sets) at N = 198 and
    704: the split route's dq, dk and dv the short route's bits, and the
    split route held to the plain version with two runs the same bits."""
    import torch

    for bh, n in SPLIT_BITS_SHAPES:
        q, k, v, do = _attention_inputs((bh, n, HEAD_DIM), bh + n)
        o, lse = at.kernel_flash_fwd(q, k, v)
        short = at.kernel_flash_bwd(q, k, v, o, lse, do, route="short")
        split = at.kernel_flash_bwd(q, k, v, o, lse, do, route="split")
        split2 = at.kernel_flash_bwd(q, k, v, o, lse, do, route="split")
        plain = at._plain_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        tag = f"split route forced [{bh},{n},{HEAD_DIM}]"
        _hold_all(worst, "flash_bwd", tag,
                  [(name, a, b, None) for name, a, b in zip(("dq", "dk", "dv"), split, plain)],
                  all(torch.equal(a, b) for a, b in zip(split, split2)))
        same = [torch.equal(a, b) for a, b in zip(split, short)]
        diffs = ", ".join(f"{name} {_err(a, b)[0]:.3e}"
                          for name, a, b in zip(("dq", "dk", "dv"), split, short))
        print(f"[long] {tag} against the short route: "
              f"{'the same bits' if all(same) else 'different bits'} (largest differences "
              f"{diffs}) {'ok' if all(same) else 'FAIL'}")
        if not all(same):
            raise AssertionError(f"{tag}: not the short route's bits")


def time_split_switch(at):
    """Phase 18c: the bf16 attention backward's two routes, each forced, at
    the lengths SPLIT_SWITCH_N and B*H of 96 and 768 (the switch between
    them). Returns {"BHxN": [short ms, split ms]}."""
    out = {}
    for bh in SPLIT_SWITCH_BH:
        for n in SPLIT_SWITCH_N:
            q, k, v, do = _attention_inputs((bh, n, HEAD_DIM), 3)
            o, lse = at.kernel_flash_fwd(q, k, v)
            short, split = (_timed(lambda: at.kernel_flash_bwd(q, k, v, o, lse, do, route=r), 10)
                            for r in ("short", "split"))
            out[f"{bh}x{n}"] = [short, split]
            print(f"[time long] flash_bwd [{bh},{n},{HEAD_DIM}]: short route {short:.4f} ms, "
                  f"split route {split:.4f} ms (short / split {short / split:.3f})")
    return out


def _long_config(kd_type, px, B, **extra):
    from deltakd_tpu_torch.configs.config import TrainConfig

    return TrainConfig(teacher_model="deit_small_distilled_patch16_224",
                       student_model="deit_tiny_distilled_patch16_224", batch_size=B,
                       distillation_type=kd_type, dataset="cifar-100", input_size=px,
                       dtype="bfloat16", drop_path_rate=0.1, aug_pixel_bf16=True, aa="",
                       color_jitter=0.0, allow_random_teacher=True, **extra)


def _long_step(mods, cfg, route):
    """One train step through build_train_step on ``route`` ("fused",
    "paired", "unfused" or "plain": attention_fn=None, no kernel) from
    load_teacher_student's seeded weights: (metrics, launches, the models,
    the step's peak allocated bytes)."""
    import numpy as np
    import torch

    from deltakd_tpu_torch.data.augment import AugmentConfig
    from deltakd_tpu_torch.data.mixup import MixupConfig
    from deltakd_tpu_torch.kd.losses import KDSettings
    from deltakd_tpu_torch.models.factory import load_teacher_student
    from deltakd_tpu_torch.train.optim import make_optimizer
    from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
    from deltakd_tpu_torch.train.step import build_train_step

    kw = dict(attention_fn=None) if route == "plain" else {}
    teacher, student, aux = load_teacher_student(
        cfg.replace(mesh_shape=(1, 2)) if route == "unfused" else cfg,
        block_pair=route == "paired", seed=0, device="cuda", **kw)
    tx = make_optimizer(cfg, trainable_parameters(student, aux), 100)
    state = TrainState(student, tx=tx, aux=aux)
    kd = KDSettings.from_config(cfg, student_prefix=student.cfg.num_prefix_tokens,
                                teacher_prefix=teacher.cfg.num_prefix_tokens)
    step = build_train_step(cfg=cfg, kd=kd, student=student, teacher=teacher, aux=aux,
                            aug=AugmentConfig.from_config(cfg),
                            mixup=MixupConfig.from_config(cfg, student.cfg.num_classes), tx=tx)
    host = np.random.RandomState(0)
    B = cfg.batch_size
    images = torch.from_numpy(host.randint(0, 256, (B, 32, 32, 3), dtype=np.uint8)).cuda()
    labels = torch.from_numpy(host.randint(0, student.cfg.num_classes, (B,))).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(mods)
    t0 = time.perf_counter()
    m = step(state, images, labels, torch.Generator(device="cuda").manual_seed(4))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    launches = _read_launches(mods)
    metrics = {k: float(v) for k, v in m.items()}
    print(f"[long] {route} {cfg.distillation_type} step at {cfg.input_size} px, B={B}: "
          + " ".join(f"{k}={v:.6g}" for k, v in metrics.items())
          + f" ({ms:.1f} ms, the first call; peak allocated {peak} bytes); launches {launches}")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"long {route} step: non-finite metrics {metrics}")
    return metrics, launches, (teacher, student, images, labels, kd), peak


def _long_gradient(mods, teacher, student, images, labels, kd, cfg):
    """The flat gradient of the soft-KD loss of one batch through ``student``
    with pinned drop-path scales, and the launches it made."""
    import torch

    from deltakd_tpu_torch.data.augment import AugmentConfig, eval_transform
    from deltakd_tpu_torch.kd.losses import total_loss

    batch = eval_transform(images, AugmentConfig.from_config(cfg)).bfloat16()
    scales = student.draw_drop_scales(batch.shape[0],
                                      torch.Generator(device="cuda").manual_seed(5), "cuda")
    with torch.no_grad():
        teacher_logits = teacher(batch, train=False).logits
    targets = torch.nn.functional.one_hot(labels.long(), student.cfg.num_classes).float()
    _reset_launches(mods)
    out = student(batch, train=True, drop_scales=scales)
    loss, _ = total_loss(kd, student_logits=out.logits, student_dist_logits=out.logits_dist,
                         student_feats=None, teacher_logits=teacher_logits, teacher_feats=None,
                         aux=None, targets=targets, train=True)
    flat = torch.cat([g.reshape(-1).float()
                      for g in torch.autograd.grad(loss, list(student.parameters()))])
    torch.cuda.synchronize()
    return loss.item(), flat, _read_launches(mods)


def _long_close(what, got, ref, tol):
    err = abs(got - ref)
    ok = err <= tol * max(abs(ref), 1e-3)
    print(f"[long] {what}: {got:.6g} vs the plain route's {ref:.6g} (rel {err / max(abs(ref), 1e-3):.3e}, "
          f"tol {tol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what} disagrees with the plain route on the card")


def run_long_steps(mods):
    """Phase 18b: one soft-KD step at full width (DeiT-S-distilled teacher,
    DeiT-Ti-distilled student, depth 12) through build_train_step at 448 px
    (N = 786) on the fused, paired and unfused routes, each launching its
    route's kernels and no plain version: the step's loss and gradient norm,
    and the soft-KD loss and flat gradient of one batch with pinned drop-path
    scales, held against the plain route on the card (attention_fn=None, the
    same seeded weights) within LOGIT_TOL; then one WassKD-l1 step at 576 px
    (1,296 patch rows) on the fused route, which launches the sorted_l1
    kernels, its losses held the same way. Returns the launches by path."""
    import torch

    t0 = time.perf_counter()
    by_path = {}
    cfg = _long_config("soft", LONG_STEP_PX, LONG_STEP_B)
    plain_m, plain_l, kept, _ = _long_step(mods, cfg, "plain")
    if plain_l:
        raise AssertionError(f"the plain route launched kernels: {plain_l}")
    plain_loss, plain_flat, _ = _long_gradient(mods, *kept, cfg)
    del kept
    for route in ("fused", "paired", "unfused"):
        torch.cuda.empty_cache()
        m, launches, kept, _ = _long_step(mods, cfg, route)
        expect = {"fused": _block_launches(1), "paired": _paired_launches(1),
                  "unfused": _unfused_launches(1, B=LONG_STEP_B)}[route]
        if launches != expect:
            raise AssertionError(f"long {route} step: launches {launches}, expected {expect}")
        by_path[f"long {route} soft"] = launches
        for key in ("train_loss", "distill_loss", "grad_norm"):
            _long_close(f"{route} step {key} at {LONG_STEP_PX} px", m[key], plain_m[key],
                        LOGIT_TOL)
        loss, flat, g_launches = _long_gradient(mods, *kept, cfg)
        _long_close(f"{route} soft-KD loss of one batch", loss, plain_loss, LOGIT_TOL)
        abs_err, mx = _err(flat, plain_flat)
        ok = abs_err <= LOGIT_TOL * mx and bool(torch.isfinite(flat).all())
        print(f"[long] {route} soft-KD gradient ({flat.numel()} values) vs the plain route: "
              f"max_abs_diff {abs_err:.3e}, max |plain| {mx:.3e} (rel {abs_err / mx:.3e}, "
              f"tol {LOGIT_TOL}) {'ok' if ok else 'FAIL'}; launches {g_launches}")
        if not ok:
            raise AssertionError(f"the long {route} route's gradient disagrees with the "
                                 f"plain route")
        del kept
    torch.cuda.empty_cache()
    cfg = _long_config("wasskd", LONG_WASSKD_PX, LONG_WASSKD_B)
    plain_m, _, kept, _ = _long_step(mods, cfg, "plain")
    del kept
    m, launches, kept, _ = _long_step(mods, cfg, "fused")
    del kept
    expect = dict(_block_launches(1), sorted_l1_fwd=3, sorted_l1_bwd=3)
    if launches != expect:
        raise AssertionError(f"long wasskd step: launches {launches}, expected {expect}")
    by_path["long fused wasskd"] = launches
    for key in ("train_loss", "distill_loss", "grad_norm"):
        _long_close(f"wasskd step {key} at {LONG_WASSKD_PX} px", m[key], plain_m[key],
                    LOGIT_TOL)
    torch.cuda.empty_cache()
    print(f"[long] 18b took {time.perf_counter() - t0:.1f} s")
    return by_path


def time_long_sequences(fb, at, so):
    """Phase 18c: rows 2 (the block backward, D = 192), 3 and 4 (flash_fwd,
    flash_bwd, 3 heads) and 8 (the pair backward, D = 192) at B = 32 and N =
    786 and 1026: kernel and plain times, the bound, the library's (SDPA's
    forward; for a backward the same block(s) or SDPA, forward+backward less
    forward) and beside each the forward+backward of
    F.scaled_dot_product_attention at the attention's shape, and at N = 786
    flash_bwd's kernels by torch.profiler (the split route's); then rows 9-11
    at [16, 1296, 384] (phase 4b's timing at n = 1296). Returns {kernel: {N
    or n: row}}."""
    import torch
    import torch.nn.functional as F

    rows = {}
    D, H, B = 192, 3, LONG_TIME_B
    for n in LONG_BLOCK_N:
        q, k, v, do = _attention_inputs((B * H, n, HEAD_DIM), 3)
        q4, k4, v4, do4 = (t.reshape(B, H, n, HEAD_DIM) for t in (q, k, v, do))
        leaves = [t.detach().requires_grad_(True) for t in (q4, k4, v4)]

        def sdpa_fwd():
            return F.scaled_dot_product_attention(*leaves)

        def sdpa_no_grad():
            with torch.no_grad():
                F.scaled_dot_product_attention(q4, k4, v4)

        sdpa_both = _timed(lambda: torch.autograd.grad(sdpa_fwd(), leaves, do4), 10)
        sdpa_fwd_ms = _timed(sdpa_fwd, 10)
        o, lse = at.kernel_flash_fwd(q, k, v)
        cases = {"flash_fwd": (lambda: at.kernel_flash_fwd(q, k, v),
                               lambda: at._plain_fwd(q, k, v), _timed(sdpa_no_grad, 10),
                               _attention_fwd_bound(B * H, n)),
                 "flash_bwd": (lambda: at.kernel_flash_bwd(q, k, v, o, lse, do),
                               lambda: at._plain_bwd(q, k, v, o, lse, do),
                               sdpa_both - sdpa_fwd_ms, _attention_bwd_bound(B * H, n))}
        p, x, sa, sm = _block_inputs(D, H, B, 7, "cuda", n=n)
        kw = dict(num_heads=H, scale_attn=sa, scale_mlp=sm)
        g_out = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(n),
                            device="cuda", dtype=x.dtype)
        lib_w = [t.detach().bfloat16().requires_grad_(True) for t in fb.block_params(p)]
        x_lib = x.detach().requires_grad_(True)
        lib_both = _timed(lambda: _library_block(x_lib, lib_w, H, 1e-6, sa, sm).backward(g_out), 5)
        lib_fwd = _timed(lambda: _library_block(x_lib, lib_w, H, 1e-6, sa, sm), 5)
        cases["fused_block_bwd"] = (
            lambda: fb.kernel_block_bwd(x, p, g_out, None, **kw),
            lambda: fb.reference_vit_block_bwd(x, p, g_out, None, **kw),
            lib_both - lib_fwd, _block_bwd_bound(B, n, D))
        p1, p2, xp, scales, (gp, _, _) = _pair_inputs(D, H, B, 13, "cuda", n=n)
        pkw = dict(num_heads=H, scales=scales)
        lib_w2 = [[t.detach().bfloat16().requires_grad_(True) for t in fb.block_params(pp)]
                  for pp in (p1, p2)]
        xp_lib = xp.detach().requires_grad_(True)

        def lib_pair():
            m = _library_block(xp_lib, lib_w2[0], H, 1e-6, scales[0], scales[1])
            return _library_block(m, lib_w2[1], H, 1e-6, scales[2], scales[3])

        pair_both = _timed(lambda: lib_pair().backward(gp), 5)
        pair_fwd = _timed(lib_pair, 5)
        cases["fused_pair_bwd"] = (
            lambda: fb.kernel_block_pair_bwd(xp, p1, p2, gp, **pkw),
            lambda: fb.reference_vit_block_pair_bwd(xp, p1, p2, gp, **pkw),
            pair_both - pair_fwd, _block_bwd_bound(B, n, D, blocks=2))
        if n == LONG_BLOCK_N[0]:   # the split route's kernels at 448 px
            profile_calls(f"flash_bwd [{B * H},{n},{HEAD_DIM}]", cases["flash_bwd"][0])
        for kernel, (fn, plain, library_ms, bound) in cases.items():
            row = dict(ms=_timed(fn, 10), plain_ms=_timed(plain, 3), library_ms=library_ms,
                       sdpa_fwd_bwd_ms=sdpa_both, **bound)
            rows.setdefault(kernel, {})[n] = row
            print(f"[time long] {kernel} B={B} N={n} (D={D}, {H} heads): {row['ms']:.3f} ms, "
                  f"plain {row['plain_ms']:.3f} ms, library {library_ms:.3f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}); scaled_dot_product_attention "
                  f"forward+backward at [{B},{H},{n},64] {sdpa_both:.3f} ms")
        del cases, x_lib, lib_w, xp_lib, lib_w2
        torch.cuda.empty_cache()
    for kernel, row in time_sort_kernels(so, LONG_SORT_SHAPE).items():
        rows[kernel] = {LONG_SORT_SHAPE[1]: row}
    return rows


def run_long_sequences(mods, smi):
    """Phase 18: 18a, 18b, 18c. Returns (launches by path, 18c's rows)."""
    fb, so, at, _ = mods
    t0 = time.perf_counter()
    worst = {}
    check_long_sequences(fb, at, so, worst)
    by_path = run_long_steps(mods)
    rows = time_long_sequences(fb, at, so)
    time_split_switch(at)
    print(f"[long] {smi}: phase 18 took {time.perf_counter() - t0:.1f} s; largest errors "
          + ", ".join(f"{k if isinstance(k, str) else f'{k[0]}[{k[1]}]'} {v:.3e}"
                      for k, v in sorted(worst.items(), key=str)))
    return by_path, rows, worst


# ---------------------------------------------------------------------------
# Phase 18d: past the old limits (the sorts past 4,096 rows, the attention
# past 47,104 tokens and past 65,535 batch x heads)
# ---------------------------------------------------------------------------

# the sorts' long route: a row past 4,096, two runs, WassKD-l1's 16,641 rows
# at 2064 px, 16 runs; (B, d): 16-byte loads, and d < the 4 columns of a block
PAST_SORT_N = (4097, 8192, 16641, 65536)
PAST_SORT_D = ((2, 96), (1, 3))
PAST_ATTENTION_N = 47105          # a row past the old cap, B*H = 1
PAST_HEADS = (65537, 8)           # row 3 alone: B*H, N
PAST_BLOCK = (192, 3, 21846, 8)   # row 1: D, H, B (B*H = 65,538), N
PAST_WASSKD_PX, PAST_WASSKD_B = 1040, 8   # 4,225 patch rows, 4,227 tokens
PAST_SOFT_PX, PAST_SOFT_B = 3488, 1       # 47,526 tokens
# The kernels at the shapes those two steps give them: sorted_l1 on the
# aligned features [B, 4225, 384] bf16; the attention at [B x heads, N, 64],
# the student's 3 heads forward and backward, the teacher's 6 forward only
PAST_PATH_SORT = (PAST_WASSKD_B, (PAST_WASSKD_PX // 16) ** 2, 384)
PAST_PATH_ATTENTION = tuple((B * H, (px // 16) ** 2 + 2, H == 3)
                            for px, B in ((PAST_WASSKD_PX, PAST_WASSKD_B),
                                          (PAST_SOFT_PX, PAST_SOFT_B)) for H in (3, 6))
# 18d's times: the sorts at [B, n, 384] (n = 4096 the last of the short
# route, 4,225 WassKD-l1's rows at 1040 px), the attention at 3488 px's length
PAST_SORT_TIMES = ((8, 4096, 384), (8, 4225, 384), (2, 8192, 384), (1, 16641, 384),
                   (1, 65536, 384))
PAST_ATTENTION_TIMES = ((3, 47526), (PAST_HEADS[0], PAST_HEADS[1]))   # (B*H, N)
# The bits of rows 1, 3, 9, 10 and 11 at the main shapes and of rows 9-11 at
# n = 1296 and 4096 (main_shape_bits: sha256 of each output, inputs drawn with
# numpy) as the kernels before the long route and the flattened grid give
# them (scripts/time_kernels.py --bits on the parent commit, e991dd9, NVIDIA
# H100 80GB HBM3). A change that alters them on purpose pins them anew.
PARENT_BITS = {
    "fused_block_fwd D=384": "da4204781d6a1f89", "fused_block_fwd D=192": "394c65186ffba799",
    "flash_fwd [1536,198,64]": "3bdc054aac295e0c",
    "bitonic_sort [256,196,384]": "6cf03d07c8685132",
    "sorted_l1_fwd [256,196,384]": "bf4d7be32554733c",
    "sorted_l1_bwd [256,196,384]": "2f42d47fc8d25aaf",
    "bitonic_sort [16,1296,384]": "4d18ef8273c0e99c",
    "sorted_l1_fwd [16,1296,384]": "04459dcbfe2dec0c",
    "sorted_l1_bwd [16,1296,384]": "a9824934bdf79eb1",
    "bitonic_sort [4,4096,384]": "ef9caae130fa5598",
    "sorted_l1_fwd [4,4096,384]": "df120bc567f1158f",
    "sorted_l1_bwd [4,4096,384]": "f9e67c3b8ac259d5"}


def _hold_sort_nan(so, worst, shape, dtype):
    """sorted_l1's kernels on `_sort_inputs` with NaN (sign bit clear) planted
    in a hundredth of s and of t: the loss NaN on both sides, the signs and
    the gradient equal to the plain sort's with sign(NaN) read as 0 (the
    kernels' rule: a NaN's difference has sign 0), two runs the same bits."""
    import torch

    s, t = _sort_inputs(shape, dtype, shape[1] + shape[2] + 1)
    g = torch.Generator().manual_seed(shape[1])
    for x in (s, t):
        at = torch.randperm(x.numel(), generator=g)[: max(3, x.numel() // 100)].cuda()
        x.view(-1)[at] = float("nan")
        x.copy_(torch.where(torch.isnan(x), x.abs(), x))
    total, sign = so.kernel_sorted_l1_fwd(s, t)
    total2, sign2 = so.kernel_sorted_l1_fwd(s, t)
    s_sorted, idx = torch.sort(s, dim=1, stable=True)
    diff = s_sorted.float() - torch.sort(t, dim=1).values.float()
    ref = torch.zeros(s.shape, dtype=torch.int8, device=s.device)
    ref.scatter_(1, idx, torch.nan_to_num(torch.sign(diff), nan=0.0).to(torch.int8))
    scale = torch.ones((), device="cuda") / s.numel()
    g_k, g_r = so.kernel_sorted_l1_bwd(sign, scale, dtype), so._plain_sl1_bwd(ref, scale, dtype)
    torch.cuda.synchronize()
    tag = f"{tuple(shape)} {str(dtype).split('.')[-1]} with NaN"
    checks = [("loss NaN", math.isnan(total.item()) and math.isnan(diff.abs().sum().item())),
              ("signs equal the plain sort's", torch.equal(sign, ref)),
              ("gradient equals the plain version's", torch.equal(g_k, g_r)),
              ("two runs give the same bits", torch.equal(sign, sign2)
               and math.isnan(total2.item()))]
    print(f"[past] sort {tag} ({int(torch.isnan(s).sum())} NaN in s): "
          + "; ".join(f"{name}: {'ok' if ok else 'FAIL'}" for name, ok in checks))
    for name, ok in checks:
        if not ok:
            raise AssertionError(f"sort kernels {tag}: {name} failed")


def _hold_attention_rows(at, worst, shape, backward=True):
    """Row 3 (and with ``backward`` row 4) at a length whose [N, N] scores
    may not fit: against the plain versions in query-row chunks
    (`_plain_fwd_rows`, `_plain_bwd_rows`), two runs the same bits."""
    import torch

    q, k, v, do = _attention_inputs(shape, shape[0] + shape[1])
    o, lse = at.kernel_flash_fwd(q, k, v)
    o2, lse2 = at.kernel_flash_fwd(q, k, v)
    r_o, r_lse = at._plain_fwd_rows(q, k, v)
    torch.cuda.synchronize()
    tag = f"{tuple(shape)} (plain in 1024-row chunks)"
    _hold_all(worst, "flash_fwd", tag, [("o", o, r_o, None), ("lse", lse, r_lse, LSE_TOL)],
              torch.equal(o, o2) and torch.equal(lse, lse2))
    del r_o, r_lse
    if backward:
        grads = at.kernel_flash_bwd(q, k, v, o, lse, do)
        grads2 = at.kernel_flash_bwd(q, k, v, o, lse, do)
        r_grads = at._plain_bwd_rows(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        _hold_all(worst, "flash_bwd", tag,
                  [(n, a, b, None) for n, a, b in zip(("dq", "dk", "dv"), grads, r_grads)],
                  all(torch.equal(a, b) for a, b in zip(grads, grads2)))


def check_past_limits(fb, at, so, worst):
    """Phase 18d's holds: rows 9 and 10 (and 11 behind them) on the long
    route at n = 4097, 8192, 16641, 65536 for (B, d) = (2, 96) and (1, 3):
    the value sort in four dtypes with NaN, +-inf and -0.0 (torch.sort's
    values, the NaNs last), sorted_l1 in bf16 and fp32 with ties and
    +0.0/-0.0 (signs and gradient exact, the loss to LOSS_TOL) and with NaN;
    rows 3 and 4 at [1, 47105, 64] against the plain versions in row chunks;
    rows 3 and 4 at B*H = 65,537 and row 1 at B*H = 65,538 (N = 8), where a
    grid's y would stop at 65,535; and the kernels at the shapes the 1040 px
    WassKD-l1 and 3488 px soft steps give them (PAST_PATH_SORT, sorted_l1 in
    bf16, and PAST_PATH_ATTENTION). Two runs the same bits each."""
    import torch

    t0 = time.perf_counter()
    for n in PAST_SORT_N:
        for B, d in PAST_SORT_D:
            for dtype in (torch.bfloat16, torch.float16, torch.float32, torch.int32):
                _hold_value_sort(so, worst, (B, n, d), dtype)
            for dtype in (torch.bfloat16, torch.float32):
                _hold_sort(so, worst, (B, n, d), dtype)
                _hold_sort_nan(so, worst, (B, n, d), dtype)
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    _hold_attention_rows(at, worst, (1, PAST_ATTENTION_N, HEAD_DIM))
    _hold_attention(at, worst, (*PAST_HEADS, HEAD_DIM))
    D, H, B, n = PAST_BLOCK
    check_block_forward_shapes(fb, worst, (n,), ((D, H),), B)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    _hold_sort(so, worst, PAST_PATH_SORT, torch.bfloat16)
    for bh, n, backward in PAST_PATH_ATTENTION:
        _hold_attention_rows(at, worst, (bh, n, HEAD_DIM), backward)
        torch.cuda.empty_cache()
    print(f"[past] 18d holds: sorts {t1 - t0:.1f} s, attention and blocks "
          f"{t2 - t1:.1f} s, at the steps' shapes {time.perf_counter() - t2:.1f} s")


def _np_block_inputs(D, H, B, n, seed):
    """`_block_inputs`' shapes and scales drawn with numpy (the same draws on
    any torch), on the card."""
    import numpy as np
    import torch

    from deltakd_tpu_torch.ops.fused_block import PARAM_NAMES

    rng = np.random.RandomState(seed)

    def r(*shape, sc):
        return torch.from_numpy((rng.randn(*shape) * sc).astype(np.float32))

    F = 4 * D
    wqkv = torch.cat([r(2 * D, D, sc=2 / math.sqrt(D)), r(D, D, sc=1 / math.sqrt(D))])
    ws = [1 + r(D, sc=.1), r(D, sc=.1), wqkv, r(3 * D, sc=.02),
          r(D, D, sc=1 / math.sqrt(D)), r(D, sc=.02), 1 + r(D, sc=.1), r(D, sc=.1),
          r(F, D, sc=1 / math.sqrt(D)), r(F, sc=.02), r(D, F, sc=1 / math.sqrt(F)),
          r(D, sc=.02)]
    params = {name: w.cuda() for name, w in zip(PARAM_NAMES, ws)}
    x = r(B, n, D, sc=1.0).bfloat16().cuda()
    scales = torch.from_numpy((rng.rand(2, B) < 0.9).astype(np.float32) / 0.9).cuda()
    return params, x, scales[0], scales[1]


def main_shape_bits(fb, at, so):
    """{output: sha256 digest} of rows 1 (the teacher's forward, D = 384, and
    the student's with its features, D = 192, at [256, 198, D]), 3 (flash_fwd's
    o and lse at [1536, 198, 64]) and 9-11 (the value sort, sorted_l1's sum,
    signs and gradient, bf16) at [256, 196, 384], [16, 1296, 384] and [4,
    4096, 384]: inputs drawn with numpy, so that the digests hold across
    torch builds."""
    import hashlib

    import numpy as np
    import torch

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def card(a, dtype=torch.bfloat16):
        return torch.from_numpy(a.astype(np.float32)).to(dtype).cuda()

    out = {}
    for D, H, feat in ((384, 6, False), (192, 3, True)):
        p, x, sa, sm = _np_block_inputs(D, H, B_MAIN, N_TOK, D)
        y, f = fb.kernel_block_fwd(x, p, num_heads=H, scale_attn=sa, scale_mlp=sm,
                                   need_features=feat)
        out[f"fused_block_fwd D={D}"] = digest(*([y, f] if feat else [y]))
    rng = np.random.RandomState(3)
    q, k, v = (card(1.5 * rng.randn(ATTN_MAIN["teacher"], N_TOK, HEAD_DIM)) for _ in range(3))
    out["flash_fwd [1536,198,64]"] = digest(*at.kernel_flash_fwd(q, k, v))
    for shape in (SORT_MAIN, (16, 1296, 384), (4, 4096, 384)):
        rng = np.random.RandomState(shape[1])
        s, t = (card(np.round(rng.randn(*shape) * 8) / 8) for _ in range(2))
        s[:, 2], s[:, 3] = 0.0, -0.0
        tag = f"[{','.join(map(str, shape))}]"
        out[f"bitonic_sort {tag}"] = digest(so.bitonic_sort_kernel(s))
        total, sign = so.kernel_sorted_l1_fwd(s, t)
        out[f"sorted_l1_fwd {tag}"] = digest(total.reshape(1), sign)
        g = so.kernel_sorted_l1_bwd(sign, torch.ones((), device="cuda") / s.numel(),
                                    torch.bfloat16)
        out[f"sorted_l1_bwd {tag}"] = digest(g)
    torch.cuda.synchronize()
    return out


def check_parent_bits(fb, at, so):
    """Phase 18d: `main_shape_bits` against PARENT_BITS (rows 1, 3, 9-11 at
    the main shapes and the sorts up to 4,096 rows give the bits they gave
    before the long route and the flattened grid)."""
    got = main_shape_bits(fb, at, so)
    diff = sorted(k for k in PARENT_BITS if got.get(k) != PARENT_BITS[k])
    print(f"[past] main-shape bits of {len(got)} outputs against the parent's: "
          + ("the same bits ok" if not diff else f"different bits in {diff} FAIL"))
    if diff:
        raise AssertionError(f"not the parent's bits: {diff}")


def run_past_limit_steps(mods):
    """Phase 18d's steps at full width and depth (DeiT-S-distilled teacher,
    DeiT-Ti-distilled student, bf16, the fused route, seeded random weights)
    through load_teacher_student and build_train_step: one WassKD-l1 step at
    1040 px (B = 8; 4,225 patch rows, the sorts' long route; 4,227 tokens,
    the attention's split route) and one soft-KD step at 3488 px (B = 1;
    47,526 tokens, past the old 47,104): finite metrics and each route's
    launches. Returns the launches by path and each step's peak bytes."""
    import torch

    by_path, peaks = {}, {}
    # three sorted_l1 calls a step, on the long route: its runs, stages and
    # finishes each a launch
    rows = (PAST_WASSKD_PX // 16) ** 2
    for kd, px, B, extra in (("wasskd", PAST_WASSKD_PX, PAST_WASSKD_B,
                              dict(sorted_l1_fwd=3 * mods[1].launches_per_call(rows, 2),
                                   sorted_l1_bwd=3)),
                             ("soft", PAST_SOFT_PX, PAST_SOFT_B, {})):
        torch.cuda.empty_cache()
        _, launches, kept, peak = _long_step(mods, _long_config(kd, px, B), "fused")
        del kept
        expect = dict(_block_launches(1), **extra)
        if launches != expect:
            raise AssertionError(f"{kd} step at {px} px: launches {launches}, expected {expect}")
        by_path[f"past fused {kd} {px}px"] = launches
        peaks[f"{kd} {px}px"] = peak
    torch.cuda.empty_cache()
    return by_path, peaks


def _sdpa_times(q4, k4, v4, do4, iters):
    """(forward ms without autograd, forward+backward ms, backend) of one
    F.scaled_dot_product_attention call on [B, H, N, 64]: PyTorch's own
    choice of backend, or where that fails (its cuDNN graph at 65,537
    heads) the math backend."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [t.detach().requires_grad_(True) for t in (q4, k4, v4)]

    def times():
        with torch.no_grad():
            fwd = _timed(lambda: F.scaled_dot_product_attention(q4, k4, v4), iters)
        both = _timed(lambda: torch.autograd.grad(F.scaled_dot_product_attention(*leaves),
                                                  leaves, do4), iters)
        return fwd, both

    try:
        return (*times(), "default")
    except RuntimeError as e:
        print(f"[time past] SDPA at {tuple(q4.shape)} failed on its default backend "
              f"({str(e).splitlines()[0][:120]}); timing the math backend")
    with sdpa_kernel(SDPBackend.MATH):
        return (*times(), "math")


def time_past_limits(at, so):
    """Phase 18d's times: rows 9-11 (`time_sort_kernels`) at PAST_SORT_TIMES
    and rows 3 and 4 at PAST_ATTENTION_TIMES beside their plain versions (in
    row chunks at 47,526), bounds and SDPA (forward; forward+backward less
    forward). Returns {kernel: {shape: row}}."""
    import torch

    rows = {}
    for shape in PAST_SORT_TIMES:
        for kernel, row in time_sort_kernels(so, shape).items():
            rows.setdefault(kernel, {})["x".join(map(str, shape))] = row
        torch.cuda.empty_cache()
    for bh, n in PAST_ATTENTION_TIMES:
        q, k, v, do = _attention_inputs((bh, n, HEAD_DIM), 3)
        o, lse = at.kernel_flash_fwd(q, k, v)
        q4, k4, v4, do4 = (t.reshape(1, bh, n, HEAD_DIM) for t in (q, k, v, do))
        chunked = n * n * 4 > 2**31
        plain_fwd = at._plain_fwd_rows if chunked else at._plain_fwd
        plain_bwd = at._plain_bwd_rows if chunked else at._plain_bwd
        iters = 3 if chunked else 10
        sdpa_fwd, sdpa_both, backend = _sdpa_times(q4, k4, v4, do4, iters)
        cases = {"flash_fwd": (lambda: at.kernel_flash_fwd(q, k, v),
                               lambda: plain_fwd(q, k, v), sdpa_fwd,
                               _attention_fwd_bound(bh, n)),
                 "flash_bwd": (lambda: at.kernel_flash_bwd(q, k, v, o, lse, do),
                               lambda: plain_bwd(q, k, v, o, lse, do), sdpa_both - sdpa_fwd,
                               _attention_bwd_bound(bh, n))}
        for kernel, (fn, plain, library_ms, bound) in cases.items():
            row = dict(ms=_timed(fn, iters), plain_ms=_timed(plain, 2), library_ms=library_ms,
                       library_backend=backend, **bound)
            rows.setdefault(kernel, {})[f"{bh}x{n}x{HEAD_DIM}"] = row
            print(f"[time past] {kernel} [{bh},{n},{HEAD_DIM}]: {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.3f} ms{' (row chunks)' if chunked else ''}, SDPA "
                  f"({backend}) {library_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']})")
        del q, k, v, do, o, lse, q4, k4, v4, do4, cases
        torch.cuda.empty_cache()
    return rows


def print_past_workspace(fb, at):
    """Phase 18d: the attention backward's workspace at the 1040 px and 3488
    px lengths, B*H of the student's and the teacher's heads: the bf16 split
    route's (O(B*H*N)) beside the fp32 form's, whose dQ partials, [key
    tile][B*H][N][64] fp32, grow as N^2; and the fp32 block backward's,
    which holds it in dhpre's slice."""
    lib = at._library()
    for B, N in ((PAST_WASSKD_B, PAST_WASSKD_PX ** 2 // 256 + 2),
                 (PAST_SOFT_B, PAST_SOFT_PX ** 2 // 256 + 2)):
        for H in (3, 6):
            dq = (N + 63) // 64 * B * H * N * 64 * 4
            print(f"[workspace past] attention backward B={B} H={H} N={N}: bf16 "
                  f"{lib.dk_flash_bwd_workspace(B, H, N)} bytes, fp32 "
                  f"{lib.dk_flash_bwd_f32_workspace(B, H, N)} bytes (its dQ partials {dq}); "
                  f"fp32 block backward (D = {64 * H}) "
                  f"{fb.workspace_bytes('fused_block_bwd_f32', (B, N, 64 * H), H, 256 * H)} "
                  f"bytes, bf16 {fb.workspace_bytes('fused_block_bwd', (B, N, 64 * H), H, 256 * H)}")


def run_past_limits(mods, smi):
    """Phase 18d: the holds, the main-shape bits, the two steps, the times.
    Returns (launches by path, times by kernel, largest errors)."""
    fb, so, at, _ = mods
    t0 = time.perf_counter()
    worst = {}
    check_past_limits(fb, at, so, worst)
    check_parent_bits(fb, at, so)
    print_past_workspace(fb, at)
    by_path, peaks = run_past_limit_steps(mods)
    rows = time_past_limits(at, so)
    print(f"[past] {smi}: phase 18d took {time.perf_counter() - t0:.1f} s; steps' peak "
          f"allocated bytes {peaks}; largest errors "
          + ", ".join(f"{k if isinstance(k, str) else f'{k[0]}[{k[1]}]'} {v:.3e}"
                      for k, v in sorted(worst.items(), key=str)))
    return by_path, rows, worst


# What two planted faults of phase 14a add to a source: a kernel that rounds
# n fp32 values to bf16 precision in place, and its launch on the stream `st`.
ROUND_KERNEL = ("__global__ void fault_round_bf16(float* p, long long n) {\n"
                "  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;\n"
                "  if (i < n) p[i] = __bfloat162float(__float2bfloat16(p[i]));\n}\n\n")
ROUND_LAUNCH = "fault_round_bf16<<<blocks_of({1}, 256), 256, 0, st>>>({0}, {1});"

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
     # in both routes of the bf16 attention backward (their lines differ in
     # indentation only)
     (("\n          sv[e] = pv[e] * (dp[idx] - delta_s[col]);",
       "\n          sv[e] = pv[e] * dp[idx];"),
      ("\n      sv[e] = pv[e] * (dp[idx] - delta_s[col]);", "\n      sv[e] = pv[e] * dp[idx];")),
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
    ("fc2 of the MLP forward's 32-wide tail chunk one k16 step short",
     "deltakd_tpu_torch/ops/csrc/fused_mlp.cu",
     (("for (int k = 0; k < 2; ++k) wgmma_ss(acc[nb], da + 2 * k, db + 2 * k, 1);",
       "for (int k = 0; k < 1; ++k) wgmma_ss(acc[nb], da + 2 * k, db + 2 * k, 1);"),),
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
    # the fp32 forms (phase 13a, 13b)
    ("one operand of an fp32 product rounded to bf16 (the attention forward's P)",
     "deltakd_tpu_torch/ops/csrc/attention_fwd.cuh",
     (("    tf32_a_fragments(pa[kk], pl[kk], e);",
       "    tf32_a_fragments(pa[kk], pl[kk], {__bfloat162float(__float2bfloat16(e[0])), "
       "__bfloat162float(__float2bfloat16(e[1])), __bfloat162float(__float2bfloat16(e[2])), "
       "__bfloat162float(__float2bfloat16(e[3]))});"),), "--fp32-checks"),
    ("an fp32 intermediate stored as bf16 (the GEMM epilogue's product operands)",
     "deltakd_tpu_torch/ops/csrc/gemm_sm90.cuh",
     (("void store2_lp(float* p, float a, float b) { store2(p, a, b); }",
       "void store2_lp(float* p, float a, float b) { store2(p, "
       "__bfloat162float(__float2bfloat16(a)), __bfloat162float(__float2bfloat16(b))); }"),),
     "--fp32-checks"),
    # the product of A's hi part with B's lo part left out of the fp32 GEMM's
    # k-step: 2xTF32, a single TF32 rounding of every weight operand
    ("the lo part of one operand of the fp32 GEMM left out",
     "deltakd_tpu_torch/ops/csrc/gemm_sm90.cuh",
     (("          wgmma_rs_tf32(acc[nb], a_lo[f], hi, kb > 0 || s > 0);\n"
       "          wgmma_rs_tf32(acc[nb], a_hi[f], lo, 1);",
       "          wgmma_rs_tf32(acc[nb], a_lo[f], hi, kb > 0 || s > 0);"),), "--fp32-checks"),
    # the fp32 GEMM's weight split once per call (split_weights_tf32_kernel)
    # and its A split in registers (linear_f32_kernel)
    ("the pre-split's lo part left out for B", "deltakd_tpu_torch/ops/csrc/gemm_sm90.cuh",
     (("      l[c] = x.y;", "      l[c] = 0.f;"),), "--fp32-checks"),
    # k-step 1 of each weight's row 0: its columns 0 and 1 hold m = 1 and 0
    ("a slot swap in one 8-block of B's k permutation",
     "deltakd_tpu_torch/ops/csrc/gemm_sm90.cuh",
     (("      const int c = tf32_key_slot(m);",
       "      const int c = tf32_key_slot(i == 1 ? m ^ 1 : m);"),), "--fp32-checks"),
    ("A's lo part dropped in registers", "deltakd_tpu_torch/ops/csrc/gemm_sm90.cuh",
     (("          a_lo[f][i] = __float_as_uint(hl.y);", "          a_lo[f][i] = 0u;"),),
     "--fp32-checks"),
    # the columns of a transposed tile in their natural order, where the A
    # fragments from registers want them in tf32_key_slot order: V^T as the
    # fp32 attention forward's producer writes it, K^T of the fp32 attention
    # backward (load_tile_f32_t)
    ("a wrong transpose of V^T in the fp32 attention forward",
     "deltakd_tpu_torch/ops/csrc/attention_fwd.cuh",
     (("  const int key = tid & 63, slot = (key & ~7) | tf32_key_slot(key & 7);",
       "  const int key = tid & 63, slot = key;"),), "--fp32-checks"),
    ("a wrong transpose of K^T in the fp32 attention backward",
     "deltakd_tpu_torch/ops/csrc/attention_fwd.cuh",
     (("    const int col = (r & ~7) | tf32_key_slot(r & 7);", "    const int col = r;"),),
     "--fp32-checks"),
    # the warp-specialised fp32 attention forward: its last chunk's keys
    # counted 8 short, one group (N = 198 computed on 192 keys; N = 8 on none)
    ("the fp32 attention forward's tail chunk cut one 8-key group short",
     "deltakd_tpu_torch/ops/csrc/attention_fwd.cuh",
     (("last_keys = x.N - last * T;", "last_keys = x.N - last * T - 8;"),), "--fp32-checks"),
    # ... its consumers reading K from the other slot of the ring than the
    # one whose full barrier they waited on (the ring stays in step)
    ("a ring slot of the fp32 attention forward read before its full barrier",
     "deltakd_tpu_torch/ops/csrc/attention_fwd.cuh",
     (("  return x.Ks + j % fwd32::SLOTS * attn32::SPLIT;",
       "  return x.Ks + (j + 1) % fwd32::SLOTS * attn32::SPLIT;"),),
     "--fp32-checks"),
    # ... its second consumer splitting the first one's 64 query rows as its Q
    ("the second consumer of the fp32 attention forward on the first one's Q rows",
     "deltakd_tpu_torch/ops/csrc/attention_fwd.cuh",
     (("    load_rows_f32(v, qh, p.q_sn, r0, N, tid);",
       "    load_rows_f32(v, qh, p.q_sn, q0, N, tid);"),), "--fp32-checks"),
    # the fp32 weight gradient (gemm_sm90.cuh weight_grad_f32_kernel): G^T's
    # lo part left out (2xTF32, a single TF32 rounding of every G)
    ("the lo part of G^T left out of the fp32 weight gradient",
     "deltakd_tpu_torch/ops/csrc/gemm_sm90.cuh",
     (("          wgmma_rs_tf32(acc, a_lo[k], d_hi + 2 * k, kb > kb0 || k > 0);\n"
       "          wgmma_rs_tf32(acc, a_hi[k], d_lo + 2 * k, 1);",
       "          wgmma_rs_tf32(acc, a_hi[k], d_lo + 2 * k, kb > kb0 || k > 0);"),),
     "--fp32-checks"),
    # ... its on-chip X^T: row m = 8 of each k-block also lands in the k slot
    # of m = 9, whose own row is lost
    ("one row of the X tile written to a wrong k slot of the fp32 weight gradient's X^T",
     "deltakd_tpu_torch/ops/csrc/gemm_sm90.cuh",
     (("x[n][u] = *reinterpret_cast<const float*>(xbox + box32_offset(8 * k + 2 * u + h, lane));",
       "x[n][u] = *reinterpret_cast<const float*>(xbox + box32_offset("
       "8 * k + 2 * u + h == 9 ? 8 : 8 * k + 2 * u + h, lane));"),), "--fp32-checks"),
    # the fp32 attention backward's prologue reads head 1's Q^T from head 0
    ("one head's Q^T from its neighbour in the fp32 attention backward's prologue",
     "deltakd_tpu_torch/ops/csrc/attention_bwd.cuh",
     (("  const float* qh = p.q + b * p.q_sb + h * p.q_sh;\n"
       "  const float* dh = p.dout + b * p.d_sb + h * p.d_sh;\n"
       "  for (int e = threadIdx.x;",
       "  const int src = bh == 1 ? 0 : bh;\n"
       "  const float* qh = p.q + (src / p.H) * p.q_sb + (src % p.H) * p.q_sh;\n"
       "  const float* dh = p.dout + b * p.d_sb + h * p.d_sh;\n"
       "  for (int e = threadIdx.x;"),), "--fp32-checks"),
    ("GELU left out of the fp32 MLP forward's fc1", "deltakd_tpu_torch/ops/csrc/fused_mlp.cu",
     (("f1.bias = (const float*)b1_; f1.gelu = 1;", "f1.bias = (const float*)b1_; f1.gelu = 0;"),),
     "--fp32-checks"),
    # the fp32 forms of rows 6-8 (phase 14a): a kernel that rounds an fp32
    # buffer to bf16 precision, added to the source, and its launch
    ("the fp32 pair's mid rounded to bf16", "deltakd_tpu_torch/ops/csrc/fused_block_pair.cu",
     (("template <typename T>\nstruct PairBwdBuffers {", ROUND_KERNEL
       + "template <typename T>\nstruct PairBwdBuffers {"),
      ("  if (err != cudaSuccess) return (int)err;\n  T* out = is_f32<T>",
       "  if (err != cudaSuccess) return (int)err;\n  if (is_f32<T>) " + ROUND_LAUNCH.format(
           "mid", "sh.M() * sh.D") + "\n  T* out = is_f32<T>"),
      ("  if (err == cudaSuccess)\n    err = forward_chain((const float*)b.mid",
       "  if (is_f32<T>) " + ROUND_LAUNCH.format("b.mid", "sh.M() * sh.D")
       + "\n  if (err == cudaSuccess)\n    err = forward_chain((const float*)b.mid")),
     "--fp32-checks"),
    ("the fp32 MLP backward's dhpre stored as bf16", "deltakd_tpu_torch/ops/csrc/fused_mlp.cu",
     (("template <typename T>\nstruct MlpBwdBuffers {", ROUND_KERNEL
       + "template <typename T>\nstruct MlpBwdBuffers {"),
      ("  cs_reduce(g.col_partial, linear_row_tiles(M), F, 0, (float*)db1, st);",
       "  if (is_f32<T>) " + ROUND_LAUNCH.format("(float*)g.dhpre", "(long long)M * F")
       + "\n  cs_reduce(g.col_partial, linear_row_tiles(M), F, 0, (float*)db1, st);")),
     "--fp32-checks"),
    # the optimizers (phase 14d): a Python edit of the port
    ("the LR scale left out of the sgd update", "deltakd_tpu_torch/train/optim.py",
     (("step_lr = _scaled(self.learning_rate(state.count), state)",
       "step_lr = self.learning_rate(state.count)"),), "--fp32-checks"),
    # data parallelism (phase 12a): a Python edit of the port, not a kernel
    ("the gradient all-reduce left out", "deltakd_tpu_torch/train/step.py",
     (("grads = dp.all_reduce(grads) / dp.world", "grads = grads"),), "--dp-checks"),
    ("one generator shared by both ranks", "deltakd_tpu_torch/train/loop.py",
     (("return epoch_generator(seed, epoch, device, dp.rank), shared",
       "return shared, shared"),), "--dp-checks"),
    ("the mixup flip kept local", "deltakd_tpu_torch/data/mixup.py",
     (("flipped = dp.swap_with_partner(images).flip(0)", "flipped = images.flip(0)"),
      ("flipped_labels = dp.swap_with_partner(labels).flip(0)",
       "flipped_labels = labels.flip(0)")), "--dp-checks"),
    ("LRKD's Gram left local", "deltakd_tpu_torch/kd/losses.py",
     (("gram = dp.all_reduce(torch.bmm(t2.mT, t2))", "gram = torch.bmm(t2.mT, t2)"),),
     "--dp-checks"),
    # learning (phase 16): the bf16 block backward hands back -dx at the block's
    # input (a kernel that negates it, added to the source, launched last)
    ("the sign of dx flipped at the bf16 block backward's input",
     "deltakd_tpu_torch/ops/csrc/fused_block_bwd.cu",
     (('extern "C" int dk_fused_block_bwd(void* const* ptr,',
       "__global__ void fault_negate_bf16(bf16* p, long long n) {\n"
       "  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;\n"
       "  if (i < n) p[i] = __float2bfloat16(-__bfloat162float(p[i]));\n}\n\n"
       'extern "C" int dk_fused_block_bwd(void* const* ptr,'),
      ("  return (int)reverse_chain(g_out, g_feat, s_attn, s_mlp, w, sh, f, g, dW, nullptr, dx, st);",
       "  const cudaError_t e =\n"
       "      reverse_chain(g_out, g_feat, s_attn, s_mlp, w, sh, f, g, dW, nullptr, dx, st);\n"
       "  fault_negate_bf16<<<blocks_of(sh.M() * sh.D, 256), 256, 0, st>>>(dx, sh.M() * sh.D);\n"
       "  return (int)e;")),
     "--learning-checks"),
    # the soak (phase 17a): --resume restores the epoch counter, the optimizer
    # and the EMA, but the student keeps its fresh weights
    ("the resume keeps the fresh student weights", "deltakd_tpu_torch/ckpt/checkpoint.py",
     (('    state.params.copy_(cut(saved["params"]))\n', ""),), "--outcome-checks"),
    # the long routes (phase 18a): the bf16 attention backward's split route
    # with its dQ kernel leaving out the key tiles past the 11th (what the
    # short route's shared memory holds) or its dK/dV kernel leaving out the
    # last query tile (its products run on N = 0: every P is 0), and the
    # sort's merge across warps skipping its stride-1024 stage (n_pad = 4096:
    # n = 4096)
    ("the split attention backward's dQ of key tiles past the 11th dropped",
     "deltakd_tpu_torch/ops/csrc/attention_bwd.cuh",
     (("    for (int e = 0; e < 32; ++e) dq[e] += dqi[e];",
       "    for (int e = 0; e < 32; ++e) dq[e] += j < 11 ? dqi[e] : 0.f;"),),
     "--long-sequence-checks"),
    ("the split attention backward's dK and dV without the last query tile",
     "deltakd_tpu_torch/ops/csrc/attention_bwd.cuh",
     (("split_pair_scores<true>(s, pa, sa, Ks, Vs, Qi, Di, st, st + T, j * T, i * T, N, s_log2e);",
       "split_pair_scores<true>(s, pa, sa, Ks, Vs, Qi, Di, st, st + T, j * T, i * T,\n"
       "                            i + 1 < tiles ? N : 0, s_log2e);"),),
     "--long-sequence-checks"),
    ("the sort's merge across warps without its stride-1024 stage",
     "deltakd_tpu_torch/ops/csrc/sort.cu",
     (("  const int p0 = kRun * run + 32 * lane;",
       "  if (mask == kRun) return;\n  const int p0 = kRun * run + 32 * lane;"),),
     "--long-sequence-checks"),
    # past the old limits (phase 18d's holds): the long sort's schedule
    # without its stride-4096 stage (n_pad >= 16384), the long route's padding
    # keyed as the smallest key (it merges in front of the real rows), and the
    # attention forward's CTA reading K and V of the head after the one whose
    # queries and output it holds (a head index off by one in the 1-D grid;
    # a shift of the whole index would only permute the work)
    ("a merge stage skipped above 4,096 rows (the long sort's stride-4096 stage)",
     "deltakd_tpu_torch/ops/sort.py",
     (("        while j >= _CHUNK:", "        while j > _CHUNK:"),), "--past-limit-checks"),
    ("the long route's padding keyed below the real keys", "deltakd_tpu_torch/ops/csrc/sort.cu",
     (("v[r] = long_key(in ? key_image<true>(xs[c * LD + row]) : Bits<T>::kMask, r0 + row);",
       "v[r] = long_key(in ? key_image<true>(xs[c * LD + row]) : 0u, r0 + row);"),
      ("u[r] = live && row < rows ? key_image(xs[c * LD + row]) : Bits<T>::kMask;",
       "u[r] = live && row < rows ? key_image(xs[c * LD + row]) : 0u;")),
     "--past-limit-checks"),
    ("the attention forward reading K and V of the neighbouring head",
     "deltakd_tpu_torch/ops/csrc/attention_fwd.cuh",
     (("  const bf16* kh = p.k + b * p.k_sb + h * p.k_sh;\n"
       "  const bf16* vh = p.v + b * p.v_sb + h * p.v_sh;\n",
       "  const int nb = (bh + 1) % (p.B * p.H);\n"
       "  const bf16* kh = p.k + nb / p.H * p.k_sb + nb % p.H * p.k_sh;\n"
       "  const bf16* vh = p.v + nb / p.H * p.v_sb + nb % p.H * p.v_sh;\n"),),
     "--past-limit-checks"),
)


def run_faults() -> int:
    """For each planted fault: a copy of the package and this script under
    .scratch/faults/ (ignored by git), the edit, then ``chip_smoke.py`` with
    the fault's check mode in the copy, which must exit 1. Returns 0 when
    every fault failed its run. ``--run-as MODE`` is a diagnostic, not a
    check: it runs the chosen faults under MODE instead, to read which of
    them another mode's checks catch (the backward's faults under phase 16
    show how blunt a learning check is)."""
    import shutil

    root = os.path.dirname(os.path.abspath(__file__))
    caught = []
    argv = sys.argv[1:]
    run_as = None
    if "--run-as" in argv:
        i = argv.index("--run-as")
        run_as = argv[i + 1]
        del argv[i:i + 2]
    only = [a for a in argv if a.endswith("-checks")]
    for i, (name, rel, edits, checks) in enumerate(FAULTS):
        if only and checks not in only:
            continue
        copy = os.path.join(root, ".scratch", "faults", str(i))
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(os.path.join(root, "deltakd_tpu_torch"),
                        os.path.join(copy, "deltakd_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy2(os.path.abspath(__file__), copy)
        # phase 17's scripts, and the torch stack's model that one of them imports
        shutil.copytree(os.path.join(root, "scripts"), os.path.join(copy, "scripts"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        os.makedirs(os.path.join(copy, "tests"))
        shutil.copy2(os.path.join(root, "tests", "torch_ref.py"), os.path.join(copy, "tests"))
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
        proc = subprocess.run([sys.executable, "chip_smoke.py", run_as or checks], cwd=copy,
                              capture_output=True, text=True, timeout=600)
        first = ([line for line in proc.stdout.splitlines() if "FAIL" in line]
                 or proc.stderr.strip().splitlines()[-1:] or ["(none)"])[0]
        print(f"[fault] {name} ({run_as or checks}): exit {proc.returncode} after "
              f"{time.perf_counter() - t0:.1f} s; "
              f"first failure: {first}")
        caught.append(proc.returncode == 1)
        shutil.rmtree(copy)
    print(f"[fault] {sum(caught)} of {len(caught)} planted faults failed their run")
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
    dp_checks = "--dp-checks" in sys.argv[1:]
    fp32_checks = "--fp32-checks" in sys.argv[1:]
    tp_checks = "--tp-checks" in sys.argv[1:]
    learning_checks = "--learning-checks" in sys.argv[1:]
    outcome_checks = "--outcome-checks" in sys.argv[1:]
    long_checks = "--long-sequence-checks" in sys.argv[1:]
    past_checks = "--past-limit-checks" in sys.argv[1:]
    seeds = int(sys.argv[sys.argv.index("--seeds") + 1]) if "--seeds" in sys.argv else 1
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
                        else ["fused_block_fwd", "fused_block_bwd"] if dp_checks
                        else ["fused_block_fwd", "fused_block_bwd", "fused_block_pair",
                              "attention", "fused_mlp"]
                        if fp32_checks else ["fused_block_fwd", "fused_block_bwd", "attention",
                                             "fused_mlp", "sort"] if tp_checks
                        else ["fused_block_fwd", "fused_block_bwd"] if outcome_checks
                        else ["fused_block_fwd", "sort", "attention"] if past_checks
                        else _build.SOURCES)
    lap = _Laps()
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
    if dp_checks:        # a planted-fault copy: phase 12a only
        run_data_parallel(mods, smi)
        return 0
    if tp_checks:        # phase 15 alone, on its own pickles and teacher checkpoint
        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        atexit.register(shutil.rmtree, tmp, True)
        os.environ.update(WANDB_MODE="disabled", WANDB_ERROR_REPORTING="false")
        write_cifar100(os.path.join(tmp, "data"), RUNTIME_TRAIN, RUNTIME_TEST)
        teacher_checkpoint = os.path.join(tmp, "deit_small_distilled_patch16_384.pth")
        write_teacher_checkpoint(teacher_checkpoint)
        run_tensor_parallel(mods, smi, soft_recipe_argv(tmp, dict(
            DATA_PATH=os.path.join(tmp, "data"), TEACHER_CKPT=teacher_checkpoint)), tmp)
        return 0
    if learning_checks:  # phase 16 alone
        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        atexit.register(shutil.rmtree, tmp, True)
        os.environ.update(WANDB_MODE="disabled", WANDB_ERROR_REPORTING="false")
        run_learning(mods, smi, tmp, seeds)
        return 0
    if long_checks:      # phase 18 alone (and a planted-fault copy of the long routes)
        run_long_sequences(mods, smi)
        run_past_limits(mods, smi)
        return 0
    if past_checks:      # a planted-fault copy: phase 18d's holds and bits only
        check_past_limits(fb, at, so, worst)
        check_parent_bits(fb, at, so)
        return 0
    if outcome_checks:   # phase 17 alone (--seeds N: 17b at seeds 0..N-1)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        atexit.register(shutil.rmtree, tmp, True)
        os.environ.update(WANDB_MODE="disabled", WANDB_ERROR_REPORTING="false")
        run_outcome_checks(mods, smi, tmp, seeds)
        return 0
    if fp32_checks:      # a planted-fault copy: the fp32 forms' checks at B=8 only
        check_fp32_blocks(fb, worst, seeds)
        check_fp32_weight_grads(fb, worst)
        check_fp32_linear(fb, worst)
        check_fp32_mlp(fm, worst, seeds)
        check_fp32_attention(at, worst)
        check_fp32_mlp_backward(fm, worst, seeds)
        check_fp32_pairs(fb, worst, seeds)
        print_fp32_ratios()
        check_optimizers(smi)
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
    time_mlp_shard_widths(fm, smi)
    check_pair_kernels(fb, worst)
    check_pair_cotangent_fp32(fb)
    timing.update(time_pair_kernels(fb))
    torch.cuda.empty_cache()

    lap("the kernels' checks and times")
    by_path, step_ms, peaks = {}, {}, {}
    for kd_type, steps in PATHS:
        by_path[kd_type], step_ms[kd_type], peaks[kd_type], kept = run_train_path(
            mods, kd_type, steps)
        teacher, student, aux, aug, kd, images, labels = kept
        if kd_type == "soft":
            by_path["eval"] = run_eval(mods, student, aug, images, labels,
                                       {("fused_block_fwd", 192): 12})
            check_against_cpu(teacher, student, aug, images)
        elif kd_type == "wasskd":
            check_features_against_cpu(teacher, student, aux, aug, kd, images)
        del teacher, student, aux, kept
        torch.cuda.empty_cache()

    lap("the train paths")
    # the recipes' objectives, each in its recipe's configuration
    for name, options, epochs in OBJECTIVE_PATHS:
        by_path[name], step_ms[name], peaks[name], kept = run_train_path(
            mods, options["distillation_type"], len(epochs), name=name, epochs=epochs,
            options=dict(RECIPE_COMMON, **options))
        teacher, student, aux, aug, kd, images, labels = kept
        if aux is not None:
            check_objective_against_cpu(name, teacher, student, aux, aug, kd, images)
        del teacher, student, aux, kept
        torch.cuda.empty_cache()
    print("[objectives] step ms, images/s and peak allocated GiB: " + "; ".join(
        f"{k} {step_ms[k]:.2f} ms {B_MAIN / step_ms[k] * 1e3:.1f} img/s "
        f"{peaks[k] / 2**30:.3f} GiB" for k in peaks))
    time_objective_solvers()
    by_path["value_sort"] = run_value_sort(so)

    lap("the objectives and the value sort")
    # the train-time data path, then the recipe's soft step with its teacher
    # imported from a checkpoint
    aug_ms = check_augment()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")   # phase 10's teacher for phase 11
    atexit.register(shutil.rmtree, tmp, True)
    teacher_checkpoint = os.path.join(tmp, "deit_small_distilled_patch16_384.pth")
    by_path["soft recipe"], step_ms["soft recipe"], kept = run_recipe_path(
        mods, teacher_checkpoint)
    del kept
    torch.cuda.empty_cache()
    plain_ms = aug_ms["aa='' bf16 32px"]["ms"]
    ra = aug_ms["RA bf16 32px"]
    print(f"[recipe] soft recipe step {step_ms['soft recipe']:.2f} ms beside the aa='' soft "
          f"step {step_ms['soft']:.2f} ms; the transform alone {ra['ms']:.3f} ms a batch on "
          f"the card, {ra['host_ms']:.3f} on the host's clock (aa='': {plain_ms:.3f}), mixup "
          f"{aug_ms['mixup batch']['ms']:.3f}")

    lap("the data path and the recipe step")
    # the unfused model path: its train steps, its eval batch on the eval view
    by_path["unfused_soft"], step_ms["unfused soft"], _, kept = run_train_path(
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

    lap("the unfused path")
    # the block-pair path: the student's blocks two per kernel
    for kd_type, steps in PAIRED_PATHS:
        name = f"paired {kd_type}"
        by_path[name], step_ms[name], _, kept = run_train_path(mods, kd_type, steps,
                                                               paired=True)
        teacher, student, aux, aug, kd, images, labels = kept
        if kd_type == "soft":
            by_path["paired_eval"] = run_eval(
                mods, student.view(block_pair_fn=None, collect_features=False), aug, images,
                labels, {("fused_block_fwd", 192): 12}, name="paired eval")
            check_paired_against_single(mods, teacher, student, aug, kd, images, labels)
        del teacher, student, aux, kept
        torch.cuda.empty_cache()
    by_path["odd_depth_pair"] = run_odd_depth_pair(mods, images, aug)

    lap("the paired path")
    # the runtime: run() and the CLIs with the flags of the recipes
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _reset_launches(mods)
    runtime = run_runtime_path(mods, tmp, teacher_checkpoint, smi, step_ms["soft recipe"])
    by_path["runtime"] = _read_launches(mods)
    step_ms["run()"] = runtime["step_ms"]
    print(f"[runtime] phase 11 took {time.perf_counter() - t0:.1f} s; launches "
          f"{by_path['runtime']}")

    lap("phase 11")
    # data parallelism: two ranks on the card over gloo; torchrun with NCCL
    torch.cuda.empty_cache()
    run_data_parallel(mods, smi, tmp, data_env=runtime["env"], state_11a=runtime["state_11a"],
                      soft_argv=runtime["soft_argv"])

    lap("phase 12")
    # the fp32 route: the kernels' fp32 forms, then an fp32 config's step
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check_fp32_blocks(fb, worst)
    check_fp32_weight_grads(fb, worst)
    check_fp32_linear(fb, worst, timed=True)
    print_fp32_backward_workspace(fb, fm, at)
    check_fp32_mlp(fm, worst)
    check_fp32_attention(at, worst)
    timing.update(time_fp32_kernels(fb, at, fm, worst, smi))
    torch.cuda.empty_cache()
    fp32_paths, step_ms["fp32 soft"] = run_fp32_route(mods, step_ms["soft"], smi)
    by_path.update(fp32_paths)
    print(f"[fp32] phase 13 took {time.perf_counter() - t0:.1f} s")

    lap("phase 13")
    # phase 14: the fp32 forms of rows 6-8 and the paired fp32 step,
    # fused_mlp_train at fp32, the optimizers, token dropout
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check_fp32_mlp_backward(fm, worst)
    check_fp32_pairs(fb, worst)
    timing.update(time_fp32_rows_6_8(fb, fm, worst, smi))
    print_fp32_ratios()
    torch.cuda.empty_cache()
    pair_paths, step_ms["fp32 paired soft"] = run_fp32_pair_route(mods, smi)
    by_path.update(pair_paths)
    by_path["fp32 fused_mlp_train"] = run_mlp_train(mods, fm, fp32=True)
    check_optimizers(smi)
    run_optimizer_runtime(runtime, tmp, smi)
    by_path["token dropout soft"] = run_token_dropout(mods, smi)
    torch.cuda.empty_cache()
    print(f"[phase 14] took {time.perf_counter() - t0:.1f} s")

    lap("phase 14")
    # phase 15: tensor parallelism, ranks sharing the card over gloo
    torch.cuda.empty_cache()
    run_tensor_parallel(mods, smi, runtime["soft_argv"], tmp)
    lap("phase 15")
    # phase 16: the port learns a task on every route, by distillation, under run()
    torch.cuda.empty_cache()
    learning = run_learning(mods, smi, tmp, seeds)
    lap("phase 16")
    # phase 17: the soak and the accuracy equivalence through run()
    torch.cuda.empty_cache()
    outcome, outcome_s = run_outcome_checks(mods, smi, tmp)
    by_path.update(outcome)
    lap("phase 17")
    # phase 18: long sequences, 448 px and up
    torch.cuda.empty_cache()
    long_paths, long_rows, long_worst = run_long_sequences(mods, smi)
    by_path.update(long_paths)
    past_paths, past_rows, past_worst = run_past_limits(mods, smi)
    by_path.update(past_paths)
    lap("phase 18")
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
           "fused_block_fwd_f32": (csrc + "fused_block_fwd.cu",
                                   "deltakd_tpu/ops/fused_block.py:313"),
           "fused_block_bwd_f32": (csrc + "fused_block_bwd.cu",
                                   "deltakd_tpu/ops/fused_block.py:478"),
           "flash_fwd_f32": (csrc + "attention.cu", "deltakd_tpu/ops/attention.py:46"),
           "flash_bwd_f32": (csrc + "attention.cu", "deltakd_tpu/ops/attention.py:62"),
           "fused_mlp_fwd": (csrc + "fused_mlp.cu", "deltakd_tpu/ops/fused_mlp.py:50"),
           "fused_mlp_fwd_f32": (csrc + "fused_mlp.cu", "deltakd_tpu/ops/fused_mlp.py:50"),
           "fused_mlp_bwd": (csrc + "fused_mlp.cu", "deltakd_tpu/ops/fused_mlp.py:126"),
           "fused_mlp_bwd_f32": (csrc + "fused_mlp.cu", "deltakd_tpu/ops/fused_mlp.py:126"),
           "fused_pair_fwd_f32": (csrc + "fused_block_pair.cu",
                                  "deltakd_tpu/ops/fused_block.py:929"),
           "fused_pair_bwd_f32": (csrc + "fused_block_pair.cu",
                                  "deltakd_tpu/ops/fused_block.py:982")}
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
        if kernel.endswith("_f32") and not kernel.startswith("flash"):
            # the fp32 linear product's kernels inside the entry point (gemm_sm90.cuh;
            # a backward splits W^T in its transpose)
            kernels[-1]["gemm_kernels"] = ["split_weights_tf32_kernel", "linear_f32_kernel"] + (
                ["transpose_kernel"] if "_bwd" in kernel else [])
        if key in LONG_ROWS:
            # phase 18c: the row at 448 and 512 px (B = 32; the sorts at n = 1296),
            # 18b's launches and 18a's largest error
            by_long_path = {path: sum(n for k, n in counts.items()
                                      if (k[0] if isinstance(k, tuple) else k) == kernel)
                            for path, counts in long_paths.items()}
            kernels[-1]["long_sequence"] = {
                "by_n": long_rows[kernel],
                "launches_by_path": {path: n for path, n in by_long_path.items() if n},
                **({"split_route_kernels": SPLIT_ROUTE_KERNELS[kernel]}
                   if kernel in SPLIT_ROUTE_KERNELS else {}),
                "max_abs_err": max(v for k, v in long_worst.items()
                                   if (k if isinstance(k, str) else k[0]) == kernel)}
        past = {"by_shape": past_rows.get(kernel, {}),
                "launches_by_path": {path: n for path, counts in past_paths.items()
                                     if (n := sum(c for k, c in counts.items()
                                                  if (k[0] if isinstance(k, tuple) else k)
                                                  == kernel))},
                "max_abs_err": max([v for k, v in past_worst.items()
                                    if (k if isinstance(k, str) else k[0]) == kernel],
                                   default=None)}
        if any(past.values()):
            # phase 18d: the row past the old limits (the sorts past 4,096 rows,
            # the attention at 47,526 tokens and past 65,535 batch x heads)
            kernels[-1]["past_old_limits"] = past
        if kernel in ATTENTION_FWD_F32_ROWS:
            # the warp-specialised fp32 attention forward (attention_fwd.cuh), in
            # flash_fwd_f32 and in every fp32 block and pair forward and recompute
            kernels[-1]["attention_kernels"] = ["attention_fwd_f32_ws_kernel"]
    if {k["source"] for k in kernels} != {csrc + f"{n}.cu" for n in _build.SOURCES}:
        raise AssertionError("a built source has no kernel in the report")
    print(f"[total] {time.perf_counter() - t_start:.1f} s (phase 16, learning: "
          f"{learning['seconds']:.1f} s; phase 17, the outcome checks: {outcome_s:.1f} s)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
