#!/bin/bash
# wandb-sweep-driven LRKD run: hyperparameters arrive as env vars
# (reference exp/lrkd-deit-tiny-sweep.sh:4-7).
source "$(dirname "$0")/_common.sh"

LRKD_RANK=${lrkd_rank:-32}
LRKD_ALPHA=${lrkd_alpha:-0.1}
LRKD_BETA=${lrkd_beta:-0.1}
LRKD_GAMMA=${lrkd_gamma:-0.1}

$TRAIN \
    --student-model deit_tiny_patch16_224 \
    --teacher-model deit_small_distilled_patch16_224 \
    --dataset cifar-100 \
    --data-path $DATA_PATH \
    --epochs 20 \
    --batch-size 128 \
    --lr 5e-4 \
    --weight-decay 1e-4 \
    --alpha 0.5 \
    --lrkd-rank $LRKD_RANK \
    --lrkd-alpha $LRKD_ALPHA \
    --lrkd-beta $LRKD_BETA \
    --lrkd-gamma $LRKD_GAMMA \
    --distillation-type lrkd \
    --log-file logs/lrkd-deit-tiny-cifar100-sweep.log \
    --save-dir checkpoints/lrkd-deit-tiny-cifar100-sweep \
    --wandb \
    --wandb-project deltakd-tpu-lrkd \
    $MESH_FLAGS $TEACHER_FLAGS $EXTRA_FLAGS
