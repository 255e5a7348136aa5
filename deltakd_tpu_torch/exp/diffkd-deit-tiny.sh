#!/bin/bash
source "$(dirname "$0")/_common.sh"

$TRAIN \
    --student-model deit_tiny_patch16_224 \
    --teacher-model deit_small_distilled_patch16_224 \
    --dataset cifar-100 \
    --data-path $DATA_PATH \
    --epochs 300 \
    --batch-size 256 \
    --lr 5e-4 \
    --weight-decay 1e-4 \
    --distillation-type diffkd \
    --log-file logs/diffkd-deit-tiny-cifar100.log \
    --save-dir checkpoints/diffkd-deit-tiny-cifar100 \
    --wandb \
    --wandb-project deltakd-tpu \
    $MESH_FLAGS $TEACHER_FLAGS $EXTRA_FLAGS
