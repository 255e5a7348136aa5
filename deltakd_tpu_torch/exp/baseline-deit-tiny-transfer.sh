#!/bin/bash
# Transfer-learning chain (reference exp/*-transfer.sh): finetune the
# CIFAR-100 checkpoint on flowers and caltech256 (stanford_cars left
# commented out upstream; enable by appending a third block).
source "$(dirname "$0")/_common.sh"
CKPT=${CKPT:-checkpoints/baseline-deit-tiny-cifar100/checkpoint}

for DS in flowers caltech256; do
$TRAIN \
    --student-model deit_tiny_patch16_224 \
    --teacher-model deit_small_distilled_patch16_224 \
    --dataset $DS \
    --data-path $DATA_PATH \
    --finetune \
    --checkpoint $CKPT \
    --epochs 1000 \
    --batch-size 512 \
    --lr 5e-4 \
    --weight-decay 1e-4 \
    --distillation-type none \
    --log-file logs/baseline-deit-tiny-$DS.log \
    --save-dir checkpoints/baseline-deit-tiny-$DS \
    --wandb \
    --wandb-project deltakd-tpu \
    $MESH_FLAGS $TEACHER_FLAGS $EXTRA_FLAGS
done
