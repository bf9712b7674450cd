#!/bin/bash
# HAA-Transformer (ET) training / evaluation with the PyTorch port, on the
# card. Mirrors the reference's shipped paper script flag-for-flag
# (reference src/scripts/avdn_paper/run_et_haa.sh), as scripts/run_et_haa.sh
# does. Arguments given to this script are appended after its flags, so
# they win: e.g. --root_dir DIR --output_dir DIR --iters N. Several cards:
# one process per card with AVDN_NUM_PROCESSES, AVDN_COORDINATOR and
# AVDN_PROCESS_ID set (README).
set -e

seed=0

flag="--root_dir ../datasets

      --seed ${seed}

      --feedback student

      --max_action_len 10
      --max_instr_len 100

      --lr 1e-5
      --iters 200000
      --log_every 2
      --batch_size 4
      --optim adamW

      --ml_weight 0.2

      --nss_w 0.1
      --nss_r 0

      --darknet_model_file ../datasets/AVDN/pretrain_weights/yolo_v3.cfg
      --darknet_weight_file ../datasets/AVDN/pretrain_weights/best.pt
      --eval_first True
      "

# train
python -m avdn_tpu_torch.cli.train_et --output_dir ../datasets/AVDN/et_v8 $flag "$@"

# eval
# python -m avdn_tpu_torch.cli.train_et --output_dir ../datasets/AVDN/et_output $flag \
#       --resume_file ../datasets/AVDN/et_haa/ckpts/best_val_unseen.pt \
#       --inference True \
#       --submit True
