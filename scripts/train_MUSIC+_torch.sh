#!/bin/bash
# Warm-start continuation through the PyTorch port: resume Exp5_BaseSig from
# the latest checkpoint with decayed LRs (the checkpoint restores optimizer
# momentum and schedule position); scripts/train_MUSIC+.sh's flags,
# unchanged.
set -e

args=(
  --id Exp5_BaseSig
  --load_ckpt 1
  --av_list_train data/train.csv
  --ao_list_train data/train.csv
  --list_val data/val.csv
  --rate_dc 1 --max_silent 0.87 --train_repeat 50
  --arch_sound unet7 --arch_frame resnet18dilated
  --num_channels 2 --vis_channels 256
  --fusion_type hidsep --att_type sig --not_pool_vis
  --img_pool maxpool --img_activation relu --output_activation sigmoid
  --loss bce --binary_mask 1 --weighted_loss 1 --mask_thres 0.5
  --num_mix 2 --log_freq 1 --match_weight 0.1
  --num_frames 3 --stride_frames 8 --frameRate 30 --one_frame
  --audLen 65535 --audRate 11025
  --num_gpus 2 --batch_size_per_gpu 16 --workers 4
  --lr_sound 1e-4 --lr_frame 1e-5 --lr_steps 110000 --num_iters 120001
  --start_av_first --num_fsteps 0 --iter_per_av 2
  --eval_iter 1000 --disp_iter 20 --num_vis 100
  # bf16 compute + explicit-DFT STFT, as scripts/train_MUSIC+.sh
  --dtype bfloat16 --dft matmul
)

python -u -m avsep_tpu_torch.main "${args[@]}"
