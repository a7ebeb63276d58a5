#!/bin/bash
# Full MUSIC val sweep through the PyTorch port: batched SDR/SIR/SAR/SI-SDR
# scoring on the GPU; scripts/eval_MUSIC.sh's flags, unchanged.
set -e

args=(
  --mode eval
  --id Exp5_BaseSig
  --list_val data/val.csv
  --batch_size_per_gpu 16 --num_vis 100
  --arch_sound unet7 --arch_frame resnet18dilated --arch_synthesizer linear
  --num_channels 2 --vis_channels 256
  --fusion_type hidsep --att_type sig --not_pool_vis
  --img_pool maxpool --img_activation relu
  --loss bce --binary_mask 1 --weighted_loss 1
  --num_mix 2 --log_freq 1
  --num_frames 3 --stride_frames 8 --frameRate 30 --one_frame
  --max_silent 0.83
  --audLen 65535 --audRate 11025
)

python -u -m avsep_tpu_torch.main "${args[@]}"
