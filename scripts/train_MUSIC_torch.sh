#!/bin/bash
# Canonical joint AV+AO training recipe on MUSIC through the PyTorch port:
# scripts/train_MUSIC.sh's flags, unchanged, on the GPUs.
# Hyperparameters mirror the reference's published train_MUSIC.sh values;
# --num_gpus is the number of cards, one rank per card.
set -e

# ImageNet bootstrap for the frame encoder (the reference always starts from
# torchvision resnet18(pretrained=True), models/__init__.py:61-78).  This
# script downloads nothing: it passes data/resnet18-imagenet.pth when that
# file exists (tools/fetch_resnet18.py --src <local.pth> writes it).
PRETRAINED=data/resnet18-imagenet.pth
if [ ! -f "$PRETRAINED" ]; then
  echo "WARNING: no ImageNet weights — frame encoder will be randomly" \
       "initialized (reference parity requires the pretrained start)"
fi

args=(
  --id Exp5_BaseSig
  # data
  --av_list_train data/train.csv
  --ao_list_train data/train.csv
  --list_val data/val.csv
  --rate_dc 1 --max_silent 0.87 --train_repeat 50
  # models: U-Net7 mask decoder + dilated ResNet18-256 + CoLoc(sig) fusion
  --arch_sound unet7 --arch_frame resnet18dilated --arch_synthesizer linear
  --num_channels 2 --vis_channels 256
  --fusion_type hidsep --att_type sig --not_pool_vis
  --img_pool maxpool --img_activation relu --output_activation sigmoid
  # objective: weighted BCE on binary masks over the log-freq warp
  --loss bce --binary_mask 1 --weighted_loss 1 --mask_thres 0.5
  --num_mix 2 --log_freq 1 --match_weight 0.1
  # media geometry
  --num_frames 3 --stride_frames 8 --frameRate 30 --one_frame
  --audLen 65535 --audRate 11025
  # optimization: 95k iters, global batch 32, SGD decayed x0.1 3 times
  --num_gpus 2 --batch_size_per_gpu 16 --workers 4
  --lr_sound 1e-3 --lr_frame 1e-4 --lr_synthesizer 1e-3
  --lr_steps 50000 70000 90000 --num_iters 95001
  # schedule: AV batch every 2nd iter from the start
  --start_av_first --num_fsteps 0 --iter_per_av 2
  # cadence
  --eval_iter 1000 --disp_iter 20 --num_vis 100 --num_val 256
  # bf16 compute + explicit-DFT STFT, as scripts/train_MUSIC.sh.  Pass
  # --dtype float32 --dft fft for the float32 parity envelope.
  --dtype bfloat16 --dft matmul
)

if [ -f "$PRETRAINED" ]; then
  args+=(--weights_frame "$PRETRAINED")
fi

python -u -m avsep_tpu_torch.main "${args[@]}"
