#!/bin/bash
# Single-clip demo through the PyTorch port: separation + attention-overlay
# videos on a duet clip (mirrors reference scripts/inference.sh);
# scripts/inference.sh's flags, unchanged.
#
# Usage: scripts/inference_torch.sh [vis|share|sweep|synthesis]
#   vis        attention-overlay demo on the first duet clip (default)
#   share      blank-frame ablation (reference inference.py:88-107)
#   sweep      demo on EVERY duet.csv row (reference inference.py:421-426)
#   synthesis  mix-and-separate two solo clips
# (pixelwise sound maps use the SoP config: see scripts/vis_sound_map_torch.sh)
MODE="${1:-vis}"
OPTS=""
OPTS+="--demo_mode ${MODE} "
OPTS+="--id Exp5_BaseSig "
OPTS+="--list_val data/duet.csv "
OPTS+="--arch_sound unet7 "
OPTS+="--arch_frame resnet18dilated "
OPTS+="--img_pool maxpool "
OPTS+="--num_channels 2 "
OPTS+="--vis_channels 256 "
OPTS+="--img_activation relu "
OPTS+="--fusion_type hidsep "
OPTS+="--not_pool_vis "
OPTS+="--att_type sig "
OPTS+="--binary_mask 1 "
OPTS+="--num_mix 2 "
OPTS+="--log_freq 1 "
OPTS+="--audLen 65535 "
OPTS+="--audRate 11025 "
OPTS+="--one_frame "

python -u -m avsep_tpu_torch.inference $OPTS
