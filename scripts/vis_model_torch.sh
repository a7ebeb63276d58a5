#!/bin/bash
# Attention / localization visualization over the duet set through the
# PyTorch port (mirrors reference scripts/vis_model.sh): the demo pipeline
# on EVERY duet.csv clip with the CoLoc model; scripts/vis_model.sh's
# flags, unchanged.
OPTS=""
OPTS+="--demo_mode sweep "
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
OPTS+="--num_vis 8 "
OPTS+="--one_frame "

python -u -m avsep_tpu_torch.inference $OPTS
