#!/bin/bash
# Pixelwise sound-map demo through the PyTorch port: every visual-map pixel
# drives the InnerProd synthesizer against the sound basis; writes a JET
# sound-energy overlay for the first duet clip.  SoP net family:
# vis_channels must equal num_channels.  scripts/vis_sound_map.sh's flags,
# unchanged.
OPTS=""
OPTS+="--demo_mode pixelwise "
OPTS+="--id Exp_SoPpp "
OPTS+="--list_val data/duet.csv "
OPTS+="--arch_sound unet7 "
OPTS+="--arch_frame resnet18dilated "
OPTS+="--arch_synthesizer linear "
OPTS+="--img_pool maxpool "
OPTS+="--num_channels 32 "
OPTS+="--vis_channels 32 "
OPTS+="--img_activation relu "
OPTS+="--not_pool_vis "
OPTS+="--att_type sig "
OPTS+="--num_mix 2 "
OPTS+="--log_freq 1 "
OPTS+="--audLen 65535 "
OPTS+="--audRate 11025 "
OPTS+="--one_frame "

python -u -m avsep_tpu_torch.inference $OPTS
