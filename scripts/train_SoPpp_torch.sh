#!/bin/bash
# SoP++ 3-stage curriculum training through the PyTorch port (reference
# SoP++/main.py): basis U-Net with extra-channel bottleneck, InnerProd
# synthesizer, PIT attention module; scripts/train_SoPpp.sh's flags,
# unchanged.
OPTS=""
OPTS+="--id SoPpp_Base "
OPTS+="--av_list_train data/train.csv "
OPTS+="--ao_list_train data/train.csv "
OPTS+="--list_val data/val.csv "
OPTS+="--arch_sound unet7 "
OPTS+="--arch_synthesizer linear "
OPTS+="--arch_frame resnet18dilated "
OPTS+="--img_pool maxpool "
OPTS+="--num_channels 32 "       # basis channels == extra_size (SoP++)
OPTS+="--vis_channels 32 "
OPTS+="--fusion_type Base "      # Base -> AttModel; MatchAtt also valid
OPTS+="--att_type cos "
OPTS+="--not_pool_vis "
OPTS+="--img_activation relu "
OPTS+="--sound_activation no "
OPTS+="--output_activation sigmoid "
OPTS+="--binary_mask 1 "
OPTS+="--loss bce "
OPTS+="--weighted_loss 1 "
OPTS+="--num_mix 2 "
OPTS+="--log_freq 1 "
OPTS+="--num_frames 3 "
OPTS+="--stride_frames 8 "
OPTS+="--frameRate 30 "
OPTS+="--audLen 65535 "
OPTS+="--audRate 11025 "
OPTS+="--num_gpus 2 "
OPTS+="--workers 4 "
OPTS+="--batch_size_per_gpu 16 "
OPTS+="--lr_frame 1e-4 "
OPTS+="--lr_sound 1e-3 "
OPTS+="--lr_synthesizer 1e-3 "
OPTS+="--lr_steps 50000 70000 90000 "
OPTS+="--train_steps 20000 40000 95001 "  # 3-stage curriculum switches
OPTS+="--num_iters 95001 "
OPTS+="--iter_per_av 2 "
OPTS+="--eval_iter 1000 "
OPTS+="--train_repeat 50 "
OPTS+="--disp_iter 20 "
OPTS+="--rate_dc 1 "
OPTS+="--max_silent 0.87 "
OPTS+="--mask_thres 0.5 "
OPTS+="--match_weight 0.1 "
OPTS+="--one_frame "

python -u -m avsep_tpu_torch.sop_main $OPTS
