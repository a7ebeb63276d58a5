#!/bin/bash
# The SoP++ learning proof of scripts/train_toy_sop_proof.sh through the
# PyTorch port, on one GPU: build the class-token synthetic set (when
# $ROOT/tokens.json is missing), train the SoP++ recipe shape (basis
# unet7-32 + dilated ResNet18-32 + InnerProd + AttModel/cos, the 3-stage
# curriculum of scripts/train_SoPpp.sh) for 6000 iterations with a
# held-out eval every 650, then probe the frames-swap assignment accuracy
# and AV-vs-AO SI-SDR (avsep_tpu_torch.tools.sop_probe).
#
# The deviations of scripts/train_toy_sop_proof.sh from train_SoPpp.sh hold
# here too: lr_frame 1e-3 (no ImageNet bootstrap), the schedule compressed
# 95k -> 6k iterations with the stage boundaries scaled to match, one card.
#
#   scripts/train_toy_sop_proof_torch.sh build/toy_tok build/ckpt
#
# It ends with the probe's summary line.
set -e

ROOT=${1:-build/toy_tok}
CKPT=${2:-./ckpt}

if [ ! -f "$ROOT/tokens.json" ]; then
  python -m avsep_tpu_torch.tools.make_synthetic_data --root "$ROOT" \
    --classes cello flute violin trumpet --videos_per_class 6 \
    --duration 14 --fps 8 --class_tokens
  python - "$ROOT" <<'PYEOF'
import sys
root = sys.argv[1]
rows = [l.strip() for l in open(f"{root}/train.csv") if l.strip()]
train = [r for r in rows if not r.split(",")[0].endswith("5.wav")]
val = [r for r in rows if r.split(",")[0].endswith("5.wav")]
open(f"{root}/train_split.csv", "w").write("\n".join(train) + "\n")
open(f"{root}/val_split.csv", "w").write("\n".join(val) + "\n")
print(len(train), "train rows,", len(val), "held-out val rows")
PYEOF
fi

args=(
  --id sopproof
  --ckpt "$CKPT"
  --av_list_train "$ROOT/train_split.csv"
  --ao_list_train "$ROOT/train_split.csv"
  --list_val "$ROOT/val_split.csv"
  --arch_sound unet7 --arch_frame resnet18dilated --arch_synthesizer linear
  --num_channels 32 --vis_channels 32
  --fusion_type Base --att_type cos --not_pool_vis
  --img_pool maxpool --img_activation relu --sound_activation no
  --output_activation sigmoid
  --loss bce --binary_mask 1 --weighted_loss 1 --mask_thres 0.5
  --num_mix 2 --log_freq 1 --match_weight 0.1
  --one_frame --margin 1 --rate_dc 1 --train_repeat 50 --val_repeat 2
  --batch_size_per_gpu 16 --num_gpus 1 --workers 2
  --lr_sound 1e-3 --lr_frame 1e-3 --lr_synthesizer 1e-3
  --lr_steps 4200 5100 --num_iters 6001
  --train_steps 1300 2600 6001
  --iter_per_av 2 --start_av_first --num_fsteps 0
  --eval_iter 650 --disp_iter 50 --num_vis 0
)

python -u -m avsep_tpu_torch.sop_main --mode train "${args[@]}"

# frames-swap assignment accuracy + branch SI-SDR.  `latest` (not `best`):
# best_err tracks the loss, which the 3-stage curriculum pins to an early
# stage-1 snapshot whose AV path is untrained.
python -u -m avsep_tpu_torch.tools.sop_probe --probe_ckpt latest --mode eval \
  "${args[@]}" --val_repeat 8
