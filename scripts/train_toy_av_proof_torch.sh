#!/bin/bash
# The recipe of scripts/train_toy_av_proof.sh through the PyTorch port, on
# one GPU: unet7 + dilated ResNet18-256 + CoLoc/sig, B = 16, 3000
# iterations on the class-token synthetic set, with an eval of the held-out
# split every 750 iterations (python -m avsep_tpu_torch.main --mode train).
#
# The set is the one scripts/train_toy_av_proof.sh builds in its first step
# (examples/make_synthetic_data.py --class_tokens and the train / val
# split), which needs the JAX package: build it there and pass its
# directory as ROOT.  tools/av_probe.py (pointing game, permutation
# accuracy) reads JAX checkpoints, so this script reports the train loop's
# own eval instead.
#
#   EXTRA_ARGS="--dtype bfloat16 --dft matmul" ID=bf16 \
#       scripts/train_toy_av_proof_torch.sh build/toy_tok build/toy_ckpt
#
# It ends with one JSON line: the AV and AO SI-SDR and SDR of each eval.
set -e

ROOT=${1:-build/toy_tok}
CKPT=${2:-./ckpt}
ID=${ID:-avproof}
[ -f "$ROOT/train_split.csv" ] || {
  echo "no $ROOT/train_split.csv: build the set first" >&2; exit 1; }

args=(
  --id "$ID"
  --ckpt "$CKPT"
  --av_list_train "$ROOT/train_split.csv"
  --ao_list_train "$ROOT/train_split.csv"
  --list_val "$ROOT/val_split.csv"
  --arch_sound unet7 --arch_frame resnet18dilated --arch_synthesizer linear
  --num_channels 2 --vis_channels 256
  --fusion_type hidsep --att_type sig --not_pool_vis
  --img_pool maxpool --img_activation relu --output_activation sigmoid
  --loss bce --binary_mask 1 --weighted_loss 1 --mask_thres 0.5
  --num_mix 2 --log_freq 1 --match_weight 0.1
  --one_frame --margin 1 --rate_dc 1 --train_repeat 50 --val_repeat 2
  --batch_size_per_gpu 16 --num_gpus 1 --workers 2
  --lr_sound 1e-3 --lr_frame 1e-3 --lr_steps 2000 2600 --num_iters 3001
  --start_av_first --num_fsteps 0 --iter_per_av 2
  --eval_iter 750 --disp_iter 50 --num_vis 0
)
[ -n "${EXTRA_ARGS:-}" ] && args+=(${EXTRA_ARGS})

python -u -m avsep_tpu_torch.main --mode train "${args[@]}"

python - "$CKPT/$ID/history_latest.json" <<'EOF'
import json
import sys

h = json.load(open(sys.argv[1]))
print(json.dumps({b: {k: h[b][k] for k in ("iter", "si_sdr", "sdr")}
                  for b in ("val_av", "val_ao")}))
EOF
