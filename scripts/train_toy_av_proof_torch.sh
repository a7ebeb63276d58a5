#!/bin/bash
# The audio-visual learning proof of scripts/train_toy_av_proof.sh through
# the PyTorch port, on one GPU: build the class-token synthetic set (when
# $ROOT/tokens.json is missing), train the flagship recipe shape (unet7 +
# dilated ResNet18-256 + CoLoc/sig, B = 16, 3000 iterations, an eval of the
# held-out split every 750), then probe permutation accuracy, the pointing
# game and AV-vs-AO SI-SDR on that split (avsep_tpu_torch.tools.av_probe).
#
# The deviations of scripts/train_toy_av_proof.sh from train_MUSIC.sh hold
# here too: no ImageNet bootstrap, so lr_frame 1e-3; 3k iterations.
# SHARED_BG=1 builds the variant where every video shares one background,
# so the class token is the only class-informative visual content.
#
#   SHARED_BG=1 scripts/train_toy_av_proof_torch.sh build/toy_tok build/ckpt
#   EXTRA_ARGS="--dtype bfloat16 --dft matmul" ID=bf16 \
#       scripts/train_toy_av_proof_torch.sh build/toy_tok build/ckpt
#
# It ends with the probe's summary line (PROBE_CKPT=latest probes the final
# iterate instead of the best-by-AO-SI-SDR checkpoint), then one JSON line:
# the AV and AO SI-SDR and SDR of each eval of the training run.
set -e

ROOT=${1:-build/toy_tok}
CKPT=${2:-./ckpt}
ID=${ID:-avproof}
SB_FLAG=""
[ "${SHARED_BG:-0}" = "1" ] && SB_FLAG="--shared_background"

if [ ! -f "$ROOT/tokens.json" ]; then
  python -m avsep_tpu_torch.tools.make_synthetic_data --root "$ROOT" \
    --classes cello flute violin trumpet --videos_per_class 6 \
    --duration 14 --fps 8 --class_tokens $SB_FLAG
  python - "$ROOT" <<'EOF'
import sys
root = sys.argv[1]
rows = [l.strip() for l in open(f"{root}/train.csv") if l.strip()]
train = [r for r in rows if not r.split(",")[0].endswith("5.wav")]
val = [r for r in rows if r.split(",")[0].endswith("5.wav")]
open(f"{root}/train_split.csv", "w").write("\n".join(train) + "\n")
open(f"{root}/val_split.csv", "w").write("\n".join(val) + "\n")
print(len(train), "train rows,", len(val), "held-out val rows")
EOF
fi

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

python -u -m avsep_tpu_torch.tools.av_probe --tokens_json "$ROOT/tokens.json" \
  --probe_ckpt "${PROBE_CKPT:-best}" --mode eval "${args[@]}"

python - "$CKPT/$ID/history_latest.json" <<'EOF'
import json
import sys

h = json.load(open(sys.argv[1]))
print(json.dumps({b: {k: h[b][k] for k in ("iter", "si_sdr", "sdr")}
                  for b in ("val_av", "val_ao")}))
EOF
