#!/bin/bash
# Controlled A/B debug run WITHOUT the loop-closure rigid transform, on the
# PyTorch port's entry point.  Port of scripts/run_debug_norigidtransform.sh
# (python -m artdeco_tpu_torch.run_system, results under
# artdeco-tpu-torch-norigidtransform); run it from the repository's root.
set -e
work_dir=$(pwd)
base_dir=${BASE_DIR:-./data/self_captured_baselines}
result_dir=${RESULT_DIR:-./results}
img_dir=${IMG_DIR:-images}
run() { printf '%q ' "$@"; echo; "$@"; }

for src_dir in "$base_dir"/*; do
    [[ ! -d "$src_dir/$img_dir" ]] && { echo "No $img_dir/ in $src_dir"; continue; }
    dst_dir="$result_dir/$(basename "$src_dir")/artdeco-tpu-torch-norigidtransform"
    [[ -f "$dst_dir/run_metadata.json" ]] && { echo "$dst_dir contains results"; continue; }
    run python -m artdeco_tpu_torch.run_system \
        -s "$src_dir" \
        -i "$img_dir" \
        -m "$dst_dir" \
        --config config/base.yaml \
        -d selfCaptured \
        --num_key_iterations 30 \
        --downsampling 2.0 \
        --test_hold 8 \
        --no_rigid_transform_gaussians
done
