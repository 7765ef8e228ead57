#!/bin/bash
# Active-learning sweep over per-noise-type subdirectories on the port
# (counterpart of scripts/run_active.sh, the reference's run_active.sh): for
# each noise type, train with the two upstream checkpoints (noisy->clean +
# noisy->noise), a pretrained BLSTM warm start, raw-feature input and the
# sync active sampler. Run from the repository's root; arguments after the
# fifth go to run_downstream (e.g. --cpu; the default device is cuda).
#
# Usage: speech_enhancement_by_s3prl_tpu_torch/tools/run_active.sh \
#            NOISE_ROOT CKPT_N2C CKPT_N2N DCKPT [EXPROOT] [run_downstream flags]

set -euo pipefail
noise_root=${1:?noise root dir}
ckpt_n2c=${2:?noisy->clean upstream ckpt}
ckpt_n2n=${3:?noisy->noise upstream ckpt}
dckpt=${4:?downstream warm-start ckpt}
exproot=${5:-result/active}
shift $(( $# < 5 ? $# : 5 ))

for noise_dir in "$noise_root"/*/; do
    noise_name=$(basename "$noise_dir")
    python -m speech_enhancement_by_s3prl_tpu_torch.run_downstream \
        --name "active_${noise_name}" \
        --expdir "$exproot" \
        --config config/active.yaml \
        --ckpt "$ckpt_n2c" --ckpt2 "$ckpt_n2n" \
        --dckpt "$dckpt" \
        --downstream LSTM --objective L1 \
        --from_rawfeature \
        --active_sampling --sync_sampler --eval_init --save_best \
        --test_noise "$noise_dir" "$@"
done
