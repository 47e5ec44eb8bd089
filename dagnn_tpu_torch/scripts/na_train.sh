#!/usr/bin/env bash
# NA (neural architectures) VAE training on the port, with the arguments of
# the JAX package's scripts/na_train.sh: batch 32, 100 epochs, hs=501,
# nz=56, unidirectional attn_h. Runs on the card; pass --cpu for the CPU.
# Usage: na_train.sh [MODEL] [extra args]; HS, NZ, BS, EPOCHS, LR,
# SAVE_INTERVAL, RES, DATA override the defaults. A rerun with a larger
# EPOCHS resumes from the latest checkpoint in RES.
set -e
cd "$(dirname "$0")/../.."
MODEL=${1:-DAGNN}
[ $# -gt 0 ] && shift
DATA=${DATA:-"$PWD/data/final_structures6.txt.gz"}
exec python -m dagnn_tpu_torch.cli.train_vae \
  --data-name final_structures6 --data-path "$DATA" --data-type ENAS \
  --model "$MODEL" --nvt 6 --hs "${HS:-501}" --nz "${NZ:-56}" \
  --batch-size "${BS:-32}" --epochs "${EPOCHS:-100}" --lr "${LR:-1e-4}" \
  --save-interval "${SAVE_INTERVAL:-10}" --res_dir "${RES:-results/torch_na}" \
  --load-latest-model "$@"
