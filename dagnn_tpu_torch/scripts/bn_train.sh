#!/usr/bin/env bash
# BN (Bayesian networks) VAE training on the port, with the arguments of
# the JAX package's scripts/bn_train.sh: batch 128, 50 epochs,
# bidirectional. Without DATA (asia_200k.txt is not in the repo) the
# driver trains on its synthetic BN corpus. Runs on the card; pass --cpu
# for the CPU.
# Usage: bn_train.sh [MODEL] [extra args]; HS, NZ, BS, EPOCHS, LR,
# SAVE_INTERVAL, RES, DATA override the defaults.
set -e
cd "$(dirname "$0")/../.."
MODEL=${1:-DAGNN_BN}
[ $# -gt 0 ] && shift
ARGS=(--data-name asia_200k --data-type BN --model "$MODEL" --nvt 8
      --hs "${HS:-501}" --nz "${NZ:-56}" --batch-size "${BS:-128}"
      --epochs "${EPOCHS:-50}" --lr "${LR:-1e-4}" --bidirectional
      --save-interval "${SAVE_INTERVAL:-10}" --res_dir "${RES:-results/torch_bn}"
      --load-latest-model)
[ -n "$DATA" ] && ARGS+=(--data-path "$DATA")
exec python -m dagnn_tpu_torch.cli.train_vae "${ARGS[@]}" "$@"
