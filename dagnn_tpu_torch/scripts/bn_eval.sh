#!/usr/bin/env bash
# BN latent scoring + BIC-scored BO + summary on the port, with the
# arguments of the JAX package's scripts/bn_eval.sh (vae/bn_score.py
# scores natively).
# Usage: bn_eval.sh LATENT_MAT [extra args]; set CKPT=/path to enable BO;
# SEEDS, ROUNDS, RES override the defaults. Runs on the card; pass --cpu
# for the CPU.
set -e
cd "$(dirname "$0")/../.."
LATENT=${1:?latent .mat required (e.g. results/torch_bn/asia_200k_latent_epoch50.mat)}
shift
CKPT=${CKPT:-}
ARGS=(--latent "$LATENT" --data-type BN --bidirectional
      --seeds "${SEEDS:-10}" --res_dir "${RES:-results/torch_bo_bn}")
[ -n "$CKPT" ] && ARGS+=(--checkpoint "$CKPT" --bo --BO_rounds "${ROUNDS:-10}")
python -m dagnn_tpu_torch.cli.run_bo "${ARGS[@]}" "$@"
exec python -m dagnn_tpu_torch.cli.summarize --res_dir "${RES:-results/torch_bo_bn}"
