#!/usr/bin/env bash
# NA latent scoring + BO + summary on the port, with the arguments of the
# JAX package's scripts/na_eval.sh.
# Usage: na_eval.sh LATENT_MAT [extra args]; set CKPT=/path (a checkpoint
# of the port's train_vae) to enable BO; SEEDS, ROUNDS, RES override the
# defaults. Runs on the card; pass --cpu for the CPU.
set -e
cd "$(dirname "$0")/../.."
LATENT=${1:?latent .mat required}
shift
CKPT=${CKPT:-}
ARGS=(--latent "$LATENT" --data-type ENAS --seeds "${SEEDS:-10}"
      --res_dir "${RES:-results/torch_bo}")
[ -n "$CKPT" ] && ARGS+=(--checkpoint "$CKPT" --bo --BO_rounds "${ROUNDS:-10}")
python -m dagnn_tpu_torch.cli.run_bo "${ARGS[@]}" "$@"
exec python -m dagnn_tpu_torch.cli.summarize --res_dir "${RES:-results/torch_bo}"
