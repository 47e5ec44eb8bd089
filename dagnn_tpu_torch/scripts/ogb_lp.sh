#!/usr/bin/env bash
# ogbg-code2 LP experiment on the port, with the arguments of the JAX
# package's scripts/ogb_lp.sh. Runs on the card; pass --cpu for the CPU.
# Usage: DATA_ROOT=/path ogb_lp.sh [extra args]; omit DATA_ROOT for
# synthetic ASTs; BS, LR, CLIP, FOLDS, EMB, EPOCHS override the defaults.
set -e
cd "$(dirname "$0")/../.."
DATA_ROOT=${DATA_ROOT:-}
BS=${BS:-160}; LR=${LR:-1e-3}; CLIP=${CLIP:-0.25}; FOLDS=${FOLDS:-5}
EMB=${EMB:-300}; EPOCHS=${EPOCHS:-30}
ARGS=(--batch_size "$BS" --lr "$LR" --clip "$CLIP" --folds "$FOLDS"
      --emb_dim "$EMB" --epochs "$EPOCHS")
[ -n "$DATA_ROOT" ] && ARGS+=(--data_root "$DATA_ROOT") || ARGS+=(--synthetic 2000)
exec python -m dagnn_tpu_torch.cli.main_lp "${ARGS[@]}" "$@"
