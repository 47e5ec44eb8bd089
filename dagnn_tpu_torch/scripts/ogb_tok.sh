#!/usr/bin/env bash
# ogbg-code2 TOK experiment on the port, with the arguments of the JAX
# package's scripts/ogb_tok.sh. Runs on the card; pass --cpu for the CPU.
# Usage: DATA_ROOT=/path TRAIN_IDX=/path/train15.csv.gz ogb_tok.sh [extra args]
#   DATA_ROOT: ogbg-code2 root (raw/ + split/project/); omit for synthetic.
set -e
cd "$(dirname "$0")/../.."
DATA_ROOT=${DATA_ROOT:-}
TRAIN_IDX=${TRAIN_IDX:-}
# reference hyperparameters (the JAX package's scripts/ogb_tok.sh)
BS=${BS:-160}; LR=${LR:-1e-3}; CLIP=${CLIP:-0.25}; FOLDS=${FOLDS:-5}
PATIENCE=${PATIENCE:-10}; EMB=${EMB:-300}; LAYERS=${LAYERS:-2}
AGG=${AGG:-attn_h}; BIDIR=${BIDIR:-1}; POOL=${POOL:-max}; EPOCHS=${EPOCHS:-30}
ARGS=(--batch_size "$BS" --lr "$LR" --clip "$CLIP" --folds "$FOLDS"
      --patience "$PATIENCE" --emb_dim "$EMB" --dagnn_layers "$LAYERS"
      --dagnn_agg "$AGG" --dagnn_bidir "$BIDIR" --dagnn_out_pool "$POOL"
      --epochs "$EPOCHS")
[ -n "$DATA_ROOT" ] && ARGS+=(--data_root "$DATA_ROOT") || ARGS+=(--synthetic 2000)
[ -n "$TRAIN_IDX" ] && ARGS+=(--train_idx "$TRAIN_IDX")
exec python -m dagnn_tpu_torch.cli.main_tok "${ARGS[@]}" "$@"
