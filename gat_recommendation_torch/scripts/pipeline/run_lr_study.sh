#!/usr/bin/env bash
# Symmetric learning-rate study on corpus v3 through the PyTorch port's
# trainer (the port of scripts/pipeline/run_lr_study.sh): GraphSAGE, the
# optimized Graph Transformer and the Graph Transformer with the FFN at lr
# 3e-4 with the same budget, so that a per-model ordering claim rests on
# like-for-like runs. Trains on the card.
set -euo pipefail
cd "$(dirname "$0")/../../.."
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"

DATA_DIR=${DATA_DIR:-data_refscale}
OUT=${OUT:-outputs/refscale_v3_torch_gatdiag/lr3e-4}
EPOCHS=${EPOCHS:-60}
MODELS=${MODELS:-"graphsage graph_transformer_optimized graph_transformer"}

for model in $MODELS; do
  if [ -f "$OUT/$model/history.json" ]; then
    echo "[$(date +%H:%M:%S)] $model already trained, skipping"
    continue
  fi
  echo "[$(date +%H:%M:%S)] training $model @ lr 3e-4"
  python3 -m gat_recommendation_torch.scripts.train.train_baseline --model "$model" \
    --train-sessions "$DATA_DIR/processed/train.csv" \
    --val-sessions "$DATA_DIR/processed/val.csv" \
    --graph-edges "$DATA_DIR/processed/graph_edges.csv" \
    --lr 3e-4 --max-epochs "$EPOCHS" --checkpoint-every 10 --record-hits \
    --output-dir "$OUT"
done
echo "[$(date +%H:%M:%S)] LR STUDY DONE"
