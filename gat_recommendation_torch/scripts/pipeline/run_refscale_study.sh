#!/usr/bin/env bash
# Reference-scale model-ordering study on the structured corpus, through the
# PyTorch port's entry points (the port of scripts/pipeline/run_refscale_study.sh).
#
# A RetailRocket-scale corpus (466,865-id catalog) whose sessions are random
# walks on a latent clustered Markov item graph (scripts.data.generate_synthetic_data
# --structured) goes through the data stages; then all four models train
# with the reference's policy (dual loss a = 0.7, AdamW 1e-3 / 1e-5, batch
# 128, an evaluation every epoch, early stop on recall@10 with patience 10)
# on the card, with per-session hit vectors for the paired intervals of
# scripts.pipeline.summarize_refscale.
#
# Outputs: $OUT/<model>/history.json and checkpoints, evaluation_results.json
# (test split), quality_gate_results.json (the flagship), the bf16-moments
# run, and the serving latency on the CPU. The data stages run on the host
# only; the trainers, the evaluation and the gate on the card.
set -euo pipefail
cd "$(dirname "$0")/../../.."
# The package runs from the source tree, not installed.
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"

DATA_DIR=${DATA_DIR:-data_refscale}
OUT=${OUT:-outputs/refscale_v3_torch}
SESSIONS=${SESSIONS:-175000}
EPOCHS=${EPOCHS:-60}
MODELS=${MODELS:-"graph_transformer_optimized gat graphsage graph_transformer"}
# Corpus v3: successors 4 (cross-cluster 1) and Dirichlet a = 0.1.
CORPUS_ARGS=${CORPUS_ARGS:-"--successors-per-item 4 --cross-cluster-successors 1 --dirichlet-alpha 0.1"}

stamp() { date +%H:%M:%S; }

if [ ! -f "$DATA_DIR/processed/split_info.json" ]; then
  echo "[$(stamp)] generating structured corpus ($SESSIONS sessions)"
  python3 -m gat_recommendation_torch.scripts.data.generate_synthetic_data --structured \
    --num-sessions "$SESSIONS" --num-items 466865 $CORPUS_ARGS \
    --output-file "$DATA_DIR/raw/events.csv"
  python3 -m gat_recommendation_torch.scripts.data.sessionize \
    --input-file "$DATA_DIR/raw/events.csv" \
    --output-file "$DATA_DIR/interim/sessions.csv" \
    --stats-file "$DATA_DIR/interim/session_stats.json"
  python3 -m gat_recommendation_torch.scripts.data.temporal_split \
    --input-file "$DATA_DIR/interim/sessions.csv" \
    --output-dir "$DATA_DIR/processed"
  python3 -m gat_recommendation_torch.scripts.data.build_graph \
    --input-file "$DATA_DIR/processed/train.csv" \
    --output-file "$DATA_DIR/processed/graph_edges.csv" \
    --stats-file "$DATA_DIR/processed/graph_stats.json"
fi

for model in $MODELS; do
  if [ -f "$OUT/$model/history.json" ]; then
    echo "[$(stamp)] $model already trained, skipping"
    continue
  fi
  echo "[$(stamp)] training $model"
  python3 -m gat_recommendation_torch.scripts.train.train_baseline --model "$model" \
    --train-sessions "$DATA_DIR/processed/train.csv" \
    --val-sessions "$DATA_DIR/processed/val.csv" \
    --graph-edges "$DATA_DIR/processed/graph_edges.csv" \
    --max-epochs "$EPOCHS" --checkpoint-every 10 --record-hits \
    --output-dir "$OUT"
done

# bf16 optimizer-moments study: the flagship's config and seed.
if [ ! -f "$OUT/bf16_study/graph_transformer_optimized/history.json" ]; then
  echo "[$(stamp)] bf16-moments study (flagship config)"
  python3 -m gat_recommendation_torch.scripts.train.train_baseline --model graph_transformer_optimized \
    --train-sessions "$DATA_DIR/processed/train.csv" \
    --val-sessions "$DATA_DIR/processed/val.csv" \
    --graph-edges "$DATA_DIR/processed/graph_edges.csv" \
    --max-epochs "$EPOCHS" --checkpoint-every 10 --bf16-moments \
    --output-dir "$OUT/bf16_study"
fi

echo "[$(stamp)] evaluating all checkpoints on the test split"
python3 -m gat_recommendation_torch.scripts.evaluate_local \
  --test-sessions "$DATA_DIR/processed/test.csv" \
  --graph-edges "$DATA_DIR/processed/graph_edges.csv" \
  --outputs-dir "$OUT" \
  --results-file "$OUT/evaluation_results.json"

echo "[$(stamp)] quality gate on the flagship"
python3 -m gat_recommendation_torch.scripts.pipeline.model_quality_gate \
  --checkpoint "$OUT/graph_transformer_optimized/checkpoint_best" \
  --test-sessions "$DATA_DIR/processed/test.csv" \
  --graph-edges "$DATA_DIR/processed/graph_edges.csv" \
  --results-file "$OUT/quality_gate_results.json"

echo "[$(stamp)] serving latency on the CPU (the deployment target the reference measured on)"
python3 -m gat_recommendation_torch.serving.latency_bench --device cpu \
  --checkpoint "$OUT/graph_transformer_optimized/checkpoint_best" \
  --graph-edges "$DATA_DIR/processed/graph_edges.npz" \
  --results-file "$OUT/serving_latency_cpu.json"

echo "[$(stamp)] DONE"
