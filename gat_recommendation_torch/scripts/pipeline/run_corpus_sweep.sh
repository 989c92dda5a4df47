#!/usr/bin/env bash
# Corpus ceiling sweep through the PyTorch port (the port of
# scripts/pipeline/run_corpus_sweep.sh): structured-generator settings whose
# learnable ceiling clears the quality gate's floors (recall@10 >= 0.30)
# while the model families still separate (the flagship >= 1.5x the others,
# popularity weak). Probe scale: 8,000 sessions over 2,000 active items; each
# setting trains the optimized Graph Transformer, GAT and GraphSAGE at width
# 64 on the card (scripts.pipeline.corpus_discrimination).
set -uo pipefail
cd "$(dirname "$0")/../../.."
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"
mkdir -p outputs/logs

COMMON="--num-sessions 8000 --num-items 8000 --num-active 2000 --num-clusters 20
        --max-epochs 16 --patience 16 --embedding-dim 64
        --models graph_transformer_optimized gat graphsage"

run() {  # run <name> <extra args...>
  local name=$1; shift
  if [ -f "outputs/sweep_torch_$name/results.json" ]; then
    echo "== $name already done"; return
  fi
  echo "== $name : $*"
  timeout 1800 python3 -m gat_recommendation_torch.scripts.pipeline.corpus_discrimination $COMMON \
    --output-dir "outputs/sweep_torch_$name" "$@" \
    > "outputs/logs/sweep_torch_$name.log" 2>&1 || echo "!! $name failed rc=$?"
  python3 - "$name" <<'PY'
import json, sys
try:
    r = json.load(open(f"outputs/sweep_torch_{sys.argv[1]}/results.json"))
    print("  pop@10:", round(r["baselines"]["popularity_recall@10"], 4))
    for m, v in r["models"].items():
        print(f"  {m}: {v['best_recall@10']:.4f} {v['ci95']} ep{v['best_epoch']}")
except Exception as e:
    print("  no results:", e)
PY
}

run ctrl
run s4        --successors-per-item 4 --cross-cluster-successors 1
run s4a02     --successors-per-item 4 --cross-cluster-successors 1 --dirichlet-alpha 0.2
run s8a015    --dirichlet-alpha 0.15
run s4a02l12  --successors-per-item 4 --cross-cluster-successors 1 --dirichlet-alpha 0.2 \
              --mean-session-length 12 --noise-prob 0.10
echo "SWEEP DONE"

# Second round: does more distractor noise widen the flagship's lead (attention
# filters distractors) without taking the ceiling below the gate's floors?
run s4a02n25  --successors-per-item 4 --cross-cluster-successors 1 --dirichlet-alpha 0.2 \
              --noise-prob 0.25
run s4a02n35  --successors-per-item 4 --cross-cluster-successors 1 --dirichlet-alpha 0.2 \
              --noise-prob 0.35
echo "SWEEP2 DONE"
